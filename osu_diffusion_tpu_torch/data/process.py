"""Sequence splitting, distance features, flip augmentation and the
training-batch featurizer (port of osu_diffusion_tpu/data/process.py).
Functions take tensors on any device and are shape-polymorphic over leading
batch axes.

Random draws (the per-window flip bits, the per-window time offset) come
from an explicit `torch.Generator` or are handed in as tensors, so a test can
feed in another framework's draws. As in the JAX package, the flip is drawn
per window and `prev_xy` carries the predecessor of a window's first point.
"""
from __future__ import annotations

import torch

from osu_diffusion_tpu_torch import PLAYFIELD
from osu_diffusion_tpu_torch.ops.embeddings import timestep_embedding

CENTER = (256.0, 192.0)
DIST_EMBED_DIM = 128
MAX_TIME_OFFSET = 100000.0  # ms; time offsets are uniform in [0, this)


def _constants(like: torch.Tensor, values) -> torch.Tensor:
    """`values` as a 1-D tensor of `like`'s type on its device, filled there
    (no copy from the host, so that a CUDA graph can capture it)."""
    return torch.stack([like.new_full((), v) for v in values])


def calc_distances(seq: torch.Tensor, prev_xy: torch.Tensor | None = None) -> torch.Tensor:
    """Euclidean distance of each datapoint to its predecessor.

    seq: (..., T, 19); prev_xy: (..., 2) predecessor of element 0 (defaults
    to the playfield center). Returns (..., T)."""
    xy = seq[..., :2]
    if prev_xy is None:
        prev_first = _constants(xy, CENTER).expand(xy[..., :1, :].shape)
    else:
        prev_first = prev_xy[..., None, :]
    diff = xy - torch.cat([prev_first, xy[..., :-1, :]], dim=-2)
    # sqrt(sum of squares), the formula jnp.linalg.norm uses
    return torch.sqrt((diff * diff).sum(dim=-1))


def _split(seq: torch.Tensor, xy: torch.Tensor, prev_xy: torch.Tensor | None):
    seq_d = calc_distances(seq, prev_xy)
    seq_x = xy / _constants(xy, PLAYFIELD)
    seq_o = seq[..., 2]
    seq_c = torch.cat([timestep_embedding(seq_d, DIST_EMBED_DIM), seq[..., 3:]], dim=-1)
    return seq_x, seq_o, seq_c


def split_and_process_sequence_no_augment(
    seq: torch.Tensor, prev_xy: torch.Tensor | None = None
):
    """(T, 19) raw sequence -> ((seq_x, seq_o, seq_c), T): coordinates
    normalized to the playfield, time in ms, and the (T, 144) context."""
    return _split(seq, seq[..., :2], prev_xy), seq.shape[-2]


def draw_flips(shape, generator: torch.Generator | None = None, device=None):
    """Per-window (flip_x, flip_y) bools, each Bernoulli(0.5)."""
    u = torch.rand((2, *shape), generator=generator, device=device)
    return u[0] < 0.5, u[1] < 0.5


def split_and_process_sequence(
    seq: torch.Tensor,
    prev_xy: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    flips: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Split with random flip augmentation: ((seq_x, seq_o, seq_c), T).

    `flips`: (flip_x, flip_y) bools of shape seq.shape[:-2]; drawn from
    `generator` when not given. Distances come from the unflipped positions
    (a flip preserves them)."""
    if flips is None:
        flips = draw_flips(seq.shape[:-2], generator, seq.device)
    flip_x, flip_y = flips
    xy = seq[..., :2]
    x = torch.where(flip_x[..., None], 512.0 - xy[..., 0], xy[..., 0])
    y = torch.where(flip_y[..., None], 384.0 - xy[..., 1], xy[..., 1])
    return _split(seq, torch.stack([x, y], dim=-1), prev_xy), seq.shape[-2]


def window_and_relative_time(seq_tuple, s: int, e: int, rand01: float):
    """The rows [s, e) of (seq_x, seq_o, seq_c), time re-zeroed at row s
    plus rand01 * MAX_TIME_OFFSET ms."""
    seq_x, seq_o, seq_c = seq_tuple
    o = seq_o[..., s:e] - seq_o[..., s, None] + rand01 * MAX_TIME_OFFSET
    return seq_x[..., s:e, :], o, seq_c[..., s:e, :]


def process_batch(
    raw: torch.Tensor,
    prev_xy: torch.Tensor,
    generator: torch.Generator | None = None,
    augment: bool = True,
    flips: tuple[torch.Tensor, torch.Tensor] | None = None,
    offset01: torch.Tensor | None = None,
):
    """Featurize a batch of raw windows for the train step.

    raw: (N, T, 19) windows (absolute positions and times); prev_xy: (N, 2).
    Returns (x (N, T, 2) normalized coords, o (N, T) time relative to the
    window's first point plus a uniform offset in [0, MAX_TIME_OFFSET),
    c (N, T, 144) context). `flips` and `offset01` ((N, 1) uniforms in
    [0, 1)) replace the generator's draws when given."""
    n = raw.shape[0]
    if augment:
        (x, o, c), _ = split_and_process_sequence(raw, prev_xy, generator, flips)
    else:
        (x, o, c), _ = split_and_process_sequence_no_augment(raw, prev_xy)
    if offset01 is None:
        offset01 = torch.rand((n, 1), generator=generator, device=raw.device)
    return x, o - o[..., :1] + offset01 * MAX_TIME_OFFSET, c
