"""Classifier-free-guidance ancestral sampler (port of the sampling core of
osu_diffusion_tpu/sampling.py, with context parallelism; no Δ-cache or
in-painting yet).

Length bucketing: sequences are padded to a multiple of `bucket` (default
128), and the real length rides along as a runtime `valid_len`, which masks
padded keys in every attention call; padded rows are sliced off the result.
On the card the kernels take `valid_len` as an argument, so one build serves
every length.

Context parallelism (`cp`, a parallel/mesh.py `Mesh`): the bucket is raised
to a multiple of num_model * 128, each rank of the CP group keeps its rows
of z, o and c and runs the chain on them (attention exchanges halos), the
per-step noise is drawn at the whole padded shape on every rank from the
same generator and sliced, so the chain is the one-device chain, and the
result is gathered from the ranks at the end. Every rank of the group calls
the sampler with the same inputs and generator seed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from osu_diffusion_tpu_torch.diffusion.process import GaussianDiffusion, NoiseFn
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.parallel.context import BLOCK, gather_slots, shard_rows


def _bucketed(t: int, bucket: int) -> int:
    return max(bucket, -(-t // bucket) * bucket)


def _pad_time(a: torch.Tensor, t_pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of (N, T, ...) to t_pad."""
    extra = t_pad - a.shape[1]
    if extra == 0:
        return a
    return F.pad(a, [0, 0] * (a.ndim - 2) + [0, extra])


def _shard_noise(noise_fn: NoiseFn | None, generator, like: torch.Tensor, t_pad: int,
                 rows: slice) -> NoiseFn:
    """Each step's noise drawn at the whole padded shape (by `noise_fn`, else
    from `generator` on like's device) and sliced to this rank's rows, so
    every rank's chain is its rows of the one-device chain."""
    def draw(k: int, shape) -> torch.Tensor:
        whole = (shape[0], t_pad, *shape[2:])
        if noise_fn is not None:
            return noise_fn(k, whole)[:, rows]
        return torch.randn(whole, generator=generator, device=like.device, dtype=like.dtype)[:, rows]

    return draw


class Sampler:
    """Inputs are the CFG-doubled batch [cond | uncond] along axis 0; the
    eps-only guidance happens inside DiT.forward_with_cfg."""

    def __init__(self, model: DiT, diffusion: GaussianDiffusion, cfg_scale: float = 1.0,
                 band: int | None = None, bucket: int = 128, cp=None):
        """`cp`: the mesh of context parallelism (needs a band); the bucket
        is rounded up to a multiple of num_model * 128, so every padded
        length splits evenly over the shards."""
        self.model = model
        self.diffusion = diffusion
        self.cfg_scale = float(cfg_scale)
        self.band = band
        self.cp = cp
        if cp is not None:
            if band is None:
                raise ValueError("context parallelism needs a band")
            step = cp.num_model * BLOCK
            bucket = -(-max(bucket, 1) // step) * step
        self.bucket = bucket

    @torch.no_grad()
    def __call__(self, z, o, c, y, generator: torch.Generator | None = None,
                 noise_fn: NoiseFn | None = None) -> torch.Tensor:
        """z: (N, T, 2) initial noise; o: (N, T); c: (N, T, 144); y: (N,).
        N is even ([cond | uncond]). Per-step noise comes from `generator`
        on z's device, or from `noise_fn(step_index, padded_shape)`.
        Returns (N, T, 2)."""
        t_real = z.shape[1]
        t_pad = _bucketed(t_real, self.bucket)
        zp, op, cpad = (_pad_time(a, t_pad) for a in (z, o, c))
        if self.cp is not None:
            rows = shard_rows(t_pad, self.cp)
            zp, op, cpad = zp[:, rows], op[:, rows], cpad[:, rows]
            noise_fn = _shard_noise(noise_fn, generator, z, t_pad, rows)

        def model_fn(x, t):
            return self.model.forward_with_cfg(
                x, t, op, cpad, y, self.cfg_scale, band=self.band, valid_len=t_real, cp=self.cp
            )

        out = self.diffusion.p_sample_loop(model_fn, zp, generator=generator, noise_fn=noise_fn)
        if self.cp is not None:
            out = torch.cat(gather_slots(out, self.cp).unbind(), dim=1)
        return out[:, :t_real]


def prepare_cfg_inputs(seq_o: torch.Tensor, seq_c: torch.Tensor, class_labels: list[int],
                       num_classes: int, generator: torch.Generator | None = None):
    """CFG-doubled sampling inputs from one processed sequence: n variants
    of fresh noise (drawn on seq_o's device), the context repeated, labels
    [given | null class]. Returns (z, o, c, y)."""
    n = len(class_labels)
    t = seq_o.shape[-1]
    device = seq_o.device
    z = torch.randn((n, t, 2), generator=generator, device=device, dtype=torch.float32)
    o = seq_o.reshape(1, t).expand(n, t)
    c = seq_c.reshape(1, t, -1).expand(n, t, seq_c.shape[-1])
    y = torch.tensor(list(class_labels) + [num_classes] * n, dtype=torch.long, device=device)
    return torch.cat([z, z]), torch.cat([o, o]), torch.cat([c, c]), y
