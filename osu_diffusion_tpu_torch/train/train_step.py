"""One training step: featurize, loss, backward, AdamW, EMA (port of
osu_diffusion_tpu/parallel/train_step.py).

The step's random draws (flip bits, time offsets, timesteps, noise, the
label-drop mask) come from an explicit `torch.Generator`, or are handed in
whole as `draws` so a test can feed in the JAX step's draws. The residual
stream runs in `dtype` (bf16 in training) over f32 master weights; the
optimizer state and the EMA are f32.

Over a parallel/mesh.py `Mesh` of more than one rank, each rank takes its
DP shard of the batch; the ranks of one row (the "model" axis) take the
same batch and the same draws (one generator seed).
- Data parallelism alone, or context parallelism (`context_parallel`, the
  "model" axis > 1): every rank holds a full replica. Under CP each rank
  featurizes the whole window and keeps its rows of x, o, c and the noise;
  every shard has T_loc rows, so a sample's loss is the mean over the CP
  ranks of the local per-token means. Each rank backpropagates its local
  mean loss / world, and one sum `all_reduce` of all gradients (one flat
  buffer) over the world gives every rank the global mean gradient.
- CP over a sharded model (parallel/sharding.py `shard_model` on the same
  mesh): the model gathers its sharded weights before use, so a sharded
  parameter's gradient leaves the backward already summed over the row;
  those are summed over the column, the replicated ones over the world as
  under CP alone.
- Tensor parallelism (the "model" axis > 1 without CP; the model sharded
  by parallel/sharding.py): every rank of a row computes the same loss,
  and the gradient each holds is already whole (a sharded parameter's for
  its shard, a replicated one's the same bits on every rank of the row).
  Each rank backpropagates its loss / the data degree, and one sum over
  the column (the data ranks of its model rank) gives the global mean.
The metrics are reduced the same way. Every rank then takes the same AdamW
step on what it holds.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch
import torch.distributed as dist

from osu_diffusion_tpu_torch.data.process import draw_flips, process_batch
from osu_diffusion_tpu_torch.diffusion.process import GaussianDiffusion
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.parallel.context import shard_rows


class StepDraws(NamedTuple):
    flip_x: torch.Tensor    # (N,) bool
    flip_y: torch.Tensor    # (N,) bool
    offset01: torch.Tensor  # (N, 1) uniform in [0, 1): the window's time offset
    t: torch.Tensor         # (N,) int64 local timesteps
    noise: torch.Tensor     # (N, T, 2) f32
    drop: torch.Tensor      # (N,) bool label-drop mask


def make_optimizer(params, lr: float = 1e-4) -> torch.optim.AdamW:
    """AdamW with the reference's settings: lr 1e-4, betas (0.9, 0.999),
    eps 1e-8 and weight decay 0 (torch's default decay is 0.01)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def make_ema(model: DiT) -> DiT:
    """The EMA model starts as a copy of the weights."""
    return copy.deepcopy(model).requires_grad_(False)


@torch.no_grad()
def update_ema(ema: DiT, model: DiT, decay: float = 0.9999) -> None:
    """ema = ema * decay + params * (1 - decay), over every parameter."""
    ema_params = list(ema.parameters())
    params = list(model.parameters())
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)


def draw_step(n: int, t_len: int, num_timesteps: int, dropout_prob: float, device,
              generator: torch.Generator | None = None) -> StepDraws:
    """A step's draws, in a fixed order from one generator; t is uniform in
    [0, num_timesteps)."""
    flip_x, flip_y = draw_flips((n,), generator, device)
    offset01 = torch.rand((n, 1), generator=generator, device=device)
    t = torch.randint(0, num_timesteps, (n,), generator=generator, device=device)
    noise = torch.randn((n, t_len, 2), generator=generator, device=device)
    drop = torch.rand((n,), generator=generator, device=device) < dropout_prob
    return StepDraws(flip_x, flip_y, offset01, t, noise, drop)


def loss_terms(model: DiT, diffusion: GaussianDiffusion, batch, draws: StepDraws,
               band: int | None, dtype: torch.dtype, cp=None) -> dict[str, torch.Tensor]:
    """Per-sample training_losses terms of one batch (raw (N, T, 19),
    prev_xy (N, 2), labels (N,)) under the given draws, with grad: {loss,
    l1|mse, vb} by default, {loss} under the KL losses, no vb under a fixed
    variance. With `cp` (a
    mesh whose "model" axis splits the sequence) the window is featurized
    whole and the terms are the means over this rank's rows."""
    raw, prev_xy, y = batch
    x, o, c = process_batch(raw, prev_xy, flips=(draws.flip_x, draws.flip_y),
                            offset01=draws.offset01)
    noise = draws.noise
    if cp is not None:
        rows = shard_rows(x.shape[1], cp)
        x, o, c, noise = x[:, rows], o[:, rows], c[:, rows], noise[:, rows]

    def model_fn(xt, tt):
        return model(xt, tt, o, c, y, band=band, train=True, drop=draws.drop, dtype=dtype,
                     cp=cp).float()

    return diffusion.training_losses(model_fn, x, draws.t, noise)


def all_reduce_grads(params: list[torch.nn.Parameter], group=None) -> None:
    """Sum every parameter's gradient over `group` (None: the world),
    through one flat buffer (a missing gradient counts as zeros, so every
    rank sends the same layout)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()


def train_step(
    model: DiT,
    ema: DiT,
    optimizer: torch.optim.Optimizer,
    diffusion: GaussianDiffusion,
    batch,
    *,
    band: int | None,
    dtype: torch.dtype = torch.bfloat16,
    generator: torch.Generator | None = None,
    draws: StepDraws | None = None,
    max_timestep: int | None = None,
    ema_decay: float = 0.9999,
    trainable_mask: dict[str, bool] | None = None,
    mesh=None,
    context_parallel: bool = False,
) -> dict[str, torch.Tensor]:
    """One optimizer step on `batch`; returns the step's mean of each of
    `loss_terms`' terms as device scalars (no host sync). `max_timestep` caps the timestep
    draw (1 trains t = 0 only, the refine model). `trainable_mask`: parameter
    name -> trainable, as the JAX step's mask: a frozen parameter gets a zero
    gradient (so AdamW's moments and step count advance as optax's do) and
    keeps its value bit for bit; the EMA still covers every parameter.
    `mesh`: a parallel/mesh.py `Mesh`; `batch` and `draws` are then this
    rank's DP shard (whole windows), and the metrics the global means. With
    `context_parallel` a "model" axis > 1 splits the sequence, over a whole
    or a sharded model; without it, the model must be sharded over it
    (tensor parallelism)."""
    raw = batch[0]
    if draws is None:
        t_hi = diffusion.num_timesteps if max_timestep is None else max_timestep
        draws = draw_step(raw.shape[0], raw.shape[1], t_hi, model.y_embedder.dropout_prob,
                          raw.device, generator)
    world = 1 if mesh is None else mesh.world
    tp = mesh is not None and mesh.num_model > 1 and not context_parallel
    if tp and model.tp is None:
        raise ValueError("a mesh with model ranks and no context parallelism needs the model "
                         "sharded over them (parallel/sharding.py shard_model)")
    cp = mesh if context_parallel and mesh is not None and mesh.num_model > 1 else None
    # the ranks whose losses make up the mean, and the group that sums the gradients
    ranks, group = (mesh.num_data, mesh.col_group) if tp else (world, None)
    terms = loss_terms(model, diffusion, batch, draws, band, dtype, cp)
    loss = terms["loss"].mean()
    optimizer.zero_grad(set_to_none=True)
    (loss / ranks).backward()
    if cp is not None and model.tp is not None:
        # a sharded parameter's gradient is the row's sum already (sharding.gather_shards)
        split = [p for name, p in model.named_parameters() if model.tp_dims[name] is not None]
        all_reduce_grads([p for name, p in model.named_parameters() if model.tp_dims[name] is None])
        if mesh.num_data > 1:
            all_reduce_grads(split, mesh.col_group)
    elif ranks > 1:
        all_reduce_grads(list(model.parameters()), group)
    frozen = [] if trainable_mask is None else [
        p for name, p in model.named_parameters() if not trainable_mask[name]]
    if frozen:
        for p in frozen:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in frozen])
        # AdamW moves a weight with a zero gradient by its first moment:
        # restore the values, as the JAX step keeps the old params
        kept = [p.detach().clone() for p in frozen]
    optimizer.step()
    if frozen:
        with torch.no_grad():
            for p, k in zip(frozen, kept):
                p.copy_(k)
    update_ema(ema, model, ema_decay)
    metrics = {k: v.detach().mean() for k, v in terms.items()}
    if ranks > 1:
        reduced = torch.stack(list(metrics.values()))
        dist.all_reduce(reduced, group=group)
        metrics = dict(zip(metrics, reduced / ranks))
    return metrics
