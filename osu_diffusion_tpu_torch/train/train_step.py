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

`train_steps` is JAX's `make_multi_train_step`: k steps on k stacked
batches, returning each metric's mean over them. `TrainCall` runs it as
one CUDA graph of the k steps on a card in one process (the trainer's
`steps_per_call`); under a process group and on the CPU it runs the k
steps eagerly.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch
import torch.distributed as dist

from osu_diffusion_tpu_torch import graphs
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
    eps 1e-8 and weight decay 0 (torch's default decay is 0.01). Over
    parameters on a card it is capturable (its step counts live on the
    card, its bias corrections are computed there), as a CUDA graph of the
    step (`TrainCall`) needs; a checkpoint carries the flag, and
    checkpoint.load_optimizer_state keeps the live one."""
    params = list(params)
    optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                                  capturable=any(p.is_cuda for p in params))
    # eager steps of a capturable AdamW are the trainer's default (one step
    # a call): torch's one-time advice to drop the flag would print on
    # every run on a card
    optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer


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


def train_steps(model: DiT, ema: DiT, optimizer: torch.optim.Optimizer,
                diffusion: GaussianDiffusion, batches, *, draws=None,
                **step_kwargs) -> dict[str, torch.Tensor]:
    """k optimizer steps (JAX `make_multi_train_step`): `batches` are
    stacked (k, N, T, 19) windows, (k, N, 2) predecessors and (k, N)
    int64 labels, `draws` None or k `StepDraws`, `step_kwargs`
    `train_step`'s. Returns each metric's mean over the k steps as a
    device scalar."""
    raw, prev_xy, y = batches
    steps = [train_step(model, ema, optimizer, diffusion, (raw[i], prev_xy[i], y[i]),
                        draws=None if draws is None else draws[i], **step_kwargs)
             for i in range(raw.shape[0])]
    return {name: torch.stack([m[name] for m in steps]).mean() for name in steps[0]}


class TrainCall:
    """`train_steps` with one trainable mask (JAX jits one `multi_fn` a
    mask): with `graphed`, the k steps as one CUDA graph, else eagerly (on
    the CPU, and under a process group: gloo's collectives cannot be
    captured, NCCL's are untried). `step_kwargs` are `train_step`'s, the
    draws from `generator`.

    Graphed, the first call runs its k steps eagerly on a side stream, and
    they are real steps (a train step cannot be run for warm-up and thrown
    away: it moves the weights, the EMA, the moments and the generator);
    then it captures them, `generator` registered with the graph, and every
    later call copies its batches into static device buffers on the current
    stream and replays. The graph writes each metric's k-step mean into
    static 0-d outputs, which a call returns copies of. What the steps
    allocate under capture (the gradients after `zero_grad(set_to_none=True)`,
    the activations, the frozen parameters' saved values) comes from the
    graph's private pool; a replay adds k steps' launches to the kernel
    wrappers' counters. A capture error raises: nothing falls back to eager.

    Invariant: after the capture nothing may replace a parameter, an AdamW
    state tensor or an EMA tensor (the graph holds their addresses; in-place
    updates, such as eager `train_step`s between calls, are fine); a resume
    or `load_state_dict` comes before the first call."""

    def __init__(self, model: DiT, ema: DiT, optimizer: torch.optim.Optimizer,
                 diffusion: GaussianDiffusion, *, generator: torch.Generator | None,
                 graphed: bool, **step_kwargs):
        self.model, self.ema, self.optimizer, self.diffusion = model, ema, optimizer, diffusion
        self.generator, self.graphed, self.step_kwargs = generator, graphed, step_kwargs
        self.inputs = None  # the static (k, N, T, 19), (k, N, 2), (k, N) buffers
        self.outputs = None  # the static 0-d metrics
        self.graph = None  # graphs.GraphedStep, after the first call

    def _steps(self, batches) -> dict[str, torch.Tensor]:
        return train_steps(self.model, self.ema, self.optimizer, self.diffusion, batches,
                           generator=self.generator, **self.step_kwargs)

    def _program(self) -> None:
        metrics = self._steps(self.inputs)
        if self.outputs is None:
            self.outputs = {name: torch.empty_like(v) for name, v in metrics.items()}
        for name, v in metrics.items():
            self.outputs[name].copy_(v)

    def __call__(self, batches) -> dict[str, torch.Tensor]:
        """k optimizer steps on `batches` (stacked as `train_steps` takes
        them, on any device); returns each metric's mean over the k steps
        (device scalars)."""
        device = next(self.model.parameters()).device
        if not self.graphed:
            return self._steps(tuple(a.to(device, non_blocking=True) for a in batches))
        if self.inputs is None:
            self.inputs = tuple(torch.empty(a.shape, dtype=a.dtype, device=device) for a in batches)
        for dst, src in zip(self.inputs, batches):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"a call of {tuple(dst.shape)} {dst.dtype} got {tuple(src.shape)} "
                                 f"{src.dtype}: the graph's inputs are static")
            # a pageable source is staged by the copy before it returns
            dst.copy_(src, non_blocking=True)
        if self.graph is None:
            graphs.warm_up(self._program, device)
            self.graph = graphs.GraphedStep(device, self._program, generators=(
                () if self.generator is None else (self.generator,)))
        else:
            self.graph.replay()
        return {name: v.clone() for name, v in self.outputs.items()}
