"""Tensor parallelism (TP) over the mesh's "model" axis (port of
osu_diffusion_tpu/parallel/sharding.py, keyed on the port's state-dict
names).

The JAX package's rules, in torch's Linear layout (weight (out, in), so
JAX's column shard of a kernel (in, out) is a split of dim 0 here):

- `blocks.N.mlp.fc1.{weight,bias}`: split on dim 0 (the hidden units);
  `blocks.N.mlp.fc2.weight`: split on dim 1, its bias replicated. Each
  model rank runs the adaLN-MLP on its 4D/P hidden units and one sum over
  the row finishes fc2 (Megatron's MLP).
- `blocks.N.adaLN_modulation.1.{weight,bias}` and the final layer's: split
  on dim 0, the modulation's columns; each rank computes its slice and the
  row gathers them before the modulation is chunked.
- `y_embedder.embedding_table.weight`: split on dim 0 (vocab-parallel),
  its rows first padded with zeros to a multiple of 16 (the JAX package's
  `LabelEmbedder.table_rows`; the padded rows are never looked up).
- everything else replicated; `fit_spec` replicates an axis that the model
  degree does not divide (the JAX package's `_fit_spec`).

The collectives run over the mesh's row (parallel/mesh.py), each an
`all_reduce`, which gloo takes on CUDA tensors too (two ranks sharing one
card cannot use NCCL): the gather of the heads' columns is a sum of a zero
buffer with one slot per rank (`context.gather_slots`, exact in any type);
the sums of partial outputs and of input gradients run in float32.

Every rank of a row computes the same replicated activations, so the
gradient reaching a replicated tensor is already whole on each rank. Three
autograd Functions keep it so:
- `row_sum` (all_reduce forward, identity backward) after the MLP and the
  label lookup, whose outputs are each rank's partials;
- `row_grad_sum` (identity forward, all_reduce backward) before the MLP
  and each sharded adaLN head, whose input gradients are partials;
- `gather_columns` (slot gather forward; the backward takes this rank's
  columns of the whole gradient).
A replicated parameter then gets the same gradient on every rank of a
row, and a sharded one its shard's whole gradient; the train step sums
both over the column (the data ranks).

Under context parallelism (CP) the same model ranks also split the
sequence: each computes other rows, so every activation gradient it holds
is its own rows' partial, and the three Functions above would leave the
replicas' gradients partial and count the row's shares wrongly. The model
then gathers each sharded weight whole before use (`gather_shards`: one
slot gather forward; backward, one f32 sum of the whole gradients over the
row, then this rank's slices) and runs CP's path on whole weights: a
sharded parameter leaves the backward with its shard's row-summed
gradient, which the train step sums over the column, and a replicated one
with this rank's partial, summed over the world as under CP alone. The
label table keeps its vocab-parallel lookup, whose `row_sum` then also
sums the gradient over the row (`grad_sum=True`): N rows cross the row
instead of the table.
"""
from __future__ import annotations

import math
import re

import torch
import torch.distributed as dist
import torch.nn.functional as F

from osu_diffusion_tpu_torch.parallel.context import gather_slots

LABEL_TABLE = "y_embedder.embedding_table.weight"
TABLE_ROW_MULTIPLE = 16  # the label table's rows are padded to a multiple of this

_SPLIT_RULES = (  # (name pattern, the dim split over "model")
    (re.compile(r"blocks\.\d+\.mlp\.fc1\.(weight|bias)"), 0),
    (re.compile(r"blocks\.\d+\.mlp\.fc2\.weight"), 1),
    (re.compile(r"(blocks\.\d+|final_layer)\.adaLN_modulation\.1\.(weight|bias)"), 0),
    (re.compile(re.escape(LABEL_TABLE)), 0),
)


def table_rows(rows: int) -> int:
    """The label table's rows padded to a multiple of TABLE_ROW_MULTIPLE."""
    return -(-rows // TABLE_ROW_MULTIPLE) * TABLE_ROW_MULTIPLE


def param_partition_spec(name: str, shape) -> tuple[str | None, ...]:
    """The partition spec of one parameter: "model" on the split dim, None
    elsewhere (all None: replicated)."""
    spec: list[str | None] = [None] * len(shape)
    for pattern, dim in _SPLIT_RULES:
        if pattern.fullmatch(name):
            spec[dim] = "model"
            break
    return tuple(spec)


def fit_spec(spec: tuple[str | None, ...], shape, num_model: int) -> tuple[str | None, ...]:
    """`spec` with every split axis that `num_model` does not divide
    replicated."""
    return tuple(None if a is None or dim % num_model else a for a, dim in zip(spec, shape))


def shard_dim(name: str, shape, num_model: int) -> int | None:
    """The dim of `name` split over `num_model` ranks (of the padded table),
    or None where it stays whole."""
    spec = fit_spec(param_partition_spec(name, shape), shape, num_model)
    return spec.index("model") if "model" in spec else None


def _pad_table(table: torch.Tensor) -> torch.Tensor:
    return F.pad(table, (0, 0, 0, table_rows(table.shape[0]) - table.shape[0]))


def shard_tensor(name: str, full: torch.Tensor, mesh) -> tuple[torch.Tensor, int | None]:
    """(this rank's shard of the whole tensor `name`, the dim split or
    None); the label table is padded first, so its shard (or its replica)
    has padded rows."""
    if name == LABEL_TABLE:
        full = _pad_table(full)
    dim = shard_dim(name, full.shape, mesh.num_model)
    if dim is None:
        return full, None
    size = full.shape[dim] // mesh.num_model
    return full.narrow(dim, mesh.model_rank * size, size).clone(), dim


def shard_state_dict(sd: dict[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """A whole state dict (the reference layout) -> this rank's shards."""
    return {name: shard_tensor(name, v, mesh)[0] for name, v in sd.items()}


def _label_rows(model) -> int:
    emb = model.y_embedder
    return emb.num_classes + int(emb.dropout_prob > 0)


def shard_model(model, mesh) -> None:
    """Replace each parameter of a whole DiT by this rank's shard, in place,
    and give the model and its TP-aware modules the mesh (`.tp`). The
    split dims are kept in `model.tp_dims` for `gather_state_dict`. Build
    the optimizer after this."""
    if getattr(model, "quant", False):
        raise NotImplementedError("the int8 serving model has no tensor-parallel path")
    dims = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data, dims[name] = shard_tensor(name, p.data, mesh)
    model.tp_dims = dims
    for module in model.modules():
        if hasattr(module, "tp"):
            module.tp = mesh


def gather_tensor(shard: torch.Tensor, dim: int | None, mesh) -> torch.Tensor:
    """The whole tensor from every rank of the row's shard (split on `dim`;
    None: the replica itself). Every rank of the row calls it."""
    if dim is None:
        return shard
    return torch.cat(list(gather_slots(shard.contiguous(), mesh)), dim=dim)


def gather_state_dict(model, mesh) -> dict[str, torch.Tensor]:
    """A sharded model's whole state dict in the reference layout (the label
    table cut back to num_classes + 1 rows), on every rank of the row, which
    all call it."""
    out = {}
    for name, v in model.state_dict().items():
        whole = gather_tensor(v, model.tp_dims.get(name), mesh)
        out[name] = whole[:_label_rows(model)] if name == LABEL_TABLE else whole
    return out


def _moments(opt_sd: dict, model, fn) -> dict:
    """opt_sd with fn(name, tensor) applied to each parameter's AdamW
    moments (the optimizer holds model.parameters() in order, one group)."""
    names = [name for name, _ in model.named_parameters()]
    state = {i: {k: fn(names[i], v) if k in ("exp_avg", "exp_avg_sq") else v
                 for k, v in s.items()} for i, s in opt_sd["state"].items()}
    return {**opt_sd, "state": state}


def shard_optimizer_state(opt_sd: dict, model, mesh) -> dict:
    """A whole optimizer state dict (a one-process run's) -> this rank's:
    each moment split as its parameter is."""
    return _moments(opt_sd, model, lambda name, v: shard_tensor(name, v, mesh)[0])


def gather_optimizer_state(optimizer, model, mesh) -> dict:
    """The whole optimizer state dict of a sharded model, in a one-process
    run's layout; every rank of the row calls it."""
    def whole(name, v):
        v = gather_tensor(v, model.tp_dims[name], mesh)
        return v[:_label_rows(model)] if name == LABEL_TABLE else v
    return _moments(optimizer.state_dict(), model, whole)


# ---------------------------------------------------------------------------
# the collectives of the forward and backward
# ---------------------------------------------------------------------------


def _sum_over_row(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the row, in float32, returned in x's type (a new
    tensor)."""
    buf = x.to(torch.float32, copy=True)
    dist.all_reduce(buf, group=mesh.row_group)
    return buf.to(x.dtype)


class _RowSum(torch.autograd.Function):
    """Sum of the row's partial outputs; the gradient is already whole
    (TP), or with `grad_sum` (CP) summed over the row too."""

    @staticmethod
    def forward(ctx, x, mesh, grad_sum: bool):
        ctx.mesh, ctx.grad_sum = mesh, grad_sum
        return _sum_over_row(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_sum_over_row(g, ctx.mesh) if ctx.grad_sum else g), None, None


class _RowSumGrad(torch.autograd.Function):
    """The identity; the backward sums the row's partial gradients (all of
    them in one float32 all_reduce)."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.specs = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # a missing gradient counts as zeros, so every rank sends the same layout
        flat = torch.cat([(torch.zeros(shape, dtype=torch.float32, device=device) if g is None
                           else g.to(torch.float32)).reshape(-1)
                          for g, (shape, _, device) in zip(gs, ctx.specs)])
        dist.all_reduce(flat, group=ctx.mesh.row_group)
        out, offset = [], 0
        for shape, dtype, _ in ctx.specs:
            n = shape.numel()
            out.append(flat[offset:offset + n].view(shape).to(dtype))
            offset += n
        return (None, *out)


class _GatherColumns(torch.autograd.Function):
    """(..., C) per rank -> (..., P * C), the row's slices in rank order."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.cols = mesh, x.shape[-1]
        slots = gather_slots(x.contiguous(), mesh)  # (P, ..., C)
        return slots.movedim(0, -2).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_rank * ctx.cols
        return g[..., lo:lo + ctx.cols], None


class _GatherShards(torch.autograd.Function):
    """The whole tensors of the row's shards (`dims`: each one's split
    dim), in one slot gather; the backward sums the whole gradients over
    the row in one f32 all_reduce and returns this rank's slices."""

    @staticmethod
    def forward(ctx, mesh, dims, *shards):
        ctx.mesh, ctx.dims, ctx.device = mesh, dims, shards[0].device
        ctx.specs = [(x.shape, x.dtype) for x in shards]
        slots = gather_slots(torch.cat([x.reshape(-1) for x in shards]), mesh)  # (P, numel)
        out, offset = [], 0
        for x, dim in zip(shards, dims):
            pieces = slots[:, offset:offset + x.numel()].reshape(mesh.num_model, *x.shape)
            out.append(torch.cat(pieces.unbind(), dim=dim))
            offset += x.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        wholes = [[n * mesh.num_model if d == dim else n for d, n in enumerate(shape)]
                  for (shape, _), dim in zip(ctx.specs, ctx.dims)]
        # a missing gradient counts as zeros, so every rank sends the same layout
        flat = torch.cat([torch.zeros(math.prod(w), dtype=torch.float32, device=ctx.device) if g is None
                          else g.to(torch.float32).reshape(-1) for g, w in zip(gs, wholes)])
        dist.all_reduce(flat, group=mesh.row_group)
        out, offset = [], 0
        for (shape, dtype), dim, whole in zip(ctx.specs, ctx.dims, wholes):
            n = math.prod(whole)
            g = flat[offset:offset + n].view(whole).narrow(dim, mesh.model_rank * shape[dim], shape[dim])
            out.append(g.to(dtype).contiguous())
            offset += n
        return (None, None, *out)


def row_sum(x: torch.Tensor, mesh, grad_sum: bool = False) -> torch.Tensor:
    """The sum of x over the row (each rank's x a partial); `grad_sum`:
    its gradient summed over the row as well (under context parallelism)."""
    return _RowSum.apply(x, mesh, grad_sum)


def gather_shards(mesh, tensors, dims) -> list[torch.Tensor]:
    """`tensors` whole: each one split on its entry of `dims` gathered from
    the row's shards (one collective for all of them), each with dim None
    as it is. Differentiable: a shard's gradient is this rank's slice of
    the whole gradient summed over the row. Every rank of the row calls it
    at the same point."""
    split = [i for i, d in enumerate(dims) if d is not None]
    out = list(tensors)
    if split:
        wholes = _GatherShards.apply(mesh, tuple(dims[i] for i in split), *(tensors[i] for i in split))
        for i, w in zip(split, wholes):
            out[i] = w
    return out


def row_grad_sum(*xs: torch.Tensor, mesh) -> tuple[torch.Tensor, ...]:
    """xs as they are, their gradients summed over the row."""
    return _RowSumGrad.apply(mesh, *xs)


def gather_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's last-dim slice of the row, concatenated in rank order."""
    return _GatherColumns.apply(x, mesh)
