"""Context-parallel (sequence-sharded) banded attention over the mesh's
"model" axis (port of osu_diffusion_tpu/parallel/context.py).

The sequence axis is split over the ranks of a CP group (one row of the
mesh). Query rows on one shard attend only keys within `band` positions,
so each shard needs exactly the last and first `halo = ceil(band / 128) *
128` key/value rows of its two neighbours: O(band) bytes a block,
independent of T. Everything else in the DiT works per token (or per
sample), so attention is the only collective of the model.

The halo exchange is one `all_reduce` (sum) over the CP group of a zero
buffer with one slot per rank, in which each rank writes only its own
slot: each slot has one writer, so the sum is exact in any type. It needs
no send/recv, so the same code runs on gloo (the CPU tests, and two ranks
sharing one card, where NCCL refuses) and on NCCL across cards. Under gloo
a bfloat16 exchange is tried once and, if gloo rejects the type, runs in
float32 (bf16 -> f32 -> bf16 is lossless); the branch taken is printed.

The shard's q is padded by `halo` rows on both sides, so query row i sits
at extended index i + halo and the band q - L < k <= q + L holds verbatim
in extended coordinates; the ranged kernels (ops/banded_attention.py) mask
keys to [k_lo, k_hi), computed on the host from the rank's coordinate, and
skip the pad query rows, which are sliced off after. The exchange is an
autograd Function whose backward returns the halo gradients to their
owners the same way, so CP training differentiates through it; under remat
each block's recompute repeats the exchange, in the same order on every
rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from osu_diffusion_tpu_torch.ops.banded_attention import banded_attention_ranged

BLOCK = 128  # the halo's and the shard's granule (the JAX package's DEFAULT_BLOCK)

# (device type, dtype) -> the type gloo exchanges it in: a property of the
# installed torch build, probed once per process
_gloo_types: dict[tuple[str, torch.dtype], torch.dtype] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _exchange_dtype(x: torch.Tensor, group) -> torch.dtype:
    """x's type, unless gloo rejects bfloat16: then float32. Every rank of
    the group probes at the same point of the program."""
    if x.dtype != torch.bfloat16 or dist.get_backend(group) != "gloo":
        return x.dtype
    key = (x.device.type, x.dtype)
    if key not in _gloo_types:
        probe = torch.zeros(1, dtype=x.dtype, device=x.device)
        try:
            dist.all_reduce(probe, group=group)
            _gloo_types[key] = x.dtype
            print(f"[cp] gloo all_reduce takes bfloat16 on {x.device.type}: halos exchange as bfloat16",
                  flush=True)
        except RuntimeError as e:
            _gloo_types[key] = torch.float32
            print(f"[cp] gloo rejects bfloat16 on {x.device.type} ({str(e).splitlines()[0]}): "
                  "halos exchange as float32", flush=True)
    return _gloo_types[key]


def gather_slots(x: torch.Tensor, mesh) -> torch.Tensor:
    """(P, *x.shape): every x of this rank's row, in rank order along the
    "model" axis (a sum all_reduce of one slot per rank). Tensor
    parallelism gathers the adaLN heads' columns with it too."""
    p = mesh.num_model
    if p == 1:
        return x[None]
    dtype = _exchange_dtype(x, mesh.row_group)
    buf = torch.zeros((p, *x.shape), dtype=dtype, device=x.device)
    buf[mesh.model_rank] = x
    dist.all_reduce(buf, group=mesh.row_group)
    return buf.to(x.dtype)


class _NeighborHalos(torch.autograd.Function):
    """(left, right) halos of x (..., T_loc, Dh): the left neighbour's last
    `halo` rows and the right neighbour's first; zeros on an edge shard
    (masked there by the bounds)."""

    @staticmethod
    def forward(ctx, x, halo: int, mesh):
        idx, p = mesh.model_rank, mesh.num_model
        # slot 0: my first rows (my left neighbour's right halo); 1: my last rows
        slots = gather_slots(torch.stack((x[..., :halo, :], x[..., -halo:, :])), mesh)
        ctx.halo, ctx.mesh, ctx.shape = halo, mesh, x.shape
        return (slots[idx - 1, 1] if idx > 0 else torch.zeros_like(slots[0, 0]),
                slots[idx + 1, 0] if idx < p - 1 else torch.zeros_like(slots[0, 0]))

    @staticmethod
    def backward(ctx, g_left, g_right):
        idx, p, halo = ctx.mesh.model_rank, ctx.mesh.num_model, ctx.halo
        # each halo's gradient goes back to the rank whose rows it copied
        slots = gather_slots(torch.stack((g_left, g_right)), ctx.mesh)
        dx = g_left.new_zeros(ctx.shape)
        if idx > 0:  # my first rows were my left neighbour's right halo
            dx[..., :halo, :] += slots[idx - 1, 1]
        if idx < p - 1:  # my last rows were my right neighbour's left halo
            dx[..., ctx.shape[-2] - halo:, :] += slots[idx + 1, 0]
        return dx, None, None


_neighbor_halos = _NeighborHalos.apply


def shard_rows(t: int, cp) -> slice:
    """This rank's rows of a T-row sequence split over the mesh's "model"
    axis."""
    if t % cp.num_model:
        raise ValueError(f"{t} rows do not split over num_model={cp.num_model}")
    t_loc = t // cp.num_model
    return slice(cp.model_rank * t_loc, (cp.model_rank + 1) * t_loc)


def shard_bounds(t_loc: int, halo: int, mesh, valid_len: int | None) -> tuple[int, int, int, int]:
    """(k_lo, k_hi, q_lo, q_hi) of this rank in extended coordinates: an
    edge shard masks the halo it has no neighbour for, and `valid_len` (the
    global real length) masks the padded tail on whichever shard holds it;
    the query rows are the shard's own."""
    idx, p = mesh.model_rank, mesh.num_model
    t_ext = t_loc + 2 * halo
    k_lo = halo if idx == 0 else 0
    k_hi = halo + t_loc if idx == p - 1 else t_ext
    if valid_len is not None:
        # extended index of global key g on this shard: g - idx * t_loc + halo
        k_hi = min(k_hi, int(valid_len) - idx * t_loc + halo)
    return k_lo, k_hi, halo, halo + t_loc


def context_parallel_banded_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, band: int, mesh,
    valid_len: int | None = None, matmul_dtype: torch.dtype = torch.bfloat16,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Banded attention with the sequence split over the mesh's "model"
    axis. q, k, v: this rank's (N, H, T_loc, Dh) slice, rows
    [model_rank * T_loc, (model_rank + 1) * T_loc) of a sequence of
    T = num_model * T_loc, T_loc a multiple of 128; `valid_len`: the global
    real length when T is padded. The same function as `banded_attention`
    on the whole sequence, returned as this rank's (N, H, T_loc, Dh) rows,
    in `out_dtype` (without grad: bf16 for f32 q, as `banded_attention`
    writes it for the int8 block). Every rank of the CP group must call it
    at the same point."""
    n, h, t_loc, dh = q.shape
    halo = _cdiv(band, BLOCK) * BLOCK
    if t_loc % BLOCK:
        raise ValueError(f"the sequence ({mesh.num_model * t_loc} rows) must be a multiple of "
                         f"num_model * {BLOCK} = {mesh.num_model * BLOCK}")
    if halo > t_loc:
        raise ValueError(f"halo {halo} exceeds the local length {t_loc}; use fewer shards or a "
                         "smaller band")
    left, right = _neighbor_halos(torch.stack((k, v)), halo, mesh)
    k_ext = torch.cat((left[0], k, right[0]), dim=2)  # (N, H, T_loc + 2 * halo, Dh)
    v_ext = torch.cat((left[1], v, right[1]), dim=2)
    q_ext = F.pad(q, (0, 0, halo, halo))
    bounds = shard_bounds(t_loc, halo, mesh, valid_len)
    out = banded_attention_ranged(q_ext, k_ext, v_ext, band, bounds, matmul_dtype, out_dtype)
    return out[:, :, halo:halo + t_loc]
