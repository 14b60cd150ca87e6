"""Banded attention: the forward (with and without LSE), its dq and dk/dv
backward, each also ranged for context parallelism, the CUDA kernels'
wrappers and their plain PyTorch versions.

Port of osu_diffusion_tpu/ops/pallas_attention.py:
- `banded_attention` without grad: `_banded_attn_fwd_kernel` without LSE
  (inference), csrc/banded_attention.cu, entry `banded_attention_fwd`
  (`banded_attention_fwd_staged` walks its Hopper body in plain PyTorch);
- `banded_attention_fwd_lse`: the same kernel with LSE (training forward),
  same source, entry `banded_attention_fwd_lse`;
- `banded_attention_bwd_dq` / `banded_attention_bwd_dkv`:
  `_banded_attn_bwd_dq_kernel` / `_banded_attn_bwd_dkv_kernel`,
  csrc/banded_attention_bwd.cu;
- the ranged entries, `banded_attention_ranged` (no LSE),
  `banded_attention_ranged_fwd_lse`, `banded_attention_ranged_bwd_dq` and
  `banded_attention_ranged_bwd_dkv`, and the `BandedAttentionRanged`
  autograd Function: `_ranged_fwd_impl` and `_ranged_bwd_impl`, the same
  kernel bodies with their bounds (the same two sources, entries
  `*_ranged`).

The band is the reference's: query q attends key k iff q - L < k <= q + L
(asymmetric by one), and keys at or past the runtime `valid_len` are masked.
A query row whose band holds no valid key returns 0, and its LSE is about
-1e30. The inference forward also takes `valid_len` as a 0-d int32 tensor
on q's device, which the kernel reads when it runs (the TPU kernel's SMEM
operand): a CUDA graph captured around it serves every length of its
bucket, and nothing reads the length on the host. Its range is checked
where the int is known (the Sampler). A CPU tensor is read as it is; the
training entries (LSE, dq, dk/dv) take an int. In the backward, queries
at or past `valid_len` get no gradient, and delta = rowsum(o * do) is
derived from o and do.

q, k, v (and o, do) are float32 or bfloat16, all of one type; matmul
operands are rounded to `matmul_dtype` and accumulated in f32, the softmax
and LSE are f32, and outputs come back in q's type. The LSE is one
(N*H, T) float32 array. The query is scaled by Dh^-1/2 in f32 before its
rounding, as the TPU kernel does (`_scores`).

Head dims on the card: Dh in HEAD_DIMS, 64 (DiT-S/B/L) or 72 (DiT-XL), in
every entry, ranged or not (XL training, under context parallelism too);
any other head dim raises a ValueError before any launch.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel or raises. Each kernel launch adds one to its wrapper's `.launches`
(the Sampler's CUDA graphs count their captured launches there on each
replay, and not at capture: sampling.py).
Every forward entry runs the Hopper body (wgmma, the softmax in registers)
in both types: bf16 q/k/v arrive by a TMA ring, f32 ones by the consumer
threads' own 16-byte loads, rounded to bf16 on the chip. dq and dk/dv have
two bodies, chosen by the C entry by dtype: a bf16 call runs the Hopper
body (wgmma, a TMA ring, dS in registers), an f32 call the WMMA body.
After a launch the wrapper's `.body` names the one that ran ("sm90" or
"wmma"). TMA reads q/k/v through strides in multiples of 16 bytes: a bf16
q/k/v whose strides are multiples of 4 elements but not of 8 is copied to
a contiguous layout first (`_fit_tma`); the model's layouts (head views of
the packed qkv projection, contiguous shards) need no copy. The inference
forwards, unranged and ranged, take `out_dtype`: torch.bfloat16 for f32
q/k/v writes o in bf16 from the kernel's registers (the int8 block's out
projection rounds o to bf16 first; the plain version's o is rounded the
same way).
`banded_attention` under grad (an input requires it) runs the
`BandedAttention` autograd Function: the LSE forward, then dq and dk/dv.

Ranged (parallel/context.py): q, k, v are one shard's halo-extended rows
(T_ext), `bounds` = (k_lo, k_hi, q_lo, q_hi) are runtime ints, and the band
holds in extended coordinates. Keys outside [k_lo, k_hi) are masked (the
halo an edge shard has no neighbour for, the global padded tail); query
rows outside [q_lo, q_hi) are q's pad rows. The forward's output and LSE
rows outside [q_lo, q_hi) are undefined (the kernel writes 0 and -1e30
there, the plain version computes them; the caller slices them off), and
in the backward those rows get no gradient and give none to dk/dv. There is
no valid_len: [k_lo, k_hi) carries it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from osu_diffusion_tpu_torch.ops import cuda_build

HEAD_DIMS = (64, 72)  # head dims of the kernels (DiT-S/B/L, DiT-XL)
NEG_INF = -1e30
FWD_BLOCK = 128  # query rows of a CTA of the Hopper forward: two warpgroups of 64
KEY_TILE = 64  # keys of one K/V tile of its ring
ACT_DTYPES = (torch.float32, torch.bfloat16)  # activation types the kernels take


def banded_attention_mask(seq_len: int, half_width: int, device=None) -> torch.Tensor:
    """Boolean (T, T) mask, True = attention allowed: q - L < k <= q + L."""
    q = torch.arange(seq_len, device=device)[:, None]
    k = torch.arange(seq_len, device=device)[None, :]
    return (k > q - half_width) & (k <= q + half_width)


def _allowed(t: int, band: int, valid_len, device, query_valid: bool = False,
             bounds: tuple[int, int, int, int] | None = None):
    """(T, T) mask: the band, keys below valid_len (an int or a 0-d
    tensor on `device`; and in [k_lo, k_hi)), with `query_valid` also
    queries below valid_len (and in [q_lo, q_hi))."""
    idx = torch.arange(t, device=device)
    keys = rows = idx < valid_len
    if bounds is not None:
        k_lo, k_hi, q_lo, q_hi = bounds
        keys = keys & (idx >= k_lo) & (idx < k_hi)
        rows = rows & (idx >= q_lo) & (idx < q_hi)
    allowed = banded_attention_mask(t, band, device) & keys[None, :]
    return allowed & rows[:, None] if query_valid else allowed


def _rounder(matmul_dtype):
    def rnd(a):
        return a.to(torch.float32).to(matmul_dtype).to(torch.float32)
    return rnd


def _scores(q, k, matmul_dtype):
    """bf16(q * Dh^-1/2) . bf16(k)^T in f32, and the rounded scaled q."""
    rnd = _rounder(matmul_dtype)
    qs = rnd(q.to(torch.float32) * (1.0 / math.sqrt(q.shape[-1])))
    return torch.matmul(qs, rnd(k).transpose(-1, -2)), qs


def banded_attention_fwd_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, band: int,
    valid_len: int | torch.Tensor, matmul_dtype: torch.dtype = torch.float32,
    bounds: tuple[int, int, int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward with LSE: (o (N, H, T, Dh) in q's type,
    lse (N*H, T) f32 = m + log(max(l, 1e-30)) of the masked row softmax).
    `bounds`: the ranged forward's (k_lo, k_hi, q_lo, q_hi); keys outside
    [k_lo, k_hi) are masked, and every query row is computed."""
    n, h, t, dh = q.shape
    rnd = _rounder(matmul_dtype)
    s, _ = _scores(q, k, matmul_dtype)
    allowed = _allowed(t, band, valid_len, q.device, bounds=bounds)
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(rnd(p), rnd(v)) / l.clamp_min(1e-30)
    lse = (m + torch.log(l.clamp_min(1e-30))).reshape(n * h, t)
    return o.to(q.dtype), lse


def banded_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, band: int,
    valid_len: int | torch.Tensor, matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of the inference forward: (N, H, T, Dh) -> (N, H, T, Dh).

    Matmul operands are rounded to `matmul_dtype` and multiplied in f32, so
    with bfloat16 it follows the kernel's precision contract (bf16 operands,
    f32 accumulation) and with float32 it is the f32 attention."""
    return banded_attention_fwd_lse_reference(q, k, v, band, valid_len, matmul_dtype)[0]


def banded_attention_fwd_staged(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, band: int, valid_len: int | None = None,
    bounds: tuple[int, int, int, int] | None = None, out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Hopper forward's walk in plain PyTorch, bf16 operands: (o
    (N, H, T, Dh) in `out_dtype` (default q's type), lse (N*H, T) f32).

    Per FWD_BLOCK-row query block: the KEY_TILE-key tiles that meet the
    block's band, below valid_len (ranged: in [k_lo, k_hi), none for a
    block of pad query rows); per 64-row half (a warpgroup), the tiles that
    meet its own rows' band (none for a half past T or, ranged, of pad
    query rows: its o is 0, its LSE ~-1e30), each folded into an f32
    online softmax (row max, rescaled sum and accumulator) tile by tile.
    At Dh = 64 scores are bf16(q) . bf16(k) scaled in f32 (scale folding:
    bf16(q / 8) = bf16(q) / 8); at Dh = 72 they are bf16(q * Dh^-1/2) .
    bf16(k), the head dim padded with zeros to 80 (a 64-column slab and a
    16-column one, columns 72..79 zero in q, k and v) for Q.K^T and P.V,
    whose padded columns are dropped. P is rounded to bf16 for P.V."""
    n, h, t, dh = q.shape
    f32 = torch.float32
    rnd = _rounder(torch.bfloat16)
    valid = t if valid_len is None or bounds is not None else int(valid_len)
    scale = 1.0 / math.sqrt(dh)
    tiles = -(-t // KEY_TILE) * KEY_TILE  # key rows past T read as 0, as TMA reads them
    cols = -(-dh // 16) * 16 - dh  # the head dim's zero columns up to wgmma's k16 step
    if dh == 64:
        qr = rnd(q)
    else:  # the scale before the rounding; S is not scaled again
        qr = torch.nn.functional.pad(rnd(q.to(f32) * scale), (0, cols))
        scale = 1.0
    kr, vr = (torch.nn.functional.pad(rnd(a), (0, cols, 0, tiles - t)) for a in (k, v))
    dev = q.device
    o = torch.zeros((n, h, t, dh), dtype=f32, device=dev)
    lse = torch.full((n, h, t), NEG_INF, dtype=f32, device=dev)
    for q0 in range(0, t, FWD_BLOCK):
        k_lo, k_hi = max(0, q0 - band + 1), min(valid - 1, q0 + FWD_BLOCK - 1 + band)
        if bounds is not None:
            k_lo, k_hi = max(k_lo, bounds[0]), min(k_hi, bounds[1] - 1)
            if q0 + FWD_BLOCK <= bounds[2] or q0 >= bounds[3]:
                k_hi = -1
        kt0 = k_lo // KEY_TILE
        ntiles = k_hi // KEY_TILE - kt0 + 1 if k_lo <= k_hi else 0
        for qw in range(q0, min(q0 + FWD_BLOCK, t), 64):
            w_lo, w_hi = max(k_lo, qw - band + 1), min(k_hi, qw + 63 + band)
            if bounds is not None and (qw + 64 <= bounds[2] or qw >= bounds[3]):
                w_hi = -1
            rows = torch.arange(qw, min(qw + 64, t), device=dev)
            m = torch.full((n, h, len(rows), 1), NEG_INF, dtype=f32, device=dev)
            l = torch.zeros((n, h, len(rows), 1), dtype=f32, device=dev)
            acc = torch.zeros((n, h, len(rows), dh + cols), dtype=f32, device=dev)
            for kbase in range(kt0 * KEY_TILE, (kt0 + ntiles) * KEY_TILE, KEY_TILE):
                if not (kbase <= w_hi and kbase + KEY_TILE - 1 >= w_lo):
                    continue  # the warpgroup skips the tile
                keys = torch.arange(kbase, kbase + KEY_TILE, device=dev)
                allowed = ((keys[None, :] > rows[:, None] - band) & (keys[None, :] <= rows[:, None] + band)
                           & (keys[None, :] < valid))
                if bounds is not None:
                    allowed &= (keys[None, :] >= bounds[0]) & (keys[None, :] < bounds[1])
                s = torch.matmul(qr[:, :, rows], kr[:, :, kbase:kbase + KEY_TILE].transpose(-1, -2)) * scale
                mx = torch.maximum(m, torch.where(allowed, s, NEG_INF).amax(dim=-1, keepdim=True))
                alpha = torch.exp(m - mx)
                p = torch.where(allowed, torch.exp(s - mx), 0.0)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.matmul(rnd(p), vr[:, :, kbase:kbase + KEY_TILE])
                m = mx
            denom = l.clamp_min(1e-30)
            o[:, :, rows] = acc[..., :dh] / denom  # o's padded columns are never stored
            lse[:, :, rows] = (m + torch.log(denom))[..., 0]
    return o.to(out_dtype or q.dtype), lse.reshape(n * h, t)


def banded_attention_bwd_reference(
    q, k, v, o, lse, do, band: int, valid_len: int,
    matmul_dtype: torch.dtype = torch.float32,
    bounds: tuple[int, int, int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dq, dk, dv) in q's type.

    P is recomputed from q.k and the saved LSE where allowed (queries past
    valid_len included in the mask), delta = rowsum(o * do) in f32,
    dS = P * (dP - delta) where allowed (else 0) with dP = do.v^T;
    dq = dS.k * Dh^-1/2, dk = dS^T.(q * Dh^-1/2), dv = P^T.do, every
    product over rounded operands with f32 accumulation. `bounds`: the
    ranged backward's (k_lo, k_hi, q_lo, q_hi), in the mask too."""
    n, h, t, dh = q.shape
    f32 = torch.float32
    rnd = _rounder(matmul_dtype)
    s, qs = _scores(q, k, matmul_dtype)
    allowed = _allowed(t, band, valid_len, q.device, query_valid=True, bounds=bounds)
    lse4 = lse.reshape(n, h, t, 1)
    p = torch.where(allowed, torch.exp(torch.where(allowed, s - lse4, 0.0)), 0.0)
    dor = rnd(do)
    dp = torch.matmul(dor, rnd(v).transpose(-1, -2))
    delta = (o.to(f32) * do.to(f32)).sum(dim=-1, keepdim=True)
    ds = torch.where(allowed, p * (dp - delta), 0.0)
    dq = torch.matmul(rnd(ds), rnd(k)) * (1.0 / math.sqrt(dh))
    dk = torch.matmul(rnd(ds).transpose(-1, -2), qs)
    dv = torch.matmul(rnd(p).transpose(-1, -2), dor)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bind(lib, name: str, argtypes) -> None:
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("banded_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # (q, k, v, o, [lse,] n, h, t, dh, sn, sh, st, osn, osh, ost, band, valid,
    #  [valid_ptr,] scale, bf16, [out_bf16,] stream)
    _bind(lib, "banded_attention_fwd", [p] * 4 + [i] * 4 + [ll] * 6 + [i, i, p, ctypes.c_float, i, i, p])
    _bind(lib, "banded_attention_fwd_lse", [p] * 5 + [i] * 4 + [ll] * 6 + [i, i, ctypes.c_float, i, p])
    # ranged: (band, k_lo, k_hi, q_lo, q_hi) in place of (band, valid)
    _bind(lib, "banded_attention_fwd_ranged", [p] * 4 + [i] * 4 + [ll] * 6 + [i] * 5 + [ctypes.c_float, i, i, p])
    _bind(lib, "banded_attention_fwd_ranged_lse", [p] * 5 + [i] * 4 + [ll] * 6 + [i] * 5 + [ctypes.c_float, i, p])
    lib.banded_attention_error_string.restype = ctypes.c_char_p
    lib.banded_attention_error_string.argtypes = [ctypes.c_int]
    lib.banded_attention_last_body.restype = ctypes.c_char_p
    lib.banded_attention_last_body.argtypes = []
    lib.banded_attention_sm90_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("banded_attention_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # (q, k, v, o, do, lse, grad outputs, n, h, t, dh, q/k/v strides,
    #  o/do/grad strides, band, valid, scale, bf16, stream)
    _bind(lib, "banded_attention_bwd_dq", [p] * 7 + [i] * 4 + [ll] * 6 + [i, i, ctypes.c_float, i, p])
    _bind(lib, "banded_attention_bwd_dkv", [p] * 8 + [i] * 4 + [ll] * 6 + [i, i, ctypes.c_float, i, p])
    _bind(lib, "banded_attention_bwd_dq_ranged", [p] * 7 + [i] * 4 + [ll] * 6 + [i] * 5 + [ctypes.c_float, i, p])
    _bind(lib, "banded_attention_bwd_dkv_ranged", [p] * 8 + [i] * 4 + [ll] * 6 + [i] * 5 + [ctypes.c_float, i, p])
    lib.banded_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.banded_attention_bwd_error_string.argtypes = [ctypes.c_int]
    for entry in ("dq", "dkv"):
        body = getattr(lib, f"banded_attention_bwd_last_{entry}_body")
        body.restype = ctypes.c_char_p
        body.argtypes = []
        getattr(lib, f"banded_attention_bwd_sm90_{entry}_smem_bytes").argtypes = [ctypes.c_int]
    lib.banded_attention_bwd_wmma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def sm90_smem_bytes() -> dict[str, int]:
    """Dynamic shared memory per CTA of the Hopper bodies, bytes: the
    forward (bf16 and f32 q/k/v), dq and dk/dv, at Dh 64 and, as
    "... dh72", 72."""
    lib, bwd = _lib(), _bwd_lib()
    out = {}
    for dh in HEAD_DIMS:
        tag = " dh72" * (dh == 72)
        out.update({f"fwd{' f32' * f32}{tag}": lib.banded_attention_sm90_smem_bytes(f32, dh) for f32 in (0, 1)})
        out[f"dq{tag}"] = bwd.banded_attention_bwd_sm90_dq_smem_bytes(dh)
        out[f"dkv{tag}"] = bwd.banded_attention_bwd_sm90_dkv_smem_bytes(dh)
    return out


def wmma_smem_bytes() -> dict[str, int]:
    """Dynamic shared memory per CTA of the f32 stream's WMMA dq and dk/dv
    bodies, bytes, at Dh 64 and, as "... dh72", 72."""
    bwd = _bwd_lib()
    return {f"wmma {entry}{' dh72' * (dh == 72)}": bwd.banded_attention_bwd_wmma_smem_bytes(dkv, dh)
            for dh in HEAD_DIMS for dkv, entry in enumerate(("dq", "dkv"))}


def _check_head_dim(dh: int) -> None:
    """The head dims of the kernels: HEAD_DIMS, in every entry."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernels take head dims {HEAD_DIMS}, got {dh}")


def _check_kernel_inputs(matmul_dtype, **tensors) -> None:
    """Every tensor: the first one's device, type, shape and strides, a
    contiguous head dim in HEAD_DIMS, strides in multiples of 4 elements,
    16-byte aligned."""
    if matmul_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels compute with bf16 operands; "
                         f"matmul_dtype={matmul_dtype} has no kernel")
    (first_name, first), *_ = tensors.items()
    if first.dtype not in ACT_DTYPES:
        raise TypeError(f"{first_name} must be one of {ACT_DTYPES}, got {first.dtype}")
    for name, a in tensors.items():
        if a.device != first.device:
            raise ValueError(f"{name} is on {a.device}, {first_name} on {first.device}")
        if a.dtype != first.dtype:
            raise TypeError(f"{name} is {a.dtype}, {first_name} {first.dtype}")
        if a.shape != first.shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, {first_name} {tuple(first.shape)}")
        if a.stride() != first.stride():
            raise ValueError(f"{name} and {first_name} must share strides")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _check_head_dim(first.shape[-1])
    if first.stride(-1) != 1 or any(s % 4 for s in first.stride()[:-1]):
        raise ValueError(
            "q/k/v need a contiguous head dim and strides that are multiples "
            f"of 4 elements, got strides {first.stride()}"
        )
    if first.device.index != torch.cuda.current_device():
        raise ValueError(f"{first_name} is on {first.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    n, h = first.shape[:2]
    if n * h > 65535:
        raise ValueError(f"N*H = {n * h} exceeds the kernels' grid limit 65535")


def _check_args(q, band: int, valid_len, on_device: bool = False):
    """valid_len as the entry takes it: an int (T when None), or with
    `on_device` (the inference forward) a 0-d int32 tensor on q's device,
    returned as it is; its range is checked here only on the CPU."""
    t = q.shape[-2]
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no banded attention for device {q.device}")
    tensor = isinstance(valid_len, torch.Tensor)
    if tensor:
        if valid_len.ndim != 0 or valid_len.dtype != torch.int32 or valid_len.device != q.device:
            raise TypeError(f"valid_len as a tensor must be 0-d int32 on {q.device}, got "
                            f"{valid_len.dtype} {tuple(valid_len.shape)} on {valid_len.device}")
        if q.device.type == "cuda":
            if not on_device:
                raise ValueError("only the inference forward reads valid_len on the device; "
                                 "this entry takes an int")
            return valid_len
    length = t if valid_len is None else int(valid_len)
    if not 1 <= length <= t:
        raise ValueError(f"valid_len {length} outside [1, {t}]")
    return valid_len if tensor and on_device else length


def _check_bounds(q, band: int, bounds) -> tuple[int, int, int, int]:
    """The ranged calls' (k_lo, k_hi, q_lo, q_hi) as ints: k_lo >= 0 and
    0 <= q_lo <= q_hi <= T (k_hi may be below k_lo: no key is valid)."""
    _check_args(q, band, None)
    k_lo, k_hi, q_lo, q_hi = (int(b) for b in bounds)
    t = q.shape[-2]
    if k_lo < 0 or not 0 <= q_lo <= q_hi <= t:
        raise ValueError(f"bounds (k_lo {k_lo}, k_hi {k_hi}, q_lo {q_lo}, q_hi {q_hi}) "
                         f"outside T = {t}")
    return k_lo, k_hi, q_lo, q_hi


def _fit_tma(q, k, v):
    """q, k, v as the kernels take them: TMA needs strides in multiples of
    16 bytes (8 bf16 elements), so other bf16 layouts are copied to
    contiguous ones (a stated copy; never the model's layouts). f32 inputs
    go as they are: the forward's 16-byte loads and the f32 backward take
    any stride of 4 elements that `_check_kernel_inputs` lets through."""
    if q.dtype != torch.bfloat16 or not any(s % 8 for s in q.stride()[:3]):
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


def _heads_out(q: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """An (N, T, H, Dh) buffer in `dtype` (default q's type), returned as
    its (N, H, T, Dh) view: the head merge after attention is then a free
    reshape."""
    n, h, t, dh = q.shape
    return torch.empty((n, t, h, dh), device=q.device, dtype=dtype or q.dtype).permute(0, 2, 1, 3)


def _raise_on(err: int, lib, entry: str, what: str) -> None:
    if err:
        msg = getattr(lib, f"{entry}_error_string")(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _stream(a: torch.Tensor) -> int:
    return torch.cuda.current_stream(a.device).cuda_stream


def _launch_fwd(fn, q, k, v, band, valid_len, with_lse: bool, bounds=None, out_dtype=None):
    """Launch the forward entry of wrapper `fn` (o in `out_dtype`, default
    q's type: only the inference entries, unranged and ranged, take
    another) and record its body in `fn.body`."""
    q, k, v = _fit_tma(q, k, v)
    n, h, t, dh = q.shape
    out = _heads_out(q, out_dtype)
    lse = torch.empty((n * h, t), device=q.device, dtype=torch.float32) if with_lse else None
    lib = _lib()
    sn, sh, st, _ = q.stride()
    osn, osh, ost, _ = out.stride()
    lse_arg = (lse.data_ptr(),) if with_lse else ()
    entry = "banded_attention_fwd" + ("_ranged" if bounds is not None else "") + ("_lse" if with_lse else "")
    if bounds is not None:
        mask_args = (band, *bounds)
    elif with_lse:
        mask_args = (band, valid_len)
    elif isinstance(valid_len, torch.Tensor):  # read by the kernel when it runs
        mask_args = (band, t, valid_len.data_ptr())
    else:
        mask_args = (band, valid_len, None)
    # the inference entries' o type
    out_arg = (int(out.dtype == torch.bfloat16),) if not with_lse else ()
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lse_arg, n, h, t, dh,
        sn, sh, st, osn, osh, ost, *mask_args, 1.0 / math.sqrt(dh),
        int(q.dtype == torch.bfloat16), *out_arg, _stream(q),
    )
    _raise_on(err, lib, "banded_attention", "banded_attention")
    fn.body = lib.banded_attention_last_body().decode()
    return out, lse


def banded_attention_fwd_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, band: int,
    valid_len: int | None = None, matmul_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (o (N, H, T, Dh), lse (N*H, T) f32)."""
    valid_len = _check_args(q, band, valid_len)
    if q.device.type == "cpu":
        return banded_attention_fwd_lse_reference(q, k, v, band, valid_len, matmul_dtype)
    _check_kernel_inputs(matmul_dtype, q=q, k=k, v=v)
    out = _launch_fwd(banded_attention_fwd_lse, q, k, v, band, valid_len, with_lse=True)
    banded_attention_fwd_lse.launches += 1
    return out


def _launch_bwd(fn, entry: str, q, k, v, o, lse, do, band, valid_len, matmul_dtype, bounds=None):
    # q/k/v share one set of strides, o/do (and the gradients, written in
    # o's layout) another; records the body that ran in `fn.body`
    _check_kernel_inputs(matmul_dtype, q=q, k=k, v=v)
    _check_kernel_inputs(matmul_dtype, o=o, do=do)
    q, k, v = _fit_tma(q, k, v)
    if o.dtype != q.dtype or o.shape != q.shape:
        raise ValueError(f"o is {o.dtype} {tuple(o.shape)}, q {q.dtype} {tuple(q.shape)}")
    n, h, t, dh = q.shape
    if lse.shape != (n * h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 ({n * h}, {t}), got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    grads = [_heads_out(q) for _ in range(1 if entry == "dq" else 2)]
    if grads[0].stride() != o.stride():
        raise ValueError(f"o must have the (N, T, H, Dh) buffer's strides {grads[0].stride()}, "
                         f"got {o.stride()}")
    lib = _bwd_lib()
    name = f"banded_attention_bwd_{entry}" + ("_ranged" if bounds is not None else "")
    mask_args = (band, valid_len) if bounds is None else (band, *bounds)
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), *(g.data_ptr() for g in grads), n, h, t, dh,
        *q.stride()[:3], *grads[0].stride()[:3], *mask_args,
        1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16), _stream(q),
    )
    _raise_on(err, lib, "banded_attention_bwd", name)
    fn.body = getattr(lib, f"banded_attention_bwd_last_{entry}_body")().decode()
    return grads


def banded_attention_bwd_dq(
    q, k, v, o, lse, do, band: int, valid_len: int | None = None,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """dq of the banded attention, from the forward's o and LSE."""
    valid_len = _check_args(q, band, valid_len)
    if q.device.type == "cpu":
        return banded_attention_bwd_reference(q, k, v, o, lse, do, band, valid_len, matmul_dtype)[0]
    (dq,) = _launch_bwd(banded_attention_bwd_dq, "dq", q, k, v, o, lse, do, band, valid_len, matmul_dtype)
    banded_attention_bwd_dq.launches += 1
    return dq


def banded_attention_bwd_dkv(
    q, k, v, o, lse, do, band: int, valid_len: int | None = None,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the banded attention, from the forward's o and LSE."""
    valid_len = _check_args(q, band, valid_len)
    if q.device.type == "cpu":
        return banded_attention_bwd_reference(q, k, v, o, lse, do, band, valid_len, matmul_dtype)[1:]
    dk, dv = _launch_bwd(banded_attention_bwd_dkv, "dkv", q, k, v, o, lse, do, band, valid_len, matmul_dtype)
    banded_attention_bwd_dkv.launches += 1
    return dk, dv


def _do_as_o(do: torch.Tensor, q: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The upstream gradient in q's type and, on the card, o's strides (the
    kernels read do through them)."""
    do = do.to(q.dtype)
    if q.device.type == "cuda" and do.stride() != o.stride():
        do = _heads_out(q).copy_(do)
    return do


class BandedAttention(torch.autograd.Function):
    """Banded attention with the kernels' backward (LSE forward, then the
    dq and dk/dv kernels; their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, band: int, valid_len: int, matmul_dtype):
        o, lse = banded_attention_fwd_lse(q, k, v, band, valid_len, matmul_dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (band, valid_len, matmul_dtype)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _do_as_o(do, q, o)
        dq = banded_attention_bwd_dq(q, k, v, o, lse, do, *ctx.args)
        dk, dv = banded_attention_bwd_dkv(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def _wants_grad(q, k, v) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


def _check_out_dtype(q, out_dtype, grad: bool) -> None:
    if out_dtype not in (None, q.dtype) and (grad or (q.dtype, out_dtype) != (torch.float32, torch.bfloat16)):
        raise ValueError(f"out_dtype {out_dtype} for {q.dtype} q: the inference forward writes "
                         "o in q's type, or bf16 for f32 q")


def banded_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, band: int,
    valid_len: int | torch.Tensor | None = None, matmul_dtype: torch.dtype = torch.bfloat16,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """q, k, v: (N, H, T, Dh) -> (N, H, T, Dh), band half-width L.

    `valid_len`: the real (unpadded) length when T was padded; keys at or
    past it are masked. An int, or without grad a 0-d int32 tensor on q's
    device (read by the kernel, never on the host). On a CUDA tensor the kernels read q/k/v through their
    strides (head views of a packed qkv projection need no copy) and write
    an (N, T, H, Dh) buffer returned as its (N, H, T, Dh) view. Under grad
    the call is differentiable through `BandedAttention`; otherwise it is
    the inference forward (no LSE), whose o is in `out_dtype`: q's type
    (the default) or, for f32 q, torch.bfloat16 (o rounded from f32, as
    the int8 out projection takes it; the kernel writes it so from its
    registers, the plain version rounds its f32 o)."""
    grad = _wants_grad(q, k, v)
    valid_len = _check_args(q, band, valid_len, on_device=not grad)
    _check_out_dtype(q, out_dtype, grad)
    if grad:
        return BandedAttention.apply(q, k, v, band, valid_len, matmul_dtype)
    if q.device.type == "cpu":
        return banded_attention_reference(q, k, v, band, valid_len, matmul_dtype).to(out_dtype or q.dtype)
    _check_kernel_inputs(matmul_dtype, q=q, k=k, v=v)
    out, _ = _launch_fwd(banded_attention, q, k, v, band, valid_len, with_lse=False, out_dtype=out_dtype)
    banded_attention.launches += 1
    return out


def banded_attention_ranged_fwd_lse(
    q, k, v, band: int, bounds, matmul_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ranged training forward (row 5 with LSE): (o (N, H, T, Dh), lse
    (N*H, T) f32); rows outside [q_lo, q_hi) undefined."""
    bounds = _check_bounds(q, band, bounds)
    t = q.shape[-2]
    if q.device.type == "cpu":
        return banded_attention_fwd_lse_reference(q, k, v, band, t, matmul_dtype, bounds)
    _check_kernel_inputs(matmul_dtype, q=q, k=k, v=v)
    out = _launch_fwd(banded_attention_ranged_fwd_lse, q, k, v, band, t, with_lse=True, bounds=bounds)
    banded_attention_ranged_fwd_lse.launches += 1
    return out


def banded_attention_ranged_bwd_dq(
    q, k, v, o, lse, do, band: int, bounds, matmul_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """dq of the ranged attention (row 6): 0 outside [q_lo, q_hi)."""
    bounds = _check_bounds(q, band, bounds)
    t = q.shape[-2]
    if q.device.type == "cpu":
        return banded_attention_bwd_reference(q, k, v, o, lse, do, band, t, matmul_dtype, bounds)[0]
    (dq,) = _launch_bwd(banded_attention_ranged_bwd_dq, "dq", q, k, v, o, lse, do, band, t, matmul_dtype, bounds)
    banded_attention_ranged_bwd_dq.launches += 1
    return dq


def banded_attention_ranged_bwd_dkv(
    q, k, v, o, lse, do, band: int, bounds, matmul_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the ranged attention (row 6): from query rows in
    [q_lo, q_hi) only, 0 outside [k_lo, k_hi)."""
    bounds = _check_bounds(q, band, bounds)
    t = q.shape[-2]
    if q.device.type == "cpu":
        return banded_attention_bwd_reference(q, k, v, o, lse, do, band, t, matmul_dtype, bounds)[1:]
    dk, dv = _launch_bwd(banded_attention_ranged_bwd_dkv, "dkv", q, k, v, o, lse, do, band, t, matmul_dtype, bounds)
    banded_attention_ranged_bwd_dkv.launches += 1
    return dk, dv


class BandedAttentionRanged(torch.autograd.Function):
    """Ranged banded attention with the ranged kernels' backward (the JAX
    `_ranged_vjp`): LSE forward, then dq and dk/dv, all with the bounds."""

    @staticmethod
    def forward(ctx, q, k, v, band: int, bounds, matmul_dtype):
        o, lse = banded_attention_ranged_fwd_lse(q, k, v, band, bounds, matmul_dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (band, bounds, matmul_dtype)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _do_as_o(do, q, o)
        dq = banded_attention_ranged_bwd_dq(q, k, v, o, lse, do, *ctx.args)
        dk, dv = banded_attention_ranged_bwd_dkv(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def banded_attention_ranged(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, band: int, bounds,
    matmul_dtype: torch.dtype = torch.bfloat16, out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Ranged banded attention over one shard's halo-extended q, k, v
    (N, H, T_ext, Dh), bounds (k_lo, k_hi, q_lo, q_hi): (N, H, T_ext, Dh),
    rows outside [q_lo, q_hi) undefined. Under grad it runs
    `BandedAttentionRanged`; otherwise the inference forward (row 5, no
    LSE), whose o is in `out_dtype` as `banded_attention`'s."""
    bounds = _check_bounds(q, band, bounds)
    grad = _wants_grad(q, k, v)
    _check_out_dtype(q, out_dtype, grad)
    if grad:
        return BandedAttentionRanged.apply(q, k, v, band, bounds, matmul_dtype)
    t = q.shape[-2]
    if q.device.type == "cpu":
        o = banded_attention_fwd_lse_reference(q, k, v, band, t, matmul_dtype, bounds)[0]
        return o.to(out_dtype or q.dtype)
    _check_kernel_inputs(matmul_dtype, q=q, k=k, v=v)
    out, _ = _launch_fwd(banded_attention_ranged, q, k, v, band, t, with_lse=False, bounds=bounds,
                         out_dtype=out_dtype)
    banded_attention_ranged.launches += 1
    return out


# the wrappers whose `.launches` count kernel launches (sampling.py adds a
# CUDA graph's captured launches to them on each replay), and the body the
# last launch took ("sm90" or "wmma"; None before any launch)
WRAPPERS = (banded_attention, banded_attention_fwd_lse, banded_attention_bwd_dq,
            banded_attention_bwd_dkv, banded_attention_ranged, banded_attention_ranged_fwd_lse,
            banded_attention_ranged_bwd_dq, banded_attention_ranged_bwd_dkv)
for _fn in WRAPPERS:
    _fn.launches = 0
    _fn.body = None
del _fn
