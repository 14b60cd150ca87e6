"""Fused adaLN-modulated MLP: kernel B (inference and training forward,
and the int8 serving forward), the training backward, and their plain
PyTorch versions.

Port of osu_diffusion_tpu/ops/pallas_mlp.py: `_adaln_mlp_kernel` without
residuals (`adaln_mlp`, inference) and with them (`adaln_mlp_train`), and
`_adaln_mlp_quant_kernel` (`adaln_mlp_quant`, int8 weights), all
csrc/adaln_mlp.cu; the default plain backward `_bwd` (`adaln_mlp_bwd`);
and the fused backward `_bwd_fused_impl` (`adaln_mlp_bwd_fused`), whose
two stages `_bwd_prologue_kernel` and `_bwd_epilogue_kernel` are
`adaln_mlp_bwd_prologue` and `adaln_mlp_bwd_epilogue`,
csrc/adaln_mlp_bwd.cu. It computes the MLP half of a DiT block,

    out = x + gate * fc2(gelu_tanh(fc1(LN(x) * (1 + scale) + shift)))

with a non-affine two-pass LayerNorm. x and out are float32 or bfloat16
(the training stream); shift/scale/gate and the biases are f32. In
training the forward also returns the backward's residuals: the pre-GELU
`a` (N, T, H) in x's type and the pre-gate `mlp` (N, T, D) in f32.

The forwards take the Hopper body: a modulate pass, then two persistent
wgmma GEMMs (up, with bias and GELU in its epilogue; down, with bias, gate
and residual in its), sized by the tile plan `mlp_plan`; the weights come
in torch's Linear layout (fc1 (H, D), fc2 (D, H)), and the hidden
activation goes through device memory as bf16. `adaln_mlp` and
`adaln_mlp_train` take bf16 weights; the int8 serving forward
(`adaln_mlp_quant`, f32 x only) takes int8 codes in that layout, as
QuantLinear holds them, with their per-output-channel scales s1 (H,), s2
(D,): the GEMMs upcast each slab of codes to bf16 on chip and scale each
column's f32 sum in their epilogues. The fused backward's two stages take
the Linear weights in torch's layout too (fc2 (D, H) for the prologue, fc1
(H, D) for the epilogue, bf16): in the bf16 stream their Hopper body (a row
pass and a persistent wgmma GEMM each, sized by `mlp_bwd_plan`) reads them
as they are; the f32 stream's WMMA body packs them first (`pack_w1`,
`pack_w2`). After a launch the wrapper's `.body` names the body that ran
("sm90" or "wmma").

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel or raises. Each kernel launch adds one to its wrapper's `.launches`
(the Sampler's CUDA graphs count their captured launches there on each
replay, and not at capture: sampling.py).
`AdalnMlp` is the autograd Function of the training path: it takes fc1/fc2
weights in torch's (out, in) layout, casts them itself (the fused backward
reads the forward's casts), and returns their gradients in that layout;
`bwd_impl` picks the plain or the fused backward.

Tensor parallelism (parallel/sharding.py) splits the hidden units over the
model ranks: each rank runs these on its fc1 rows and fc2 columns (H/P
wide), and `partial=True` on every rank but one leaves out what must be
added once: b2 and the residual x in the training forward, the residual's
g in dx. The row's sums of out, mlp, dx, dshift, dscale and dgate are then
the whole MLP half's. The kernels take H in multiples of HIDDEN_CHUNK; a
shard of another width (192 at DiT-S or DiT-B over 8 ranks, 576 at DiT-XL
over 8) runs in `AdalnMlp` zero-padded to the next multiple
(`pad_hidden`), on the CPU as on the card: a padded unit's pre-activation
is 0, gelu(0) = 0 meets a zero column of fc2, and its da, dfc1, db1 and
dfc2 are 0 (GELU'(0) times a zero row of dmlp . fc2^T), so the result and
the true units' gradients are the unpadded call's, which the Function
returns sliced back to the shard.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from osu_diffusion_tpu_torch.ops import cuda_build
from osu_diffusion_tpu_torch.ops.gemm_plan import (
    GEMM_ROWS,
    GEMM_WIDTHS,
    BWD_WIDTHS,
    SERVE_WIDTHS,
    TRAIN_WIDTHS,
    GemmPlan,
    gemm_plan,
)
from osu_diffusion_tpu_torch.ops.quant import dequant_matmul

ACT_DTYPES = (torch.float32, torch.bfloat16)  # activation types the kernel takes
GELU_C0 = 0.7978845608028654  # sqrt(2 / pi)
GELU_C1 = 0.044715

# the packed layout of the fused backward's f32 stream (its WMMA body)
HIDDEN_CHUNK = 128  # those kernels walk the hidden dim in chunks of this width
ROW_PAD = 8  # zero elements after each packed row: their shared-memory row padding
ROW_TILE = 32  # tokens per CTA of those kernels
# the fused backward's dgelu GEMM: its epilogue's state (gelu'(a), da, the
# db1 sums, the next block of `a`) beside 256-wide tiles' 128 accumulators a
# thread spilled out of ptxas's 168-register cap and ran slower (PERF.md)
BWD_DGELU_WIDTHS = (128,)


def padded_hidden(hdim: int) -> int:
    """hdim rounded up to a multiple of HIDDEN_CHUNK, the widths the
    kernels take."""
    return -(-hdim // HIDDEN_CHUNK) * HIDDEN_CHUNK


def pad_hidden(fc1_w: torch.Tensor, b1: torch.Tensor, fc2_w: torch.Tensor, width: int):
    """(fc1_w (H, D), b1 (H,), fc2_w (D, H)) with zero hidden units
    appended up to `width`: fc1's rows, b1's entries and fc2's columns."""
    extra = width - fc1_w.shape[0]
    return F.pad(fc1_w, (0, 0, 0, extra)), F.pad(b1, (0, extra)), F.pad(fc2_w, (0, extra))


def pack_w1(w1: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """w1 (D, H) -> w1p (H/128, D, 128 + ROW_PAD): w1 cut into 128-column
    chunks, chunk-major, each row padded with zeros that are never read."""
    d, h = w1.shape
    chunks = w1.to(dtype).reshape(d, h // HIDDEN_CHUNK, HIDDEN_CHUNK).permute(1, 0, 2)
    return F.pad(chunks, (0, ROW_PAD)).contiguous()


def pack_w2(w2: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """w2 (H, D) -> w2p (H, D + ROW_PAD), each row padded with zeros."""
    return F.pad(w2.to(dtype), (0, ROW_PAD)).contiguous()


def pack_weights(w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """(w1 (D, H), w2 (H, D)) -> (w1p, w2p), the packed layout of the WMMA
    bodies (`pack_w1`, `pack_w2`)."""
    return pack_w1(w1, dtype), pack_w2(w2, dtype)


def _rounder(matmul_dtype):
    def rnd(a):
        return a.to(torch.float32).to(matmul_dtype).to(torch.float32)
    return rnd


def _layer_norm_f32(x, eps: float):
    """(xn, 1/std) of the non-affine two-pass LayerNorm, in f32."""
    xf = x.to(torch.float32)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * inv, inv


def adaln_mlp_train_reference(
    x, shift, scale, gate, w1, b1, w2, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32, partial: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: (out in x's type, a (N, T, H)
    in x's type, mlp (N, T, D) f32). x: (N, T, D); shift/scale/gate: (N, D);
    w1: (D, H); w2: (H, D). Matmul operands are rounded to `matmul_dtype`
    and multiplied in f32 (bf16 = the kernel's precision contract; f32 = the
    f32 MLP); GELU takes the unrounded f32 pre-activation. `partial`: one
    tensor-parallel rank's share, w1/b1 and w2 its hidden units: neither b2
    nor the residual x is added (out = gate * mlp), so that the row's sum of
    out and of mlp, with one rank not partial, is the whole MLP half's."""
    f32 = torch.float32
    rnd = _rounder(matmul_dtype)
    xn, _ = _layer_norm_f32(x, eps)
    h = xn * (1.0 + scale.to(f32)[:, None, :]) + shift.to(f32)[:, None, :]
    pre = torch.matmul(rnd(h), rnd(w1)) + b1.to(f32)
    mlp = torch.matmul(rnd(F.gelu(pre, approximate="tanh")), rnd(w2))
    if partial:
        out = gate.to(f32)[:, None, :] * mlp
    else:
        mlp = mlp + b2.to(f32)
        out = x.to(f32) + gate.to(f32)[:, None, :] * mlp
    return out.to(x.dtype), pre.to(x.dtype), mlp


def adaln_mlp_reference(
    x, shift, scale, gate, w1, b1, w2, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of the inference forward (the training forward's
    output alone)."""
    return adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, eps, matmul_dtype)[0]


def mlp_plan(n: int, t: int, d: int, hdim: int, sm_count: int) -> tuple[GemmPlan, GemmPlan]:
    """The Hopper body's two GEMMs over the N*T token rows: up (h . W1^T,
    H columns over a depth of D) and down (g . W2^T, D columns over H)."""
    return gemm_plan(n * t, hdim, d, sm_count), gemm_plan(n * t, d, hdim, sm_count)


def mlp_bwd_plan(n: int, t: int, d: int, hdim: int, sm_count: int) -> tuple[GemmPlan, GemmPlan]:
    """The fused backward's two GEMMs over the N*T token rows, the forward's
    shapes: dgelu (dmlp . fc2_w, H columns over a depth of D, in
    BWD_DGELU_WIDTHS) and dh1 (da . fc1_w, D columns over H)."""
    return (gemm_plan(n * t, hdim, d, sm_count, BWD_DGELU_WIDTHS),
            gemm_plan(n * t, d, hdim, sm_count))


def adaln_mlp_train_staged(x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps: float,
                           plan: tuple[GemmPlan, GemmPlan]):
    """The Hopper body's stages in plain PyTorch, at bf16 operands: the
    modulate pass, then the up and down GEMMs tile by tile, in the order
    each CTA of `plan` (`mlp_plan`) walks them, with the epilogues' bias,
    GELU, gate and residual; each tile sums its whole reduction (no
    split-K). Returns (out, a, mlp) as `adaln_mlp_train_reference`. fc1_w
    (H, D) and fc2_w (D, H) in torch's Linear layout."""
    f32, bf16 = torch.float32, torch.bfloat16
    n, t, d = x.shape
    hdim = fc1_w.shape[0]
    up, down = plan
    xn, _ = _layer_norm_f32(x, eps)
    h = (xn * (1.0 + scale.to(f32)[:, None, :]) + shift.to(f32)[:, None, :]).to(bf16)
    h = h.reshape(n * t, d).to(f32)

    def gemm(a, w, bias, p: GemmPlan):
        c = torch.full((n * t, p.cols), float("nan"))  # a tile no CTA computes stays NaN
        for cta in range(p.grid):
            for r0, c0 in p.tiles_of(cta):
                rows, cols = slice(r0, r0 + GEMM_ROWS), slice(c0, c0 + p.width)
                c[rows, cols] = a[rows] @ w[cols].to(bf16).to(f32).t() + bias[cols].to(f32)
        return c

    pre = gemm(h, fc1_w, b1, up)
    g = F.gelu(pre, approximate="tanh").to(bf16).to(f32)
    mlp = gemm(g, fc2_w, b2, down).reshape(n, t, d)
    out = x.to(f32) + gate.to(f32)[:, None, :] * mlp
    return out.to(x.dtype), pre.reshape(n, t, hdim).to(x.dtype), mlp


def _sum_partials(ws: torch.Tensor) -> torch.Tensor:
    """ws (O, P, C) f32 summed over P in sum_partials_kernel's order: eight
    running sums over p = k, k + 8, ..., then those eight in turn."""
    lanes = torch.zeros((8, ws.shape[0], ws.shape[2]))
    for p in range(ws.shape[1]):
        lanes[p % 8] += ws[:, p]
    total = torch.zeros_like(lanes[0])
    for k in range(8):
        total += lanes[k]
    return total


ROW_PASS_WARPS = 4  # warps of a row pass's CTA (one (n, ROW_TILE-token tile))


def _tile_partials(v: torch.Tensor) -> torch.Tensor:
    """v (N, T, C) f32 -> (N, ceil(T / ROW_TILE), C): the row passes'
    per-(n, token tile) sums. Warp w of a tile's CTA adds its rows w, w +
    ROW_PASS_WARPS, ... in turn, then the CTA adds the warps' sums in warp
    order."""
    n, t, c = v.shape
    tiles, warps = -(-t // ROW_TILE), ROW_PASS_WARPS
    rows = F.pad(v, (0, 0, 0, tiles * ROW_TILE - t)).reshape(n, tiles, ROW_TILE // warps, warps, c)
    partial = rows[:, :, 0].clone()
    for j in range(1, ROW_TILE // warps):
        partial += rows[:, :, j]
    total = partial[:, :, 0].clone()
    for w in range(1, warps):
        total += partial[:, :, w]
    return total


def _block_column_sums(v: torch.Tensor) -> torch.Tensor:
    """v (GEMM_ROWS, C) f32, one row block of a tile -> (C,): the dgelu
    epilogue's db1 partial. Consumer warp w holds rows 16 w + g + 8 i (g =
    lane / 4): its lanes add i = 0 and 1, then a shuffle tree pairs g with g
    ^ 1, ^ 2, ^ 4; the CTA adds the eight warps' sums in warp order."""
    x = v.reshape(8, 2, 8, -1)
    p = x[:, 0] + x[:, 1]  # (warp, g, C)
    for _ in range(3):  # g ^ 1, g ^ 2, g ^ 4: the lowest remaining bit of g
        p = p.reshape(8, -1, 2, p.shape[-1])
        p = p[:, :, 0] + p[:, :, 1]
    p = p.reshape(8, -1)
    total = p[0].clone()
    for w in range(1, 8):
        total += p[w]
    return total


def adaln_mlp_bwd_staged(x, shift, scale, gate, fc1_w, fc2_w, a, mlp, g, eps: float,
                         plan: tuple[GemmPlan, GemmPlan]):
    """The fused backward's Hopper body in plain PyTorch, stage by stage: the
    dmlp pass; the dgelu GEMM (bf16(dmlp) . fc2_w) tile by tile in the order
    each CTA of `plan[0]` walks them, with its epilogue (gelu(a), gelu'(a),
    da, and the per-row-block db1 partials); the dh1 GEMM (bf16(da) . fc1_w)
    by `plan[1]`; the LayerNorm-backward row pass; every sum of partials in
    the kernels' fixed order. fc1_w (H, D) and fc2_w (D, H) in torch's
    layout, read as bf16; `plan` as `mlp_bwd_plan` gives it. Returns the
    prologue's (da, gelu(a), dmlp, dgate, db1, db2) and the epilogue's (dx,
    h1, dshift, dscale), as `adaln_mlp_bwd_prologue_reference` and
    `adaln_mlp_bwd_epilogue_reference` (the epilogue on this da)."""
    f32, bf16 = torch.float32, torch.bfloat16
    n, t, d = x.shape
    hdim = fc1_w.shape[0]
    m = n * t
    stream = x.dtype
    dgelu_plan, dh1_plan = plan
    padded = -(-m // GEMM_ROWS) * GEMM_ROWS  # TMA reads rows past N*T as 0

    def rows(v):  # (N, T, C) -> (padded, C) f32
        return F.pad(v.reshape(m, -1).to(f32), (0, 0, 0, padded - m))

    def gemm(a_op, w, p: GemmPlan, epilogue):
        """A (padded, depth) . w (depth, cols), w read as bf16 in torch's
        layout; epilogue(tile, r0, c0) for each tile in each CTA's order."""
        wb = w.to(bf16).to(f32)
        for cta in range(p.grid):
            for r0, c0 in p.tiles_of(cta):
                epilogue(a_op[r0:r0 + GEMM_ROWS] @ wb[:, c0:c0 + p.width], r0, c0)

    # 1. the dmlp pass
    gf = g.to(f32)
    dmlp = gf * gate.to(f32)[:, None, :]
    dgate = _sum_partials(_tile_partials(gf * mlp.to(f32)))
    db2 = _sum_partials(_tile_partials(dmlp).reshape(1, -1, d))[0]
    dmlp = dmlp.to(stream)

    # 2. the dgelu GEMM and its epilogue (a tile no CTA computes stays NaN)
    a_rows = rows(a)
    da = torch.full((padded, hdim), float("nan"))
    gelu_out = torch.full((padded, hdim), float("nan"))
    db1_ws = torch.full((padded // GEMM_ROWS, hdim), float("nan"))

    def dgelu_epilogue(dgelu, r0, c0):
        cols = slice(c0, c0 + dgelu.shape[1])
        gl, gp = _gelu_and_grad(a_rows[r0:r0 + GEMM_ROWS, cols])
        d_tile = dgelu * gp
        d_tile[max(m - r0, 0):] = 0.0  # rows past N*T
        da[r0:r0 + GEMM_ROWS, cols] = d_tile
        gelu_out[r0:r0 + GEMM_ROWS, cols] = gl
        db1_ws[r0 // GEMM_ROWS, cols] = _block_column_sums(d_tile)

    gemm(rows(dmlp).to(bf16).to(f32), fc2_w, dgelu_plan, dgelu_epilogue)
    db1 = _sum_partials(db1_ws[None])[0]
    da = da[:m].to(stream)
    gelu_out = gelu_out[:m].reshape(n, t, hdim).to(stream)

    # 3. the dh1 GEMM, f32
    dh1 = torch.full((padded, d), float("nan"))

    def dh1_epilogue(tile, r0, c0):
        dh1[r0:r0 + GEMM_ROWS, c0:c0 + tile.shape[1]] = tile

    gemm(rows(da).to(bf16).to(f32), fc1_w, dh1_plan, dh1_epilogue)
    dh1 = dh1[:m].reshape(n, t, d)

    # 4. the row pass
    xn, inv = _layer_norm_f32(x, eps)
    scale1 = 1.0 + scale.to(f32)[:, None, :]
    h1 = xn * scale1 + shift.to(f32)[:, None, :]
    dx = gf + _layer_norm_bwd(dh1 * scale1, xn, inv)
    dshift = _sum_partials(_tile_partials(dh1))
    dscale = _sum_partials(_tile_partials(dh1 * xn))
    return (da.reshape(n, t, hdim), gelu_out, dmlp, dgate, db1, db2,
            dx.to(stream), h1.to(stream), dshift, dscale)


def adaln_mlp_quant_reference(
    x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of the int8 serving forward. w1q: (D, H), w2q: (H, D)
    int8 codes; s1: (H,), s2: (D,) their per-output-channel f32 scales.
    bfloat16: the kernel's rounding (bf16 activations times the exact codes,
    each scale applied to its f32 product); float32: the f32 MLP over the
    dequantised weights (`ops/quant.py`, dequant_matmul)."""
    f32 = torch.float32
    xn, _ = _layer_norm_f32(x, eps)
    h = xn * (1.0 + scale.to(f32)[:, None, :]) + shift.to(f32)[:, None, :]
    pre = dequant_matmul(h, w1q.t(), s1, matmul_dtype) + b1
    mlp = dequant_matmul(F.gelu(pre, approximate="tanh"), w2q.t(), s2, matmul_dtype) + b2
    return x + gate.to(f32)[:, None, :] * mlp


def adaln_mlp_quant_staged(x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, eps: float,
                           plan: tuple[GemmPlan, GemmPlan]):
    """The int8 Hopper body's stages in plain PyTorch: the modulate pass
    (h in bf16), then the up and down GEMMs tile by tile in the order each
    CTA of `plan` (`mlp_plan`) walks them, each tile's codes upcast exactly
    and its whole reduction summed before the epilogue scales it (acc * s +
    b), then GELU into bf16 g (up) or the gate and residual (down). w1q (H,
    D) and w2q (D, H) int8 codes in torch's Linear layout. Returns out as
    `adaln_mlp_quant_reference` at bf16 operands."""
    f32, bf16 = torch.float32, torch.bfloat16
    n, t, d = x.shape
    up, down = plan
    xn, _ = _layer_norm_f32(x, eps)
    h = (xn * (1.0 + scale.to(f32)[:, None, :]) + shift.to(f32)[:, None, :]).to(bf16)
    h = h.reshape(n * t, d).to(f32)

    def gemm(a, wq, s, bias, p: GemmPlan):
        c = torch.full((n * t, p.cols), float("nan"))  # a tile no CTA computes stays NaN
        for cta in range(p.grid):
            for r0, c0 in p.tiles_of(cta):
                rows, cols = slice(r0, r0 + GEMM_ROWS), slice(c0, c0 + p.width)
                c[rows, cols] = (a[rows] @ wq[cols].to(f32).t()) * s[cols] + bias[cols]
        return c

    g = F.gelu(gemm(h, w1q, s1, b1, up), approximate="tanh").to(bf16).to(f32)
    mlp = gemm(g, w2q, s2, b2, down).reshape(n, t, d)
    return x + gate.to(f32)[:, None, :] * mlp


def _mm(a: torch.Tensor, b: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """a @ b with operands rounded to `matmul_dtype` and an f32 result.

    `torch.matmul` of two bf16 tensors would round its result to bf16, not
    keep it in f32 as the JAX backward's preferred_element_type=f32 does.
    On a CUDA device bf16 operands therefore go to cuBLAS through
    `torch.mm(..., out_dtype=torch.float32)` (bf16 tensor-core products, f32
    accumulation and result); elsewhere the rounded operands are multiplied
    in f32, which computes the same function."""
    if a.is_cuda and matmul_dtype == torch.bfloat16:
        return torch.mm(a.to(matmul_dtype), b.to(matmul_dtype), out_dtype=torch.float32)
    rnd = _rounder(matmul_dtype)
    return torch.mm(rnd(a), rnd(b))


def _gelu_and_grad(af: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GELU-tanh of the f32 pre-activation and its derivative."""
    th = torch.tanh(GELU_C0 * (af + GELU_C1 * af * af * af))
    dgelu_da = 0.5 * (1.0 + th) + 0.5 * af * (1.0 - th * th) * GELU_C0 * (1.0 + 3.0 * GELU_C1 * af * af)
    return 0.5 * af * (1.0 + th), dgelu_da


def _layer_norm_bwd(dxn, xn, inv):
    """The non-affine LayerNorm's input gradient from dL/dxn."""
    return inv * (dxn - dxn.mean(dim=-1, keepdim=True) - xn * (dxn * xn).mean(dim=-1, keepdim=True))


def adaln_mlp_bwd(
    x, shift, scale, gate, fc1_w, fc2_w, a, mlp, g, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32, partial: bool = False,
):
    """The FLOP-minimal backward (JAX `_bwd`): from the residuals a and mlp,
    only the four unavoidable matmuls; LayerNorm, modulation and GELU are
    recomputed elementwise. fc1_w (H, D) and fc2_w (D, H) are torch's
    Linear weights. Returns (dx in x's type, dshift, dscale, dgate, dfc1_w,
    db1, dfc2_w, db2), the weight gradients in torch's (out, in) layout.
    `partial` (a tensor-parallel rank's share, as the forward's): dx leaves
    out the residual's g; dx, dshift, dscale and dgate are then this rank's
    partials, and db2 is b2's whole gradient on every rank."""
    f32 = torch.float32
    n, t, d = x.shape
    hdim = fc1_w.shape[0]
    g = g.to(f32)
    xn, inv = _layer_norm_f32(x, eps)
    scale1 = 1.0 + scale.to(f32)[:, None, :]
    h1 = xn * scale1 + shift.to(f32)[:, None, :]
    gelu_out, dgelu_da = _gelu_and_grad(a.to(f32))

    # out = x + gate * mlp
    dgate = (g * mlp.to(f32)).sum(dim=1)
    dmlp = (g * gate.to(f32)[:, None, :]).reshape(n * t, d)
    # mlp = gelu(a) @ w2 + b2
    db2 = dmlp.sum(dim=0)
    dfc2_w = _mm(dmlp.t(), gelu_out.reshape(n * t, hdim), matmul_dtype)
    da = _mm(dmlp, fc2_w, matmul_dtype) * dgelu_da.reshape(n * t, hdim)
    # a = h1 @ w1 + b1
    db1 = da.sum(dim=0)
    dfc1_w = _mm(da.t(), h1.reshape(n * t, d), matmul_dtype)
    dh1 = _mm(da, fc1_w, matmul_dtype).reshape(n, t, d)
    # h1 = xn * (1 + scale) + shift, then the non-affine LayerNorm
    dshift = dh1.sum(dim=1)
    dscale = (dh1 * xn).sum(dim=1)
    dx = _layer_norm_bwd(dh1 * scale1, xn, inv)
    if not partial:
        dx = g + dx
    return (dx.to(x.dtype), dshift, dscale, dgate, dfc1_w.to(fc1_w.dtype), db1,
            dfc2_w.to(fc2_w.dtype), db2)


def adaln_mlp_bwd_prologue_reference(g, mlp, a, gate, w2, matmul_dtype: torch.dtype = torch.float32):
    """Plain version of the fused backward's first stage (JAX
    `_bwd_prologue_kernel`). g: (N, T, D) upstream gradient in the stream's
    type; mlp: (N, T, D) f32 and a: (N, T, H) the forward's residuals; gate:
    (N, D); w2: (H, D). Returns (da, gelu(a) (N, T, H), dmlp (N, T, D) in g's
    type; dgate (N, D), db1 (H,), db2 (D,) f32). dgelu = dmlp @ w2^T takes
    operands rounded to `matmul_dtype` and sums in f32; GELU' comes from the
    f32 `a`; db1 sums the unrounded da."""
    f32 = torch.float32
    n, t, d = g.shape
    gf = g.to(f32)
    dmlp = gf * gate.to(f32)[:, None, :]
    dgate = (gf * mlp.to(f32)).sum(dim=1)
    dgelu = _mm(dmlp.reshape(n * t, d), w2.t(), matmul_dtype).reshape(n, t, -1)
    gelu_out, dgelu_da = _gelu_and_grad(a.to(f32))
    da = dgelu * dgelu_da
    return (da.to(g.dtype), gelu_out.to(g.dtype), dmlp.to(g.dtype), dgate, da.sum(dim=(0, 1)),
            dmlp.sum(dim=(0, 1)))


def adaln_mlp_bwd_epilogue_reference(da, x, g, shift, scale, w1, eps: float = 1e-6,
                                     matmul_dtype: torch.dtype = torch.float32,
                                     partial: bool = False):
    """Plain version of the fused backward's second stage (JAX
    `_bwd_epilogue_kernel`). da: (N, T, H) and x, g: (N, T, D) in the
    stream's type; shift/scale: (N, D); w1: (D, H). Returns (dx, h1 (N, T, D)
    in x's type; dshift, dscale (N, D) f32): dh1 = da @ w1^T (operands
    rounded to `matmul_dtype`, f32 sums), then the modulation and LayerNorm
    backward. `partial`: dx without the residual's g (a tensor-parallel
    rank's share)."""
    f32 = torch.float32
    n, t, d = x.shape
    xn, inv = _layer_norm_f32(x, eps)
    scale1 = 1.0 + scale.to(f32)[:, None, :]
    h1 = xn * scale1 + shift.to(f32)[:, None, :]
    dh1 = _mm(da.reshape(n * t, -1), w1.t(), matmul_dtype).reshape(n, t, d)
    dx = _layer_norm_bwd(dh1 * scale1, xn, inv)
    if not partial:
        dx = g.to(f32) + dx
    return dx.to(x.dtype), h1.to(x.dtype), dh1.sum(dim=1), (dh1 * xn).sum(dim=1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("adaln_mlp")
    fn = lib.adaln_mlp_fwd
    fn.restype = ctypes.c_int
    # (x, shift, scale, gate, mod_stride, w1, b1, w2, b2, h, g, out, a, mlp,
    #  n, t, d, hdim, bn_up, grid_up, bn_down, grid_down, eps, bf16, stages, partial, stream)
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fn = lib.adaln_mlp_quant_fwd
    fn.restype = ctypes.c_int
    # (x, shift, scale, gate, mod_stride, w1q, s1, b1, w2q, s2, b2, h, g, out,
    #  n, t, d, hdim, bn_up, grid_up, bn_down, grid_down, eps, stages, stream)
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.adaln_mlp_error_string.restype = ctypes.c_char_p
    lib.adaln_mlp_error_string.argtypes = [ctypes.c_int]
    lib.adaln_mlp_last_body.restype = ctypes.c_char_p
    lib.adaln_mlp_sm90_smem_bytes.restype = ctypes.c_int
    lib.adaln_mlp_sm90_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def sm90_smem_bytes(int8: bool = False) -> dict[int, int]:
    """The Hopper GEMM's dynamic shared memory per CTA, bytes, by tile width,
    over bf16 weights or (`int8`) int8 codes, whose stages also hold the
    codes."""
    return {width: _lib().adaln_mlp_sm90_smem_bytes(width, int(int8)) for width in GEMM_WIDTHS}


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("adaln_mlp_bwd")
    i, f, p, ll = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong
    # (g, mlp, a, gate, mod_stride, w2, da, gelu_out, dmlp, dgate, db1, db2,
    #  ws, n, t, d, hdim, bn, grid, stages, stream)
    lib.adaln_mlp_bwd_prologue_sm90.argtypes = [p] * 4 + [ll] + [p] * 8 + [i] * 7 + [p]
    # (da, x, g, shift, scale, mod_stride, w1, dx, h1, dshift, dscale, ws,
    #  n, t, d, hdim, bn, grid, eps, stages, stream)
    lib.adaln_mlp_bwd_epilogue_sm90.argtypes = [p] * 5 + [ll] + [p] * 6 + [i] * 6 + [f, i, p]
    # (g, mlp, a, gate, mod_stride, w2p, da, gelu_out, dmlp, dgate, db1, db2,
    #  ws, n, t, d, hdim, split, stream)
    lib.adaln_mlp_bwd_prologue_wmma.argtypes = [p] * 4 + [ll] + [p] * 8 + [i] * 5 + [p]
    # (da, x, g, shift, scale, mod_stride, w1p, dx, h1, dshift, dscale, ws,
    #  n, t, d, hdim, eps, stream)
    lib.adaln_mlp_bwd_epilogue_wmma.argtypes = [p] * 5 + [ll] + [p] * 6 + [i] * 4 + [f, p]
    for name in ("prologue_sm90", "epilogue_sm90", "prologue_wmma", "epilogue_wmma"):
        getattr(lib, f"adaln_mlp_bwd_{name}").restype = i
    lib.adaln_mlp_bwd_error_string.restype = ctypes.c_char_p
    lib.adaln_mlp_bwd_error_string.argtypes = [i]
    lib.adaln_mlp_bwd_sm90_smem_bytes.restype = i
    lib.adaln_mlp_bwd_sm90_smem_bytes.argtypes = [i]
    lib.adaln_mlp_bwd_wmma_smem_bytes.restype = i
    lib.adaln_mlp_bwd_wmma_smem_bytes.argtypes = [i, i]
    return lib


def bwd_sm90_smem_bytes() -> dict[int, int]:
    """The backward's Hopper GEMM's dynamic shared memory per CTA, bytes,
    by tile width."""
    return {width: _bwd_lib().adaln_mlp_bwd_sm90_smem_bytes(width) for width in GEMM_WIDTHS}


def bwd_wmma_smem_bytes(d: int) -> dict[str, int]:
    """The f32 stream's WMMA prologue and epilogue: dynamic shared memory
    per CTA at width D, bytes."""
    lib = _bwd_lib()
    return {stage: lib.adaln_mlp_bwd_wmma_smem_bytes(i, d) for i, stage in enumerate(("prologue", "epilogue"))}


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def hidden_split(n: int, t: int, hdim: int, sm_count: int) -> int:
    """How many CTAs share one token tile's hidden dim: the largest divisor
    of the chunk count that keeps the grid within one wave of CTAs (one per
    SM), so short sequences still fill the card. Each split adds an
    (N, T, D) f32 partial that the epilogue kernel sums."""
    chunks = hdim // HIDDEN_CHUNK
    tiles = n * -(-t // ROW_TILE)
    return max(s for s in range(1, chunks + 1) if chunks % s == 0 and (s == 1 or tiles * s <= sm_count))


def _check_widths(x, hdim: int, matmul_dtype, widths) -> None:
    """What every adaLN-MLP kernel takes: bf16 operands, D in `widths` (the
    entry's: SERVE_WIDTHS, TRAIN_WIDTHS or BWD_WIDTHS), H a multiple of
    128, an f32 or bf16 stream, N <= 65535."""
    if matmul_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes with bf16 operands; "
                         f"matmul_dtype={matmul_dtype} has no kernel")
    n, _, d = x.shape
    if d not in widths:
        raise ValueError(f"the kernel takes D in {widths}, got {d}")
    if hdim % HIDDEN_CHUNK:
        raise ValueError(f"hidden width {hdim} is not a multiple of {HIDDEN_CHUNK}")
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"x must be one of {ACT_DTYPES}, got {x.dtype}")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid limit 65535")


def _check_specs(x, expect: dict, mod_names) -> None:
    """Each `name: (tensor, dtype, shape)` of `expect` on x's device (the
    current one), of that type and shape, 16-byte aligned and contiguous;
    the `mod_names` ones may instead be row views of one modulation tensor
    (one shared row stride, a multiple of 4)."""
    mods = [expect[m][0] for m in mod_names if m in expect]
    for name, (a, dtype, shape) in expect.items():
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shape}")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name in mod_names:
            if a.stride() != mods[0].stride() or a.stride(1) != 1 or a.stride(0) % 4:
                raise ValueError(
                    f"{'/'.join(mod_names)} need one shared row stride, a multiple "
                    f"of 4, and unit column stride; {name} has {a.stride()}"
                )
        elif not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _check_mod_inputs(x, shift, scale, gate, b1, b2, hdim: int, matmul_dtype, serving: bool,
                      **weights) -> None:
    """What both forward bodies take besides the activations: `weights`
    maps each weight's name to (tensor, dtype, shape); `serving`: an
    inference forward (D in SERVE_WIDTHS; else TRAIN_WIDTHS)."""
    n, t, d = x.shape
    _check_widths(x, hdim, matmul_dtype, SERVE_WIDTHS if serving else TRAIN_WIDTHS)
    expect = {
        "x": (x, x.dtype, (n, t, d)),
        "shift": (shift, torch.float32, (n, d)),
        "scale": (scale, torch.float32, (n, d)),
        "gate": (gate, torch.float32, (n, d)),
        "b1": (b1, torch.float32, (hdim,)),
        "b2": (b2, torch.float32, (d,)),
        **weights,
    }
    _check_specs(x, expect, ("shift", "scale", "gate"))


ALL_STAGES = 7  # the Hopper body's stage mask: 1 modulate, 2 up, 4 down


def _launch(fn, x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps, matmul_dtype, residuals: bool,
            stages: int = ALL_STAGES, partial: bool = False):
    """The Hopper body on x's device: (out, a, mlp), a and mlp None without
    residuals; records the body that ran in `fn.body`. `stages` below
    ALL_STAGES runs only those kernels (a timing run; the outputs of the
    others are left unwritten); `partial` as `adaln_mlp_train`'s."""
    n, t, d = x.shape
    hdim = fc1_w.shape[0]
    _check_mod_inputs(x, shift, scale, gate, b1, b2, hdim, matmul_dtype, not residuals,
                      fc1_w=(fc1_w, torch.bfloat16, (hdim, d)),
                      fc2_w=(fc2_w, torch.bfloat16, (d, hdim)))
    up, down = mlp_plan(n, t, d, hdim, _sm_count(x.device.index))
    h = torch.empty((n * t, d), device=x.device, dtype=torch.bfloat16)
    g = torch.empty((n * t, hdim), device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    a = torch.empty((n, t, hdim), device=x.device, dtype=x.dtype) if residuals else None
    mlp = torch.empty((n, t, d), device=x.device, dtype=torch.float32) if residuals else None
    lib = _lib()
    err = lib.adaln_mlp_fwd(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), gate.data_ptr(), shift.stride(0),
        fc1_w.data_ptr(), b1.data_ptr(), fc2_w.data_ptr(), b2.data_ptr(), h.data_ptr(),
        g.data_ptr(), out.data_ptr(), a.data_ptr() if residuals else None,
        mlp.data_ptr() if residuals else None, n, t, d, hdim, up.width, up.grid, down.width,
        down.grid, eps, int(x.dtype == torch.bfloat16), stages, int(partial),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        msg = lib.adaln_mlp_error_string(err).decode()
        raise RuntimeError(f"adaln_mlp kernel launch failed: error {err} ({msg})")
    fn.body = lib.adaln_mlp_last_body().decode()
    return out, a, mlp


def _check_device(x) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no adaln_mlp for device {x.device}")


def adaln_mlp(
    x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Inference forward. x: (N, T, D) f32 or bf16; shift/scale/gate: (N, D)
    f32 (row views of one modulation tensor are fine); fc1_w (H, D), fc2_w
    (D, H): the Linear weights in torch's layout (bf16 and contiguous on the
    card); b1: (H,), b2: (D,) f32. Returns x + gate * MLP(modulate(LN(x)))
    in x's type."""
    _check_device(x)
    if x.device.type == "cpu":
        return adaln_mlp_reference(x, shift, scale, gate, fc1_w.t(), b1, fc2_w.t(), b2, eps,
                                   matmul_dtype)
    out, _, _ = _launch(adaln_mlp, x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps, matmul_dtype,
                        residuals=False)
    adaln_mlp.launches += 1
    return out


def adaln_mlp_train(
    x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.bfloat16, partial: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward, the inputs of `adaln_mlp`: (out, a (N, T, H) in
    x's type, mlp (N, T, D) f32). `partial`: one tensor-parallel rank's
    share over its hidden units (fc1_w/b1 its rows, fc2_w its columns): out
    = gate * mlp and mlp leave out b2 and the residual x, as
    `adaln_mlp_train_reference` says."""
    _check_device(x)
    if x.device.type == "cpu":
        return adaln_mlp_train_reference(x, shift, scale, gate, fc1_w.t(), b1, fc2_w.t(), b2, eps,
                                         matmul_dtype, partial)
    res = _launch(adaln_mlp_train, x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps, matmul_dtype,
                  residuals=True, partial=partial)
    adaln_mlp_train.launches += 1
    return res


def _bwd_error(lib, err: int, stage: str) -> RuntimeError:
    return RuntimeError(f"adaln_mlp_bwd_{stage} kernel launch failed: error {err} "
                        f"({lib.adaln_mlp_bwd_error_string(err).decode()})")


# the stage mask of each backward stage's Hopper body: prologue 1 the dmlp
# pass, 2 the dgelu GEMM; epilogue 1 the dh1 GEMM, 2 the row pass
BWD_ALL_STAGES = 3


def _bwd_prologue_launch(g, mlp, a, gate, fc2_w, matmul_dtype, stages: int = BWD_ALL_STAGES):
    """The prologue on g's device: bf16 stream, the Hopper body (`stages`
    below BWD_ALL_STAGES runs only those kernels: 1 the dmlp pass, 2 the
    dgelu GEMM; a timing run, the others' outputs left unwritten); f32, the
    WMMA body over the packed fc2 weight. Records the body in `.body`."""
    n, t, d = g.shape
    hdim = fc2_w.shape[1]
    _check_widths(g, hdim, matmul_dtype, BWD_WIDTHS)
    _check_specs(g, {
        "g": (g, g.dtype, (n, t, d)), "mlp": (mlp, torch.float32, (n, t, d)),
        "a": (a, g.dtype, (n, t, hdim)), "gate": (gate, torch.float32, (n, d)),
        "fc2_w": (fc2_w, torch.bfloat16, (d, hdim)),
    }, ("gate",))
    tiles = -(-t // ROW_TILE)
    da = torch.empty_like(a)
    gelu_out = torch.empty_like(a)
    dmlp = torch.empty_like(g)
    dgate = torch.empty((n, d), device=g.device, dtype=torch.float32)
    db1 = torch.empty(hdim, device=g.device, dtype=torch.float32)
    db2 = torch.empty(d, device=g.device, dtype=torch.float32)
    outs = (da.data_ptr(), gelu_out.data_ptr(), dmlp.data_ptr(), dgate.data_ptr(), db1.data_ptr(),
            db2.data_ptr())
    ins = (g.data_ptr(), mlp.data_ptr(), a.data_ptr(), gate.data_ptr(), gate.stride(0))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    sm_count = _sm_count(g.device.index)
    lib = _bwd_lib()
    if g.dtype == torch.bfloat16:
        plan = mlp_bwd_plan(n, t, d, hdim, sm_count)[0]
        ws = torch.empty(2 * n * tiles * d + -(-n * t // GEMM_ROWS) * hdim, device=g.device,
                         dtype=torch.float32)
        err = lib.adaln_mlp_bwd_prologue_sm90(*ins, fc2_w.data_ptr(), *outs, ws.data_ptr(), n, t, d,
                                              hdim, plan.width, plan.grid, stages, stream)
        body = "sm90"
    else:
        w2p = pack_w2(fc2_w.t())
        ws = torch.empty(n * tiles * (2 * d + hdim), device=g.device, dtype=torch.float32)
        err = lib.adaln_mlp_bwd_prologue_wmma(*ins, w2p.data_ptr(), *outs, ws.data_ptr(), n, t, d,
                                              hdim, hidden_split(n, t, hdim, sm_count), stream)
        body = "wmma"
    if err:
        raise _bwd_error(lib, err, "prologue")
    adaln_mlp_bwd_prologue.body = body
    return da, gelu_out, dmlp, dgate, db1, db2


def adaln_mlp_bwd_prologue(g, mlp, a, gate, fc2_w, matmul_dtype: torch.dtype = torch.bfloat16):
    """The fused backward's first stage: the inputs of
    `adaln_mlp_bwd_prologue_reference`, with fc2's weight in torch's layout
    (fc2_w (D, H), bf16 and contiguous on the card; gate may be a row view
    of the modulation tensor). Returns (da, gelu(a), dmlp, dgate, db1,
    db2)."""
    _check_device(g)
    if g.device.type == "cpu":
        return adaln_mlp_bwd_prologue_reference(g, mlp, a, gate, fc2_w.t(), matmul_dtype)
    res = _bwd_prologue_launch(g, mlp, a, gate, fc2_w, matmul_dtype)
    adaln_mlp_bwd_prologue.launches += 1
    return res


def _bwd_epilogue_launch(da, x, g, shift, scale, fc1_w, eps, matmul_dtype,
                         stages: int = BWD_ALL_STAGES, partial: bool = False):
    """The epilogue on x's device: bf16 stream, the Hopper body (`stages`: 1
    the dh1 GEMM, 2 the row pass, as `_bwd_prologue_launch`); f32, the WMMA
    body over the packed fc1 weight. Records the body in `.body`. `partial`:
    the kernels get no g (dx without the residual term)."""
    n, t, d = x.shape
    hdim = fc1_w.shape[0]
    _check_widths(x, hdim, matmul_dtype, BWD_WIDTHS)
    _check_specs(x, {
        "da": (da, x.dtype, (n, t, hdim)), "x": (x, x.dtype, (n, t, d)),
        "g": (g, x.dtype, (n, t, d)), "shift": (shift, torch.float32, (n, d)),
        "scale": (scale, torch.float32, (n, d)),
        "fc1_w": (fc1_w, torch.bfloat16, (hdim, d)),
    }, ("shift", "scale"))
    tiles = -(-t // ROW_TILE)
    dx = torch.empty_like(x)
    h1 = torch.empty_like(x)
    dshift = torch.empty((n, d), device=x.device, dtype=torch.float32)
    dscale = torch.empty((n, d), device=x.device, dtype=torch.float32)
    ins = (da.data_ptr(), x.data_ptr(), None if partial else g.data_ptr(), shift.data_ptr(),
           scale.data_ptr(), shift.stride(0))
    outs = (dx.data_ptr(), h1.data_ptr(), dshift.data_ptr(), dscale.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _bwd_lib()
    if x.dtype == torch.bfloat16:
        plan = mlp_bwd_plan(n, t, d, hdim, _sm_count(x.device.index))[1]
        # the row pass's partials, then the f32 dh1 (N*T, D)
        ws = torch.empty(2 * n * tiles * d + n * t * d, device=x.device, dtype=torch.float32)
        err = lib.adaln_mlp_bwd_epilogue_sm90(*ins, fc1_w.data_ptr(), *outs, ws.data_ptr(), n, t, d,
                                              hdim, plan.width, plan.grid, eps, stages, stream)
        body = "sm90"
    else:
        w1p = pack_w1(fc1_w.t())
        ws = torch.empty(2 * n * tiles * d, device=x.device, dtype=torch.float32)
        err = lib.adaln_mlp_bwd_epilogue_wmma(*ins, w1p.data_ptr(), *outs, ws.data_ptr(), n, t, d,
                                              hdim, eps, stream)
        body = "wmma"
    if err:
        raise _bwd_error(lib, err, "epilogue")
    adaln_mlp_bwd_epilogue.body = body
    return dx, h1, dshift, dscale


def adaln_mlp_bwd_epilogue(da, x, g, shift, scale, fc1_w, eps: float = 1e-6,
                           matmul_dtype: torch.dtype = torch.bfloat16, partial: bool = False):
    """The fused backward's second stage: the inputs of
    `adaln_mlp_bwd_epilogue_reference`, with fc1's weight in torch's layout
    (fc1_w (H, D), bf16 and contiguous on the card). Returns (dx, h1,
    dshift, dscale); `partial`: dx without the residual's g."""
    _check_device(x)
    if x.device.type == "cpu":
        return adaln_mlp_bwd_epilogue_reference(da, x, g, shift, scale, fc1_w.t(), eps, matmul_dtype,
                                                partial)
    res = _bwd_epilogue_launch(da, x, g, shift, scale, fc1_w, eps, matmul_dtype, partial=partial)
    adaln_mlp_bwd_epilogue.launches += 1
    return res


def adaln_mlp_bwd_fused(
    x, shift, scale, gate, fc1_w, fc2_w, a, mlp, g, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32, weights=None, partial: bool = False,
):
    """The fused backward (JAX `_bwd_fused_impl`), with the arguments and
    returns of `adaln_mlp_bwd` (`partial` too): the prologue stage, dfc2_w =
    dmlp^T @ gelu(a), the epilogue stage, dfc1_w = da^T @ h1. The two
    weight-gradient products stay on cuBLAS (`_mm`), as JAX leaves them to
    XLA. `weights`: the forward's (fc1_w, fc2_w) cast to `matmul_dtype`,
    contiguous and at a's hidden width (fc1_w and fc2_w then give only
    their dtypes), else fc1_w and fc2_w are cast here."""
    n, t, d = x.shape
    hdim = a.shape[-1]
    if weights is None:
        weights = (w.to(matmul_dtype).contiguous() for w in (fc1_w, fc2_w))
    w1, w2 = weights
    g = g.to(x.dtype).contiguous()
    da, gelu_out, dmlp, dgate, db1, db2 = adaln_mlp_bwd_prologue(g, mlp, a, gate, w2, matmul_dtype)
    dfc2_w = _mm(dmlp.reshape(n * t, d).t(), gelu_out.reshape(n * t, hdim), matmul_dtype)
    dx, h1, dshift, dscale = adaln_mlp_bwd_epilogue(da, x, g, shift, scale, w1, eps, matmul_dtype,
                                                    partial)
    dfc1_w = _mm(da.reshape(n * t, hdim).t(), h1.reshape(n * t, d), matmul_dtype)
    return (dx, dshift, dscale, dgate, dfc1_w.to(fc1_w.dtype), db1, dfc2_w.to(fc2_w.dtype), db2)


BWD_IMPLS = ("xla", "fused")  # AdalnMlp's backwards, under the JAX package's names


class AdalnMlp(torch.autograd.Function):
    """The MLP half of a DiT block, differentiable: the training forward
    (kernel B with residuals on the card), then `adaln_mlp_bwd`
    (`bwd_impl="xla"`, the JAX default) or `adaln_mlp_bwd_fused`
    (`"fused"`: the two backward kernels on the card). `partial`: one
    tensor-parallel rank's share over its hidden units (fc1's rows, fc2's
    columns), as `adaln_mlp_train` and `adaln_mlp_bwd` take it. A hidden
    width that is not a multiple of HIDDEN_CHUNK runs zero-padded to one
    (`pad_hidden`; the module docstring says why it is exact): the
    forward and the fused backward at the padded width, the plain backward
    at the true one; the saved `a` keeps the padded units (the plain
    backward reads its true columns), and the weight gradients come back
    at the true width.

    fc1_w (H, D) and fc2_w (D, H) are the Linear weights themselves (not a
    cached bf16 copy, which holds no autograd history): the forward casts
    them to `matmul_dtype` for the kernel and the backward returns their
    gradients. With the fused backward the forward keeps those casts in ctx
    (9.4 MB per DiT-B block in bf16), which the backward kernels read as
    they are, rather than casting again in the backward: keeping them
    against recasting is not measured."""

    @staticmethod
    def forward(ctx, x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps: float, matmul_dtype,
                bwd_impl: str = "xla", partial: bool = False):
        if bwd_impl not in BWD_IMPLS:
            raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
        _check_device(x)
        hdim = fc1_w.shape[0]
        width = padded_hidden(hdim)
        w1, b1p, w2 = (fc1_w, b1, fc2_w) if width == hdim else pad_hidden(fc1_w, b1, fc2_w, width)
        casts = ()
        if x.is_cuda:
            w1, w2 = (w.to(matmul_dtype).contiguous() for w in (w1, w2))
            out, a, mlp = adaln_mlp_train(x, shift, scale, gate, w1, b1p, w2, b2, eps, matmul_dtype,
                                          partial)
            if bwd_impl == "fused":  # the backward kernels read the same casts
                casts = (w1, w2)
        else:
            out, a, mlp = adaln_mlp_train_reference(
                x, shift, scale, gate, w1.t(), b1p, w2.t(), b2, eps, matmul_dtype, partial)
        ctx.save_for_backward(x, shift, scale, gate, fc1_w, fc2_w, b1, a, mlp, *casts)
        ctx.args = (eps, matmul_dtype, bwd_impl, partial)
        return out

    @staticmethod
    def backward(ctx, g):
        eps, matmul_dtype, bwd_impl, partial = ctx.args
        x, shift, scale, gate, fc1_w, fc2_w, b1, a, mlp, *casts = ctx.saved_tensors
        hdim, width = fc1_w.shape[0], a.shape[-1]
        if bwd_impl != "fused":
            grads = adaln_mlp_bwd(x, shift, scale, gate, fc1_w, fc2_w, a[..., :hdim], mlp, g, eps,
                                  matmul_dtype, partial)
            return (*grads, None, None, None, None)
        w1, w2 = fc1_w, fc2_w
        if width != hdim and not casts:  # the operands at the kernels' width (the card's casts already are)
            w1, _, w2 = pad_hidden(fc1_w, b1, fc2_w, width)
        dx, dshift, dscale, dgate, dw1, db1, dw2, db2 = adaln_mlp_bwd_fused(
            x, shift, scale, gate, w1, w2, a, mlp, g, eps, matmul_dtype, weights=tuple(casts) or None,
            partial=partial)
        return (dx, dshift, dscale, dgate, dw1[:hdim], db1[:hdim], dw2[:, :hdim], db2,
                None, None, None, None)


def _quant_launch(x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, eps, matmul_dtype,
                  stages: int = ALL_STAGES) -> torch.Tensor:
    """The int8 Hopper body on x's device; `stages` as `_launch`'s."""
    n, t, d = x.shape
    hdim = w1q.shape[0]
    _check_mod_inputs(x, shift, scale, gate, b1, b2, hdim, matmul_dtype, True,
                      w1q=(w1q, torch.int8, (hdim, d)), w2q=(w2q, torch.int8, (d, hdim)),
                      s1=(s1, torch.float32, (hdim,)), s2=(s2, torch.float32, (d,)))
    up, down = mlp_plan(n, t, d, hdim, _sm_count(x.device.index))
    h = torch.empty((n * t, d), device=x.device, dtype=torch.bfloat16)
    g = torch.empty((n * t, hdim), device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.adaln_mlp_quant_fwd(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), gate.data_ptr(), shift.stride(0),
        w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        h.data_ptr(), g.data_ptr(), out.data_ptr(), n, t, d, hdim, up.width, up.grid, down.width,
        down.grid, eps, stages, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        msg = lib.adaln_mlp_error_string(err).decode()
        raise RuntimeError(f"adaln_mlp_quant kernel launch failed: error {err} ({msg})")
    adaln_mlp_quant.body = lib.adaln_mlp_last_body().decode()
    return out


def adaln_mlp_quant(
    x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """int8 serving forward (inference only). x: (N, T, D) float32 (the
    serving stream; anything else raises TypeError); shift/scale/gate: (N, D)
    f32; w1q (H, D), w2q (D, H): fc1's and fc2's int8 codes in torch's
    Linear layout (contiguous on the card); s1: (H,), s2: (D,) f32 scales;
    b1: (H,), b2: (D,) f32. Returns x + gate * MLP(modulate(LN(x))) in f32."""
    if x.dtype != torch.float32:
        raise TypeError(f"adaln_mlp_quant requires float32 activations, got {x.dtype}")
    _check_device(x)
    if x.device.type == "cpu":
        return adaln_mlp_quant_reference(x, shift, scale, gate, w1q.t(), s1, b1, w2q.t(), s2, b2,
                                         eps, matmul_dtype)
    out = _quant_launch(x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, eps, matmul_dtype)
    adaln_mlp_quant.launches += 1
    return out


adaln_mlp.launches = 0
adaln_mlp_train.launches = 0
adaln_mlp_quant.launches = 0
adaln_mlp.body = adaln_mlp_train.body = adaln_mlp_quant.body = None
adaln_mlp_bwd_prologue.launches = 0
adaln_mlp_bwd_epilogue.launches = 0
adaln_mlp_bwd_prologue.body = adaln_mlp_bwd_epilogue.body = None
# the wrappers whose `.launches` count kernel launches (sampling.py adds a
# CUDA graph's captured launches to them on each replay)
WRAPPERS = (adaln_mlp, adaln_mlp_train, adaln_mlp_quant, adaln_mlp_bwd_prologue, adaln_mlp_bwd_epilogue)
