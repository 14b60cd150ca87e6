"""The yardstick's arithmetic: the H100's published peaks, a kernel's least
time, the banded attention's (query, key) pairs, and the operations of the
DiT forward and of one train step, counted from shapes.

The rows' bytes and operations follow the kernel table's arithmetic (each
input byte read once and each output byte written once, at the widths the
path serves them; two operations a multiply-add).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

F32, BF16, I8 = 4, 2, 1


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: bytes over the memory rate or
    bf16 operations over the tensor-core rate, whichever is larger."""
    return max(n_bytes / HBM_BPS, flops / BF16_FLOPS)


def pair_count(t: int, band: int, valid: int, query_valid: bool = False) -> int:
    """(query, key) pairs of one (sample, head): keys k with q - band < k <=
    q + band and k < valid (and, in the backward, queries q < valid)."""
    queries = min(t, valid) if query_valid else t
    total = 0
    for q in range(queries):
        lo, hi = max(0, q - band + 1), min(valid - 1, q + band)
        total += max(0, hi - lo + 1)
    return total


def model_dims(cfg: dict) -> tuple[int, int, int, int, int]:
    """(D, depth, heads, Dh, MLP hidden)."""
    d = cfg["hidden_size"]
    return d, cfg["depth"], cfg["num_heads"], d // cfg["num_heads"], int(d * cfg["mlp_ratio"])


def forward_flops(cfg: dict, n: int, t: int, pairs_per_head: int) -> float:
    """Operations of one DiT forward over n samples of t tokens: every
    block's qkv, out and MLP products at each token; its adaLN projection
    once a sample (on the (N, D) condition, not at the tokens); the banded
    attention's two products at each (query, key) pair; the first layer at
    each token; the timestep embedder, the final adaLN and the head."""
    d, depth, heads, dh, hdim = model_dims(cfg)
    tokens = n * t
    out = cfg["in_channels"] * (2 if cfg["learn_sigma"] else 1)
    first_in = cfg["in_channels"] * 128 + 128 + cfg["context_size"]
    block = (2 * tokens * (3 * d * d + d * d + 2 * d * hdim)
             + 2 * n * 6 * d * d
             + 4 * dh * heads * n * pairs_per_head)
    embed = 2 * tokens * first_in * d + 2 * n * (256 * d + d * d)
    head = 2 * n * 2 * d * d + 2 * tokens * d * out
    return depth * block + embed + head


def train_step_flops(cfg: dict, n: int, t: int, band: int) -> float:
    """Three forwards (the forward and the backward's two products each),
    remat's recompute not counted."""
    return 3 * forward_flops(cfg, n, t, pair_count(t, band, t))


def attn_fwd(n: int, heads: int, t: int, dh: int, band: int, valid: int, in_io: int, out_io: int,
             lse: bool) -> tuple[float, float]:
    """(bytes, operations) of one banded forward: q, k, v read (`in_io`
    bytes an element), o written (`out_io`), and in training the LSE (f32)."""
    elems = n * heads * t * dh
    extra = n * heads * t * F32 if lse else 0
    return 3 * elems * in_io + elems * out_io + extra, 4 * dh * n * heads * pair_count(t, band, valid)


def attn_bwd(n: int, heads: int, t: int, dh: int, band: int, valid: int, io: int) -> list[tuple[float, float]]:
    """(bytes, operations) of dq and of dk/dv: dq reads q, k, v, o, do and
    the LSE and writes dq; dk/dv reads the same and writes dk and dv."""
    elems = n * heads * t * dh
    lse = n * heads * t * F32
    pairs = n * heads * pair_count(t, band, valid, query_valid=True)
    return [(6 * elems * io + lse, 6 * dh * pairs), (7 * elems * io + lse, 8 * dh * pairs)]


def mlp_fwd(n: int, t: int, d: int, hdim: int, x_io: int, w_io: int, train: bool) -> tuple[float, float]:
    """(bytes, operations) of kernel B: x, the three (N, D) f32 modulation
    vectors, both weights (`w_io` bytes an element) and their f32 biases
    read; out written, and in training the residuals a (x's type) and mlp
    (f32); with int8 codes also their f32 scales."""
    tokens = n * t
    scales = (hdim + d) * F32 if w_io == I8 else 0
    read = tokens * d * x_io + 3 * n * d * F32 + 2 * d * hdim * w_io + (hdim + d) * F32 + scales
    written = tokens * d * x_io + (tokens * hdim * x_io + tokens * d * F32 if train else 0)
    return read + written, 4 * tokens * d * hdim


def int8_block(n: int, t: int, d: int, hdim: int) -> list[tuple[float, float]]:
    """(bytes, operations) of one int8 block's four dispatches (rows 13, 11,
    12, 10): the adaLN projection (silu(cond) f32, codes (6D, D), f32 scales
    and biases, (N, 6D) f32 out), the qkv projection with LayerNorm and
    modulation (x f32, shift and scale, codes (3D, D), out (N, T, 3D) f32),
    the out projection with gate and residual (o bf16, x f32, gate, codes
    (D, D), out f32), and the MLP half (kernel B over int8 codes)."""
    tokens = n * t
    return [
        (n * d * F32 + 6 * d * d * I8 + 2 * 6 * d * F32 + n * 6 * d * F32, 2 * n * d * 6 * d),
        (tokens * d * F32 + 2 * n * d * F32 + 3 * d * d * I8 + 2 * 3 * d * F32 + tokens * 3 * d * F32,
         2 * tokens * d * 3 * d),
        (tokens * d * BF16 + 2 * tokens * d * F32 + n * d * F32 + d * d * I8 + 2 * d * F32,
         2 * tokens * d * d),
        mlp_fwd(n, t, d, hdim, F32, I8, train=False),
    ]
