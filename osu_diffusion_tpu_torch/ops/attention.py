"""Multi-head self-attention with an optional band (port of
osu_diffusion_tpu/ops/attention.py, packed qkv layout only).

The qkv and output projections are plain `F.linear` in x's type (weights
cast at use, bias added after the product, as the JAX package casts), left
to cuBLAS as the JAX package leaves them to XLA. With a band the attention
core is `banded_attention` (the CUDA kernels on a CUDA tensor); without one
it is the plain masked softmax below.

int8 weight-only serving (`quant_scales`, with `quant_mod`): the
projection weights are int8 codes with per-output-channel scales, x is the
raw residual stream, the adaLN LayerNorm and modulation fold into the qkv
projection (`int8_modulated_matmul`) and the gate and residual into the out
projection (`int8_out_residual`), and the result is the next residual
stream. The attention core is the same, under context parallelism too;
with a band it writes o in bf16, which the out projection takes as its
operand (the contract rounds o to bf16 there first), so no f32 o is
written or cast. Under context parallelism the shard's rows of o are a
strided view of the halo-extended buffer, which is copied once (bf16) for
the out projection's GEMM.

Context parallelism (`cp`, a parallel/mesh.py `Mesh`): x holds this rank's
rows of the sequence, and the core is `context_parallel_banded_attention`
(a halo exchange with the neighbouring ranks, then the ranged kernels);
`valid_len` is then the global real length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from osu_diffusion_tpu_torch.ops.banded_attention import (  # noqa: F401 (re-export)
    banded_attention,
    banded_attention_mask,
)
from osu_diffusion_tpu_torch.ops.quant import int8_modulated_matmul, int8_out_residual
from osu_diffusion_tpu_torch.parallel.context import context_parallel_banded_attention


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Scaled dot-product attention, scores and softmax in f32, the result
    in v's type. q, k, v: (N, H, T, Dh); mask broadcastable to (T, T), True =
    allowed. Masked scores take the f32 minimum, as in the JAX package, so a
    fully masked row averages all keys."""
    f32 = torch.float32
    scores = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(f32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.to(f32), v.to(f32)).to(v.dtype)


def multi_head_attention(
    x: torch.Tensor,
    in_proj_weight: torch.Tensor,
    in_proj_bias: torch.Tensor,
    out_proj_weight: torch.Tensor,
    out_proj_bias: torch.Tensor,
    num_heads: int,
    band: int | None = None,
    valid_len: int | torch.Tensor | None = None,
    matmul_dtype: torch.dtype = torch.bfloat16,
    quant_scales: tuple[torch.Tensor, torch.Tensor] | None = None,
    quant_mod: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    cp=None,
) -> torch.Tensor:
    """Self-attention over x (N, T, D) with the torch MultiheadAttention
    packed [q|k|v] projection (in_proj_weight (3D, D)). `valid_len` masks
    keys of a padded tail (an int, or without grad a 0-d int32 tensor on
    x's device, read on the device; an int under `cp`); `matmul_dtype` is the operand type of the banded
    core (and of the int8 projections).

    int8 serving: `quant_scales` = (in_proj scale (3D,), out_proj scale
    (D,)) with int8 in_proj_weight and out_proj_weight, and `quant_mod` =
    (shift, scale, gate), each (N, D), of the attention half; x is the raw
    residual stream, and the result is x + gate * attention(modulate(LN x)).

    `cp`: the mesh of context parallelism (needs a band); x is this rank's
    sequence shard."""
    n, t, d = x.shape
    dt = x.dtype
    if quant_scales is not None:
        if quant_mod is None:
            raise ValueError("int8 serving folds the adaLN modulation into the projections: "
                             "pass quant_mod=(shift, scale, gate)")
        shift, scale, gate = quant_mod
        qkv = int8_modulated_matmul(x, shift, scale, in_proj_weight, quant_scales[0], in_proj_bias,
                                    matmul_dtype=matmul_dtype)
    else:
        qkv = F.linear(x, in_proj_weight.to(dt)) + in_proj_bias.to(dt)
    # head views of the packed projection: (N, H, T, Dh), no copy
    q, k, v = (a.view(n, t, num_heads, d // num_heads).transpose(1, 2) for a in qkv.split(d, dim=-1))
    # the int8 out projection's bf16 operand (bf16 matmuls), written by the kernel
    bf16_o = quant_scales is not None and matmul_dtype == torch.bfloat16
    out_dtype = torch.bfloat16 if bf16_o else None
    if cp is not None:
        if band is None:
            raise ValueError("context parallelism needs a band")
        o = context_parallel_banded_attention(q, k, v, band, cp, valid_len, matmul_dtype, out_dtype)
    elif band is not None:
        o = banded_attention(q, k, v, band, valid_len, matmul_dtype, out_dtype)
    else:
        mask = None if valid_len is None else torch.arange(t, device=x.device) < valid_len
        o = dot_product_attention(q, k, v, mask)
    o = o.transpose(1, 2).reshape(n, t, d)
    if quant_scales is not None:
        # under CP o is the shard's rows of the halo-extended buffer, a strided
        # view; the out projection's GEMM reads o as one matrix: one bf16 copy
        o = o.contiguous()
        return int8_out_residual(o, x, gate, out_proj_weight, quant_scales[1], out_proj_bias,
                                 matmul_dtype=matmul_dtype)
    return F.linear(o, out_proj_weight.to(dt)) + out_proj_bias.to(dt)
