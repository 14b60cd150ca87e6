"""The scale-folding identity the bf16 Hopper attention bodies rest on.

The precision contract (JAX `osu_diffusion_tpu/ops/pallas_attention.py`,
the port's `banded_attention_*_reference`) rounds q * Dh^-1/2 to bf16 before
the score product, and the dk product takes that rounded q too. For
Dh = 64 the scale 1/8 is a power of two, so bf16(q / 8) = bf16(q) / 8
exactly and every f32 product and partial sum scales exactly: the Dh 64
kernels feed raw q through TMA and scale S (forward) or dK (backward) in
f32 with the same bits. At Dh = 72 (DiT-XL) the scale is no power of two
and the identity fails, so the forward body's Dh 72 build scales q in f32
and rounds it before the first product (csrc/banded_attention.cu, the
scale folding note), and the backward takes Dh 64 only
(csrc/banded_attention_bwd.cu's static_assert).

The f32 sums here run in one fixed order (a loop over the head dim of
elementwise products and adds, no BLAS), so "the same bits" is a property
of the arithmetic, not of a library's blocking. Runs on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from osu_diffusion_tpu_torch.ops import banded_attention as tba

BF16 = torch.bfloat16


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(BF16).to(torch.float32)


def _dot_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, D) . b (N, D)^T in f32, summed over D in order."""
    acc = torch.zeros(a.shape[0], b.shape[0])
    for d in range(a.shape[1]):
        acc = acc + a[:, d, None] * b[None, :, d]
    return acc


def _inputs(seed: int, rows: int, dh: int):
    rng = np.random.default_rng(seed)
    q, k, ds = (torch.from_numpy(rng.standard_normal((rows, dh)).astype(np.float32) * 3)
                for _ in range(3))
    return q, k, ds


@pytest.mark.parametrize("seed,rows", [(0, 64), (1, 128), (2, 200)])
def test_scores_fold_the_scale_exactly_at_head_dim_64(seed, rows):
    """bf16(q * scale) . bf16(k) == (bf16(q) . bf16(k)) * scale, bit for bit,
    and the port's plain version computes the former."""
    q, k, _ = _inputs(seed, rows, 64)
    scale = 1.0 / math.sqrt(64)
    contract = _dot_rows(_bf16(q * scale), _bf16(k))
    folded = _dot_rows(_bf16(q), _bf16(k)) * scale
    assert torch.equal(contract, folded)
    assert torch.equal(_bf16(q * scale), _bf16(q) * scale)
    scores, qs = tba._scores(q[None, None], k[None, None], BF16)
    assert torch.equal(qs[0, 0], _bf16(q) * scale)  # the plain version's rounded q is folded q
    assert torch.allclose(scores[0, 0], folded, rtol=1e-6, atol=1e-5)  # its BLAS sums in another order


@pytest.mark.parametrize("seed,rows", [(3, 64), (4, 128), (5, 200)])
def test_dk_folds_the_scale_exactly_at_head_dim_64(seed, rows):
    """dK = bf16(dS)^T . bf16(q * scale) == scale * (bf16(dS)^T . bf16(q)),
    bit for bit: the dk/dv body scales dK once at the end."""
    q, _, ds = _inputs(seed, rows, 64)
    scale = 1.0 / math.sqrt(64)
    # dK[key, d] = sum_query dS[query, key] q[query, d]: the transposed operands
    contract = _dot_rows(_bf16(ds).T.contiguous(), _bf16(q * scale).T.contiguous())
    folded = _dot_rows(_bf16(ds).T.contiguous(), _bf16(q).T.contiguous()) * scale
    assert torch.equal(contract, folded)


@pytest.mark.parametrize("seed", [6, 7])
def test_scale_folding_fails_at_head_dim_72(seed):
    """At Dh = 72 (DiT-XL) the scale is no power of two: rounding q * scale
    to bf16 is not bf16(q) * scale, and the scores move, so the kernels'
    static_assert(DH == 64) guards a real condition."""
    q, k, _ = _inputs(seed, 128, 72)
    scale = 1.0 / math.sqrt(72)
    assert not torch.equal(_bf16(q * scale), _bf16(q) * scale)
    contract = _dot_rows(_bf16(q * scale), _bf16(k))
    folded = _dot_rows(_bf16(q), _bf16(k)) * scale
    assert not torch.equal(contract, folded)
    # the same order of magnitude as the bf16 rounding of one operand, 2^-9
    rel = ((contract - folded).abs().max() / folded.abs().max()).item()
    assert 0 < rel < 2 ** -6
