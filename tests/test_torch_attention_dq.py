"""The banded-attention backward's plain versions against the JAX package's
Pallas kernels at the Hopper dq body's tiling, on the CPU.

The Hopper dq body (csrc/banded_attention_bwd.cu) walks 128-row query
blocks, derives delta = rowsum(o * do) from o and do, and reads one LSE
value a row. The JAX mode that does the same is `_banded_flash_bwd_impl`
with block 128 and `slim_stats=True` (o and the sublane-packed LSE in,
delta in-kernel), and `_ranged_bwd_impl` at block 128 for context
parallelism; both run here in interpret mode, as the JAX package's own
tests run Pallas. The port's `banded_attention_bwd_dq` / `_dkv` (and the
ranged entries) take the plain versions on CPU tensors and are given the
JAX forward's o and LSE, so both sides start from the same residuals.

Inputs are made with numpy from a seed, at Dh = 64 (the only head dim the
kernels take) with bf16 matmul operands. Tolerance, max |port - jax| / max
|jax| per gradient: 5e-3. Both sides round the same f32 values to bf16
before each product; an ulp-level difference in an f32 score, P or dS can
flip one bf16 rounding (2^-8 of a term), which stays far below what a wrong
index, mask or LSE row gives (O(1)).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_attention as pa
from osu_diffusion_tpu_torch.ops import banded_attention as tba
from osu_diffusion_tpu_torch.parallel.context import shard_bounds

TOL = 5e-3
BLOCK = 128  # the Hopper dq body's query block
DH = 64


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pa.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pa.pl, "pallas_call", patched)


def _inputs(n, h, t, seed):
    r = np.random.RandomState(seed)
    return tuple(r.randn(n, h, t, DH).astype(np.float32) for _ in range(4))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


# (T, valid_len, band): one 128-row block with T = band (the training
# shape), two blocks with a ragged tail and a band past one block, and three
# blocks with a band below one key tile
CASES = [(128, 128, 128), (256, 200, 160), (384, 370, 48)]


@pytest.mark.parametrize("t,valid,band", CASES, ids=[f"t{c[0]}_valid{c[1]}_band{c[2]}" for c in CASES])
def test_backward_matches_jax_slim_stats_at_block_128(t, valid, band):
    n, h = 1, 2
    q, k, v, do = _inputs(n, h, t, seed=t + valid + band)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse_packed = pa._banded_flash_fwd_impl(jq, jk, jv, band, BLOCK, jnp.bfloat16, valid,
                                              with_lse=True, slim_stats=True)
    want = pa._banded_flash_bwd_impl(jq, jk, jv, o, lse_packed, jdo, band, BLOCK, jnp.bfloat16,
                                     valid, slim_stats=True)
    lse = np.asarray(lse_packed)[:, 0, :t]  # every sublane holds the row's LSE
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.ascontiguousarray(lse))
    dq = tba.banded_attention_bwd_dq(tq, tk, tv, to, tlse, tdo, band, valid, torch.bfloat16)
    dk, dv = tba.banded_attention_bwd_dkv(tq, tk, tv, to, tlse, tdo, band, valid, torch.bfloat16)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _rel(got, w) <= TOL, name
    assert not dq[:, :, valid:].any()  # queries past valid_len get no gradient


# (name, T_loc, band, shard index, shards): the CP training shard's left
# edge (seq-len 512 over 2) and an interior shard with a band below a block
RANGED_CASES = [("train_left_edge", 256, 128, 0, 2), ("interior_band96", 256, 96, 1, 3)]


@pytest.mark.parametrize("name,t_loc,band,idx,p", RANGED_CASES, ids=[c[0] for c in RANGED_CASES])
def test_ranged_backward_matches_jax_at_block_128(name, t_loc, band, idx, p):
    halo = -(-band // BLOCK) * BLOCK
    bounds = shard_bounds(t_loc, halo, types.SimpleNamespace(model_rank=idx, num_model=p), None)
    q_lo, q_hi = bounds[2:]
    t = t_loc + 2 * halo
    n, h = 1, 2
    q, k, v, do = _inputs(n, h, t, seed=t + band + idx)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jb = jnp.asarray(bounds, jnp.int32)
    o, lse = pa._ranged_fwd_impl(jq, jk, jv, jb, band, BLOCK, jnp.bfloat16, with_lse=True)
    want = pa._ranged_bwd_impl(jq, jk, jv, o, lse, jdo, jb, band, BLOCK, jnp.bfloat16)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    dq = tba.banded_attention_ranged_bwd_dq(tq, tk, tv, to, tlse, tdo, band, bounds, torch.bfloat16)
    dk, dv = tba.banded_attention_ranged_bwd_dkv(tq, tk, tv, to, tlse, tdo, band, bounds, torch.bfloat16)
    rows = slice(q_lo, q_hi)  # pad query rows masked: their dq is undefined in JAX
    assert _rel(dq[:, :, rows], np.asarray(want[0])[:, :, rows]) <= TOL
    assert not dq[:, :, :q_lo].any() and not dq[:, :, q_hi:].any()
    for label, got, w in (("dk", dk, want[1]), ("dv", dv, want[2])):
        assert _rel(got, w) <= TOL, label
