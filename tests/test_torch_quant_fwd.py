"""The int8 serving kernels' Hopper body (rows 10 and 11) on the CPU: its
tile plans, and plain staged versions that walk them.

- `qkv_plan`, which sizes `int8_modulated_matmul`'s persistent GEMM on the
  card, hands every output tile to exactly one CTA, including a ragged last
  column block (M = 1000), at the four serving widths (DiT-S/B/L and XL),
  ragged T and the DiT-B sampling shape; `mlp_plan` sizes row 10's two GEMMs as it sizes
  row 7's (tests/test_torch_mlp_fwd.py) and is held here at the `[quant]`
  shapes of chip_smoke.py.
- `adaln_mlp_quant_staged` and `int8_modulated_matmul_staged` (the
  modulate pass, then each GEMM tile by tile in each CTA's order over the
  int8 codes upcast exactly, each scale applied to its tile's f32 sum,
  the ragged column block masked) against the port's plain versions at
  bf16 operands and at f32 (the dequantised math), and against the JAX
  kernels they replace, `pallas_mlp.adaln_mlp_quant` and
  `pallas_quant.int8_modulated_matmul`, in interpret mode (as
  tests/test_torch_quant.py runs them), from the same numpy inputs: N = 8
  and 6, ragged T, D = 384 and 768, and M = 1000 for the qkv projection.

Tolerances, as max |got - want| / max |want|:
- staged against the plain version at bf16 operands: qkv 1e-5, MLP 1e-4.
  Both round h (and, in the MLP, the GELU output g) to bf16 at the same
  points from the same f32 math, multiply the same exact codes and apply
  each scale to an f32 sum; only the order of the sums differs (each tile
  is its own product), ~1e-7 relative (seen: <= 1.8e-7 for qkv). In the
  MLP that can flip a bf16 rounding of g, which moves an output by gate *
  ulp(g) * |w2 s2|: up to a few 1e-4 of the max for |g| near 4, rare at
  ~1e-7 / 2^-8 of the elements (seen: 1.1e-5).
- staged against the JAX kernel: 1e-3, as tests/test_torch_mlp_fwd.py
  holds the bf16-weight body against JAX in the f32 stream. The same bf16
  operands and codes, but the LayerNorm (and GELU) in jnp and in torch
  differ at ulp level, which flips bf16 roundings of h (or g): one flip
  moves each output of its row by up to ulp(h) * |w s|, ~4e-4 of the max
  for |h| near 4 at D = 768 (seen: 3.8e-4; tests/test_torch_quant.py's
  1e-4 holds its narrower widths and smaller weights). JAX also applies s2
  per H block of its grid.
- staged against the f32 dequantised plain version: 5e-3, the contract's
  bf16 rounding of the activations (2^-9 relative) over K-term sums
  (tests/test_torch_quant.py's CONTRACT_TOL).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_mlp as pm
import osu_diffusion_tpu.ops.pallas_quant as pq
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.ops import quant as tq
from osu_diffusion_tpu_torch.ops.gemm_plan import GEMM_ROWS, GEMM_WIDTHS, SERVE_WIDTHS

H100_SMS = 132
TOL_PLAIN = {"qkv": 1e-5, "mlp": 1e-4}
TOL_JAX = 1e-3
TOL_F32 = 5e-3


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpret mode on the CPU."""
    for mod in (pm, pq):
        orig = mod.pl.pallas_call

        def patched(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", patched)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _covers_once(plan) -> None:
    """Every (row block, column block) tile of `plan` to exactly one CTA,
    each CTA's tiles round-robin over the grid, the last column block
    ragged where the width does not divide the columns."""
    assert plan.width in GEMM_WIDTHS
    assert 1 <= plan.grid <= min(H100_SMS, plan.tiles)
    seen = [tile for cta in range(plan.grid) for tile in plan.tiles_of(cta)]
    want = {(r, c) for r in range(0, plan.rows, GEMM_ROWS) for c in range(0, plan.cols, plan.width)}
    assert len(seen) == len(set(seen)) == plan.tiles  # no tile twice
    assert set(seen) == want  # and none left out
    per_cta = [len(plan.tiles_of(cta)) for cta in range(plan.grid)]
    assert max(per_cta) - min(per_cta) <= 1


# (N, T, D, M): the DiT-B sampling qkv (CFG batch 2, T 768 and kimi's 757),
# ragged T, the other kernel widths, and an M no tile width divides
QKV_PLAN_SHAPES = [(2, 768, 768, 2304), (2, 757, 768, 2304), (3, 50, 768, 2304),
                   (8, 128, 384, 1152), (6, 128, 1024, 3072), (2, 40, 768, 1000),
                   (1, 1, 384, 1000)]


@pytest.mark.parametrize("n,t,d,m", QKV_PLAN_SHAPES,
                         ids=[f"n{n}_t{t}_d{d}_m{m}" for n, t, d, m in QKV_PLAN_SHAPES])
def test_qkv_plan_covers_every_tile_once(n, t, d, m):
    plan = tq.qkv_plan(n, t, d, m, H100_SMS)
    assert (plan.rows, plan.cols, plan.depth) == (n * t, m, d)
    _covers_once(plan)
    # a ragged last block starts below M and reaches past it
    assert (plan.tiles_n - 1) * plan.width < m <= plan.tiles_n * plan.width


def test_qkv_plan_at_the_dit_b_sampling_shape():
    """One round of 256-wide tiles (12 row blocks x 9 column blocks on 108
    CTAs) leaves the card less idle than two rounds of 128-wide tiles."""
    plan = tq.qkv_plan(2, 768, 768, 2304, H100_SMS)
    assert (plan.width, plan.tiles, plan.grid) == (256, 108, 108)
    ragged = tq.qkv_plan(2, 40, 768, 1000, H100_SMS)
    assert ragged.tiles_n * ragged.width > 1000  # the last column block is ragged


@pytest.mark.parametrize("n,t,d", [(2, 768, 768), (2, 757, 768), (3, 50, 768), (8, 128, 384),
                                   (6, 128, 1024)])
def test_mlp_plan_covers_every_tile_at_the_quant_shapes(n, t, d):
    for plan in tam.mlp_plan(n, t, d, 4 * d, H100_SMS):
        assert plan.cols % plan.width == 0  # the MLP's GEMMs take whole column blocks
        _covers_once(plan)


def _modulated_inputs(rng, n, t, d):
    x = rng.normal(size=(n, t, d)).astype(np.float32)
    mod = (rng.normal(size=(n, 6 * d)) * 0.3).astype(np.float32)
    return x, mod


def _codes(rng, m, k):
    """(codes (M, K) int8, scale (M,)) of a seeded weight of unit-variance
    outputs, in torch's Linear layout."""
    w = torch.from_numpy((rng.normal(size=(m, k)) / np.sqrt(k)).astype(np.float32))
    return tq.quantize_weight(w)


# (N, T, D, sms): N = 8 and 6, ragged T (T not a multiple of 16 or 128), the
# two narrower kernel widths; few SMs, so that each CTA walks several tiles
MLP_CASES = [(8, 50, 384, 4), (6, 100, 768, 8), (3, 50, 768, 132)]


@pytest.mark.parametrize("n,t,d,sms", MLP_CASES, ids=[f"n{c[0]}_t{c[1]}_d{c[2]}" for c in MLP_CASES])
def test_adaln_mlp_quant_staged_matches_plain_and_jax(interpret_mode, n, t, d, sms):
    rng = np.random.default_rng(n + t + d)
    h = 4 * d
    x, mod = _modulated_inputs(rng, n, t, d)
    (w1q, s1), (w2q, s2) = _codes(rng, h, d), _codes(rng, d, h)
    b1 = torch.from_numpy((rng.normal(size=(h,)) * 0.1).astype(np.float32))
    b2 = torch.from_numpy((rng.normal(size=(d,)) * 0.1).astype(np.float32))
    tx, tmod = torch.from_numpy(x), torch.from_numpy(mod)
    shift, scale, gate = tmod[:, 3 * d:4 * d], tmod[:, 4 * d:5 * d], tmod[:, 5 * d:]
    plan = tam.mlp_plan(n, t, d, h, sms)
    got = tam.adaln_mlp_quant_staged(tx, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, 1e-6, plan)
    assert got.shape == (n, t, d) and got.dtype == torch.float32
    assert torch.isfinite(got).all()  # a tile no CTA wrote would be NaN
    args = (tx, shift, scale, gate, w1q.t(), s1, b1, w2q.t(), s2, b2, 1e-6)
    plain16 = tam.adaln_mlp_quant_reference(*args, torch.bfloat16)
    plain32 = tam.adaln_mlp_quant_reference(*args, torch.float32)
    # the wrapper on a CPU tensor takes torch's layout, as the kernel does
    assert torch.equal(tam.adaln_mlp_quant(tx, shift, scale, gate, w1q, s1, b1, w2q, s2, b2), plain16)
    jargs = [jnp.asarray(a) for a in (x, mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:])]
    pallas = pm.adaln_mlp_quant(*jargs, jnp.asarray(w1q.t().numpy()), jnp.asarray(s1.numpy()),
                                jnp.asarray(b1.numpy()), jnp.asarray(w2q.t().numpy()),
                                jnp.asarray(s2.numpy()), jnp.asarray(b2.numpy()))
    assert rel_err(got, plain16) <= TOL_PLAIN["mlp"], rel_err(got, plain16)
    assert rel_err(got, pallas) <= TOL_JAX, rel_err(got, pallas)
    assert rel_err(got, plain32) <= TOL_F32, rel_err(got, plain32)


# (N, T, D, M, sms): as above, and M = 1000 (a ragged column block at both
# tile widths), which the JAX kernel takes as one 1000-wide block
QKV_CASES = [(8, 50, 384, 1152, 4), (6, 100, 768, 1000, 8), (3, 50, 768, 2304, 132),
             (2, 40, 384, 1000, 132)]


@pytest.mark.parametrize("n,t,d,m,sms", QKV_CASES,
                         ids=[f"n{c[0]}_t{c[1]}_d{c[2]}_m{c[3]}" for c in QKV_CASES])
def test_int8_modulated_matmul_staged_matches_plain_and_jax(interpret_mode, n, t, d, m, sms):
    rng = np.random.default_rng(n * t + m)
    x, mod = _modulated_inputs(rng, n, t, d)
    wq, s = _codes(rng, m, d)
    b = torch.from_numpy((rng.normal(size=(m,)) * 0.1).astype(np.float32))
    tx, tmod = torch.from_numpy(x), torch.from_numpy(mod)
    shift, scale = tmod[:, :d], tmod[:, d:2 * d]
    plan = tq.qkv_plan(n, t, d, m, sms)
    got = tq.int8_modulated_matmul_staged(tx, shift, scale, wq, s, b, 1e-6, plan)
    assert got.shape == (n, t, m) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    args = (tx, shift, scale, wq, s, b, 1e-6)
    plain16 = tq.int8_modulated_matmul_reference(*args, torch.bfloat16)
    plain32 = tq.int8_modulated_matmul_reference(*args, torch.float32)
    pallas = pq.int8_modulated_matmul(jnp.asarray(x), jnp.asarray(mod[:, :d]),
                                      jnp.asarray(mod[:, d:2 * d]), jnp.asarray(wq.t().numpy()),
                                      jnp.asarray(s.numpy()), jnp.asarray(b.numpy()))
    assert rel_err(got, plain16) <= TOL_PLAIN["qkv"], rel_err(got, plain16)
    assert rel_err(got, pallas) <= TOL_JAX, rel_err(got, pallas)
    assert rel_err(got, plain32) <= TOL_F32, rel_err(got, plain32)


@pytest.mark.parametrize("d", SERVE_WIDTHS)
def test_staged_qkv_masks_the_ragged_block(d):
    """A ragged last column block reads codes past M as 0 and stores no
    column past M: the staged version at M = 1000 equals the first 1000
    columns of the same projection padded to whole blocks with zero rows."""
    rng = np.random.default_rng(d)
    x, mod = _modulated_inputs(rng, 2, 40, d)
    wq, s = _codes(rng, 1000, d)
    b = torch.from_numpy((rng.normal(size=(1000,)) * 0.1).astype(np.float32))
    tx, tmod = torch.from_numpy(x), torch.from_numpy(mod)
    plan = tq.qkv_plan(2, 40, d, 1000, H100_SMS)
    whole = plan.tiles_n * plan.width
    padded = plan._replace(cols=whole)
    wpad = torch.cat([wq, torch.zeros((whole - 1000, d), dtype=torch.int8)])
    spad, bpad = torch.cat([s, torch.ones(whole - 1000)]), torch.cat([b, torch.zeros(whole - 1000)])
    got = tq.int8_modulated_matmul_staged(tx, tmod[:, :d], tmod[:, d:2 * d], wq, s, b, 1e-6, plan)
    full = tq.int8_modulated_matmul_staged(tx, tmod[:, :d], tmod[:, d:2 * d], wpad, spad, bpad,
                                           1e-6, padded)
    assert torch.equal(got, full[..., :1000])
    assert (full[..., 1000:] == 0).all()  # the zero codes' columns: nothing leaks from the real ones
