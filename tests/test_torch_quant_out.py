"""The int8 out projection's Hopper body (row 12: the adaLN-MLP's
persistent GEMM over int8 codes, csrc/adaln_mlp.cu `int8_out_residual_fwd`)
on the CPU: its tile plan, and a plain staged version that walks it.

- `out_plan` hands every (128-row, width) output tile to exactly one CTA,
  whole column blocks only (the epilogue reads res and gate a column pair
  at a time up to D), for D in {384, 768, 1024}, T = 50 with N = 3 (128-row
  blocks that span two batch rows) and T = 757.
- `int8_out_residual_staged` (the GEMM tile by tile in each CTA's order,
  bf16(o) times the exact codes, the scale and bias on each tile's f32 sum,
  then res + gate[row / T] * y) against the port's plain version at bf16
  operands and against the JAX kernel it replaces,
  `pallas_quant.int8_out_residual`, in interpret mode, from the same numpy
  inputs. A bf16 o (what the banded attention writes for the int8 block)
  and the f32 o it was rounded from give the same result.

Tolerances, as max |got - want| / max |want|:
- staged against the plain version at bf16 operands: 1e-5. Both multiply
  the same bf16(o) by the same exact codes and scale f32 sums; only the
  order of the sums differs (~1e-7 relative).
- staged against the JAX kernel: 1e-3, as tests/test_torch_quant_fwd.py:
  the same bf16 operands and codes, sums in other orders, the gate and
  residual in f32 on both sides.
- staged against the f32 dequantised plain version: 5e-3, the contract's
  bf16 rounding of o (2^-9 relative) over D-term sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_quant as pq
from osu_diffusion_tpu_torch.ops import quant as tq
from osu_diffusion_tpu_torch.ops.gemm_plan import GEMM_ROWS, GEMM_WIDTHS, SERVE_WIDTHS

H100_SMS = 132
TOL_PLAIN = 1e-5
TOL_JAX = 1e-3
TOL_F32 = 5e-3


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpret mode on the CPU."""
    orig = pq.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pq.pl, "pallas_call", patched)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (N, T): T = 50 with N = 3 (row blocks spanning two batch rows), the DiT-B
# sampling rows (CFG batch 2, kimi's 757)
PLAN_SHAPES = [(3, 50), (2, 757)]


@pytest.mark.parametrize("d", SERVE_WIDTHS)
@pytest.mark.parametrize("n,t", PLAN_SHAPES, ids=[f"n{n}_t{t}" for n, t in PLAN_SHAPES])
def test_out_plan_covers_every_tile_once(n, t, d):
    plan = tq.out_plan(n, t, d, H100_SMS)
    assert (plan.rows, plan.cols, plan.depth) == (n * t, d, d)
    assert plan.width in GEMM_WIDTHS and d % plan.width == 0  # whole column blocks
    assert 1 <= plan.grid <= min(H100_SMS, plan.tiles)
    seen = [tile for cta in range(plan.grid) for tile in plan.tiles_of(cta)]
    want = {(r, c) for r in range(0, n * t, GEMM_ROWS) for c in range(0, d, plan.width)}
    assert len(seen) == len(set(seen)) == plan.tiles and set(seen) == want
    per_cta = [len(plan.tiles_of(cta)) for cta in range(plan.grid)]
    assert max(per_cta) - min(per_cta) <= 1


def _inputs(rng, n, t, d):
    o = rng.normal(size=(n, t, d)).astype(np.float32)
    res = rng.normal(size=(n, t, d)).astype(np.float32)
    gate = (rng.normal(size=(n, 6 * d)) * 0.3).astype(np.float32)[:, 2 * d:3 * d]  # a row view
    w = torch.from_numpy((rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32))
    wq, s = tq.quantize_weight(w)
    b = torch.from_numpy((rng.normal(size=(d,)) * 0.1).astype(np.float32))
    return o, res, gate, wq, s, b


# (N, T, D, sms): N = 3 at T = 50 (row blocks spanning batch rows) at each
# kernel width, the DiT-B sampling rows; few SMs, so each CTA walks several tiles
CASES = [(3, 50, 384, 4), (3, 50, 768, 132), (3, 50, 1024, 8), (2, 757, 768, 16)]


@pytest.mark.parametrize("n,t,d,sms", CASES, ids=[f"n{c[0]}_t{c[1]}_d{c[2]}_sms{c[3]}" for c in CASES])
def test_int8_out_residual_staged_matches_plain_and_jax(interpret_mode, n, t, d, sms):
    rng = np.random.default_rng(n * t + d)
    o, res, gate, wq, s, b = _inputs(rng, n, t, d)
    to, tres = torch.from_numpy(o), torch.from_numpy(res)
    tgate = torch.from_numpy(np.ascontiguousarray(gate))
    plan = tq.out_plan(n, t, d, sms)
    got = tq.int8_out_residual_staged(to, tres, tgate, wq, s, b, plan)
    assert got.shape == (n, t, d) and got.dtype == torch.float32
    assert torch.isfinite(got).all()  # a tile no CTA wrote would be NaN
    args = (to, tres, tgate, wq, s, b)
    plain16 = tq.int8_out_residual_reference(*args, matmul_dtype=torch.bfloat16)
    plain32 = tq.int8_out_residual_reference(*args, matmul_dtype=torch.float32)
    pallas = pq.int8_out_residual(jnp.asarray(o), jnp.asarray(res), jnp.asarray(gate),
                                  jnp.asarray(wq.t().numpy()), jnp.asarray(s.numpy()),
                                  jnp.asarray(b.numpy()))
    assert rel_err(got, plain16) <= TOL_PLAIN, rel_err(got, plain16)
    assert rel_err(got, pallas) <= TOL_JAX, rel_err(got, pallas)
    assert rel_err(got, plain32) <= TOL_F32, rel_err(got, plain32)


@pytest.mark.parametrize("n,t,d", [(3, 50, 384), (2, 757, 768)])
def test_bf16_o_and_f32_o_give_the_same_result(n, t, d):
    """The kernel's A operand is bf16(o): a bf16 o from the banded attention
    and the f32 o it rounds give the same bits, in the staged version, the
    plain version and the wrapper on a CPU tensor (which launches
    nothing and copies nothing)."""
    rng = np.random.default_rng(d + t)
    o, res, gate, wq, s, b = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in _inputs(rng, n, t, d))
    o16 = o.to(torch.bfloat16)
    plan = tq.out_plan(n, t, d, H100_SMS)
    assert torch.equal(tq.int8_out_residual_staged(o16, res, gate, wq, s, b, plan),
                       tq.int8_out_residual_staged(o, res, gate, wq, s, b, plan))
    want = tq.int8_out_residual_reference(o, res, gate, wq, s, b, torch.bfloat16)
    assert torch.equal(tq.int8_out_residual_reference(o16, res, gate, wq, s, b, torch.bfloat16), want)
    counts = (tq.int8_out_residual.launches, tq.int8_out_residual.o_casts)
    assert torch.equal(tq.int8_out_residual(o16, res, gate, wq, s, b), want)
    assert torch.equal(tq.int8_out_residual(o, res, gate, wq, s, b), want)
    assert (tq.int8_out_residual.launches, tq.int8_out_residual.o_casts) == counts
    with pytest.raises(TypeError):  # the residual stream is f32
        tq.int8_out_residual(o16, res.to(torch.bfloat16), gate, wq, s, b)
