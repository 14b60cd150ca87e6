"""The Hopper body of kernel B (the bf16-weight adaLN-MLP forward) on the
CPU: its tile plan, and a plain staged version that walks that plan.

- `mlp_plan`, which sizes the two persistent GEMMs' grids on the card,
  hands every output tile of both GEMMs to exactly one CTA, at the four
  serving widths (DiT-S/B/L and XL), ragged T, N from 1 to 256 and the DiT-B sampling and
  training shapes.
- `adaln_mlp_train_staged` (modulate, then the up and down GEMMs tile by
  tile in each CTA's order, with their epilogues) against the port's plain
  version `adaln_mlp_train_reference` at bf16 operands, and its (out, a,
  mlp) against the JAX `_adaln_mlp_fwd_impl(..., with_residuals=True)`
  (Pallas in interpret mode, as the JAX package's own tests run it), from
  the same numpy inputs, in both streams (f32 and bf16 x), at small widths.

Tolerances, as max |got - want| / max |want| per output:
- staged against the plain version: 1e-5 in the f32 stream. Both round h
  and g to bf16 at the same points and sum in f32; only the summation
  order of the products differs (each tile's product is a separate call),
  ~1e-7 relative, which can flip a bf16 rounding of g (2^-8 of one of H
  terms, <= 2^-8 / H of a max) but no more. In the bf16 stream the outputs
  themselves are rounded to bf16, so an f32 reassociation can flip one
  rounding of out or a: 2^-8 of an element, 4e-3 of a max (tolerance 5e-3).
- staged against JAX: 1e-3 in the f32 stream and 1e-2 in the bf16 stream
  (tests/test_torch_train_ops.py's reasons: the same bf16 operands, f32
  sums in another order, LayerNorm and GELU at ulp level, each of which
  can flip a bf16 rounding of h or g, and bf16 outputs rounded to 2^-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_mlp as pm
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam

H100_SMS = 132
STREAMS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_PLAIN = {"f32": 1e-5, "bf16": 5e-3}
TOL_JAX = {"f32": 1e-3, "bf16": 1e-2}


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pm.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pm.pl, "pallas_call", patched)


def rel_err(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (N, T): ragged T, one row, batch up to 256, and the DiT-B sampling (CFG
# batch 2, T 768) and training (256 x 128) shapes
PLAN_SHAPES = [(1, 50), (3, 757), (256, 50), (1, 1), (2, 768), (256, 128)]


@pytest.mark.parametrize("n,t", PLAN_SHAPES, ids=[f"n{n}_t{t}" for n, t in PLAN_SHAPES])
@pytest.mark.parametrize("d", tam.SERVE_WIDTHS)
def test_plan_covers_every_tile_once(n, t, d):
    hdim = 4 * d
    plans = tam.mlp_plan(n, t, d, hdim, H100_SMS)
    for plan, cols, depth in zip(plans, (hdim, d), (d, hdim)):
        assert (plan.rows, plan.cols, plan.depth) == (n * t, cols, depth)
        assert plan.width in tam.GEMM_WIDTHS and cols % plan.width == 0
        assert 1 <= plan.grid <= min(H100_SMS, plan.tiles)
        seen = [tile for cta in range(plan.grid) for tile in plan.tiles_of(cta)]
        want = {(r, c) for r in range(0, n * t, tam.GEMM_ROWS) for c in range(0, cols, plan.width)}
        assert len(seen) == len(set(seen)) == plan.tiles  # no tile twice
        assert set(seen) == want  # and none left out
        # each CTA walks its tiles in order, round-robin over the grid
        per_cta = [len(plan.tiles_of(cta)) for cta in range(plan.grid)]
        assert max(per_cta) - min(per_cta) <= 1


def test_plan_widths_at_the_dit_b_shapes():
    """The widths the plan picks where the main paths run (DiT-B, 132 SMs):
    256-wide tiles at training, where every CTA takes many tiles; 128-wide at
    sampling, where 12 row blocks of 256-wide tiles would leave SMs idle."""
    up, down = tam.mlp_plan(256, 128, 768, 3072, H100_SMS)
    assert (up.width, up.grid, down.width, down.grid) == (256, 132, 256, 132)
    up, down = tam.mlp_plan(2, 768, 768, 3072, H100_SMS)
    assert (up.width, up.tiles, down.width, down.tiles) == (128, 288, 128, 72)
    assert (up.grid, down.grid) == (132, 72)


def _inputs(n, t, d, hdim, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, t, d).astype(np.float32)
    shift, scale, gate = ((0.3 * r.randn(n, d)).astype(np.float32) for _ in range(3))
    w1 = (r.randn(d, hdim) / np.sqrt(d)).astype(np.float32)
    w2 = (r.randn(hdim, d) / np.sqrt(hdim)).astype(np.float32)
    b1, b2 = (0.1 * r.randn(hdim)).astype(np.float32), (0.1 * r.randn(d)).astype(np.float32)
    return x, shift, scale, gate, w1, b1, w2, b2


# (N, T, D, H, SMs): small widths; few SMs, so that each CTA walks several
# tiles; a T that leaves the last 128-row block part pad
STAGED_CASES = [(2, 150, 128, 512, 2), (3, 100, 256, 512, 2)]


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("n,t,d,hdim,sms", STAGED_CASES,
                         ids=[f"n{c[0]}_t{c[1]}_d{c[2]}" for c in STAGED_CASES])
def test_staged_matches_plain_and_jax(interpret_mode, n, t, d, hdim, sms, stream):
    jdt, tdt = STREAMS[stream]
    args = _inputs(n, t, d, hdim, seed=n + t + d)
    x, shift, scale, gate, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    x = x.to(tdt)
    plan = tam.mlp_plan(n, t, d, hdim, sms)
    assert plan[0].tiles > plan[0].grid and plan[1].tiles > plan[1].grid
    fc1_w, fc2_w = w1.t().contiguous(), w2.t().contiguous()
    got = tam.adaln_mlp_train_staged(x, shift, scale, gate, fc1_w, b1, fc2_w, b2, 1e-6, plan)
    plain = tam.adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6,
                                          torch.bfloat16)
    jargs = (jnp.asarray(args[0], jdt),) + tuple(jnp.asarray(a) for a in args[1:])
    jax_out = pm._adaln_mlp_fwd_impl(*jargs, 16, 1e-6, jnp.bfloat16, with_residuals=True)
    for name, u, v, w in zip(("out", "a", "mlp"), got, plain, jax_out):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.isfinite(u).all(), name  # a tile no CTA wrote would be NaN
        assert rel_err(u, v.float().numpy()) <= TOL_PLAIN[stream], name
        assert rel_err(u, np.asarray(jnp.asarray(w, jnp.float32))) <= TOL_JAX[stream], name
