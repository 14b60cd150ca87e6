"""The Hopper body of the fused adaLN-MLP backward (rows 9a/9b, bf16 stream)
on the CPU: its tile plan, and a plain staged version that walks it.

- `mlp_bwd_plan`, which sizes the body's two persistent GEMMs (dgelu: H
  columns over a depth of D, 128-wide tiles; dh1: D columns over H) on the
  card, hands every output tile to exactly one CTA, and every 128-row
  block's db1 partial is written by tiles that cover all H columns once,
  at the four kernel widths (DiT-S/B/L and DiT-XL's D; at 1152 the dh1
  GEMM's 1152 columns take 128-wide tiles), ragged T and the DiT-B
  training shape.
- `adaln_mlp_bwd_staged` (the dmlp pass, the two GEMMs tile by tile in each
  CTA's order with B in torch's layout, their epilogues with the per-row-
  block db1 partials, the row pass, every sum of partials in the kernels'
  fixed order) against the port's plain versions of the two stages at bf16
  operands, and against the outputs of the JAX `_bwd_fused_impl`'s two
  Pallas kernels (interpret mode, recorded from their `pallas_call`s, as
  tests/test_torch_mlp_bwd.py runs them), from the same numpy inputs and
  the JAX forward's residuals, in both streams.

Tolerances, as max |got - want| / max |want| per output:
- staged against the plain versions: 1e-5 in the f32 stream. Both round
  dmlp and da to bf16 operands at the same points and sum in f32; only the
  order of the sums differs (each tile's product is its own call; the
  partial sums follow the kernels' order), ~1e-7 relative. In the bf16
  stream the outputs themselves are rounded to bf16, so an f32
  reassociation can flip a rounding to the neighbouring bf16 value: one
  ulp of that element, up to 2^-7 of a max (an element in the max's
  binade; seen at D = 1024: 6.0e-3). So each element of a bf16 output may
  differ by that one ulp, and by at most 5e-3 of the max beyond it.
- staged against JAX: 1e-3 in the f32 stream and 1e-2 in the bf16 stream
  (tests/test_torch_train_ops.py's reasons: the same bf16 operands, f32
  sums in another order, LayerNorm and GELU at ulp level, each of which can
  flip a bf16 rounding of da, and bf16 outputs rounded to 2^-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_mlp as pm
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.ops.gemm_plan import GEMM_DEPTH

H100_SMS = 132
STREAMS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_PLAIN = {"f32": 1e-5, "bf16": 5e-3}
TOL_JAX = {"f32": 1e-3, "bf16": 1e-2}
PROLOGUE = ("da", "gelu_out", "dmlp", "dgate", "db1", "db2")
EPILOGUE = ("dx", "h1", "dshift", "dscale")


@pytest.fixture
def recorded_calls(monkeypatch):
    """Pallas in interpret mode; every pallas_call's outputs are appended to
    the returned list."""
    calls = []
    orig = pm.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        fn = orig(*args, **kwargs)

        def run(*inputs):
            outs = fn(*inputs)
            calls.append([np.asarray(jnp.asarray(o, jnp.float32)) for o in outs])
            return outs
        return run

    monkeypatch.setattr(pm.pl, "pallas_call", patched)
    return calls


def rel_err(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def rel_err_past_a_flip(got: torch.Tensor, want: torch.Tensor) -> float:
    """rel_err of a bf16 output, each element's difference less one bf16
    ulp of the plain value (a flipped rounding)."""
    want = want.double()
    _, exp = torch.frexp(want)  # |want| = m 2^exp, m in [0.5, 1): ulp 2^(exp - 8)
    ulp = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want), exp - 8))
    excess = ((got.double() - want).abs() - ulp).clamp(min=0)
    return float(excess.max() / max(want.abs().max(), 1e-30))


# (N, T): ragged T with N = 3 (row blocks straddle batch rows), N*T below one
# row block, a T past several row blocks, and the DiT-B training shape
PLAN_SHAPES = [(3, 50), (1, 50), (1, 757), (256, 128)]


@pytest.mark.parametrize("n,t", PLAN_SHAPES, ids=[f"n{n}_t{t}" for n, t in PLAN_SHAPES])
@pytest.mark.parametrize("d", tam.BWD_WIDTHS)
def test_bwd_plan_covers_every_tile_once(n, t, d):
    hdim = 4 * d
    dgelu, dh1 = tam.mlp_bwd_plan(n, t, d, hdim, H100_SMS)
    assert dgelu.width in tam.BWD_DGELU_WIDTHS
    blocks = -(-n * t // tam.GEMM_ROWS)
    for plan, cols, depth in ((dgelu, hdim, d), (dh1, d, hdim)):
        assert (plan.rows, plan.cols, plan.depth) == (n * t, cols, depth)
        assert plan.width in tam.GEMM_WIDTHS and cols % plan.width == 0
        assert depth % GEMM_DEPTH == 0  # whole reduction slabs of the MN-major B
        assert 1 <= plan.grid <= min(H100_SMS, plan.tiles)
        seen = [tile for cta in range(plan.grid) for tile in plan.tiles_of(cta)]
        assert len(seen) == len(set(seen)) == plan.tiles == blocks * (cols // plan.width)
        assert set(seen) == {(r, c) for r in range(0, n * t, tam.GEMM_ROWS)
                             for c in range(0, cols, plan.width)}
    # each row block's db1 partial (one workspace row of H) is written by the
    # dgelu tiles of that block, whose columns cover H once
    for r in range(0, n * t, tam.GEMM_ROWS):
        cols = sorted(c for cta in range(dgelu.grid) for rr, c in dgelu.tiles_of(cta) if rr == r)
        assert cols == list(range(0, hdim, dgelu.width))


def _inputs(n, t, d, hdim, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, t, d).astype(np.float32)
    shift, scale, gate = ((0.3 * r.randn(n, d)).astype(np.float32) for _ in range(3))
    w1 = (r.randn(d, hdim) / np.sqrt(d)).astype(np.float32)
    w2 = (r.randn(hdim, d) / np.sqrt(hdim)).astype(np.float32)
    b1, b2 = (0.1 * r.randn(hdim)).astype(np.float32), (0.1 * r.randn(d)).astype(np.float32)
    g = r.randn(n, t, d).astype(np.float32)
    return (x, shift, scale, gate, w1, b1, w2, b2), g


# (name, N, T, D, H, SMs, JAX block_t): few SMs at narrow widths, so that
# each CTA walks several tiles; then the kernel widths (DiT-XL's 1152 last) at one short row
STAGED_CASES = [
    ("t50_n3_straddle", 3, 50, 128, 512, 2, 16),
    ("below_one_row_block", 1, 50, 128, 512, 2, 16),
    ("t128", 2, 128, 128, 512, 3, 32),
    ("d384", 1, 40, 384, 1536, H100_SMS, 8),
    ("d768", 1, 24, 768, 3072, H100_SMS, 8),
    ("d1024", 1, 16, 1024, 4096, H100_SMS, 8),
    ("d1152", 1, 16, 1152, 4608, H100_SMS, 8),
]


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("n,t,d,hdim,sms,block_t", [c[1:] for c in STAGED_CASES],
                         ids=[c[0] for c in STAGED_CASES])
def test_staged_matches_plain_and_jax(recorded_calls, n, t, d, hdim, sms, block_t, stream):
    jdt, tdt = STREAMS[stream]
    args, g = _inputs(n, t, d, hdim, seed=n + t + d)
    jargs = (jnp.asarray(args[0], jdt),) + tuple(jnp.asarray(a) for a in args[1:])
    _, res = pm._fwd(*jargs, block_t, 1e-6, jnp.bfloat16, "fused")
    recorded_calls.clear()  # the forward's call
    pm._bwd_fused_impl(res, jnp.asarray(g, jdt), block_t, 1e-6, jnp.bfloat16)
    assert len(recorded_calls) == 2
    jax_pro, jax_epi = recorded_calls

    x, shift, scale, gate, w1, _, w2, _ = (torch.from_numpy(a) for a in args)
    x = x.to(tdt)
    a = torch.from_numpy(np.array(jnp.asarray(res[6], jnp.float32))).to(tdt)
    mlp = torch.from_numpy(np.array(res[7], np.float32))
    gt = torch.from_numpy(g).to(tdt)
    plan = tam.mlp_bwd_plan(n, t, d, hdim, sms)
    got = tam.adaln_mlp_bwd_staged(x, shift, scale, gate, w1.t().contiguous(), w2.t().contiguous(),
                                   a, mlp, gt, 1e-6, plan)
    plain = (tam.adaln_mlp_bwd_prologue_reference(gt, mlp, a, gate, w2, torch.bfloat16)
             + tam.adaln_mlp_bwd_epilogue_reference(got[0], x, gt, shift, scale, w1, 1e-6,
                                                    torch.bfloat16))
    jax_out = [o[:, :t] for o in jax_pro[:3]] + [jax_pro[3], jax_pro[4].reshape(hdim),
                                                  jax_pro[5].reshape(d)]
    jax_out += [o[:, :t] for o in jax_epi[:2]] + list(jax_epi[2:])
    for name, u, v, w in zip(PROLOGUE + EPILOGUE, got, plain, jax_out):
        assert u.dtype == v.dtype and u.shape == v.shape == w.shape, name
        assert torch.isfinite(u).all(), name  # a tile no CTA wrote would be NaN
        err = rel_err_past_a_flip(u, v) if u.dtype == torch.bfloat16 else rel_err(u, v.numpy())
        assert err <= TOL_PLAIN[stream], (name, err)
        assert rel_err(u, w) <= TOL_JAX[stream], (name, rel_err(u, w))


def test_staged_partial_sums_follow_the_kernels_order():
    """The staged version's sums of partials are the plain sums up to f32
    reassociation, and exactly the sequential sums on integer data (where
    every order gives the same bits)."""
    r = np.random.RandomState(0)
    v = torch.from_numpy(r.randint(-8, 8, size=(3, 50, 16)).astype(np.float32))
    assert torch.equal(tam._sum_partials(tam._tile_partials(v)), v.sum(dim=1))
    block = torch.from_numpy(r.randint(-8, 8, size=(tam.GEMM_ROWS, 16)).astype(np.float32))
    assert torch.equal(tam._block_column_sums(block), block.sum(dim=0))
    ws = torch.from_numpy(r.randn(2, 19, 5).astype(np.float32))
    lanes = [sum((ws[:, p] for p in range(k, 19, 8)), torch.zeros(2, 5)) for k in range(8)]
    assert torch.equal(tam._sum_partials(ws), sum(lanes, torch.zeros(2, 5)))
