"""The int8 adaLN projection's Hopper bodies (row 13, `int8_matmul`) on the
CPU: its plan, and the plain staged version that walks it.

- `adaln_plan` sends few rows (and any odd M) to the skinny body
  (csrc/int8_matmul.cu) and wider batches at an even M to the int8 GEMM
  (csrc/adaln_mlp.cu). The skinny walk covers every output column of every
  row block exactly once and, in each column slab, every 64-deep K slab
  exactly once (over each m-tile's warps); its CTAs are the width the rows
  call for, two of them an SM at the main path's 1 or 2 rows wherever M /
  16 allows, and it fits shared memory. The wide walk hands every
  (128-row, width) tile to exactly one CTA.
- `int8_matmul_staged` (each CTA's column slab, the warps' partials summed
  in the kernel's fixed order, then acc * s + b and GELU-tanh) against the
  JAX kernel it replaces, `pallas_quant.int8_matmul`, in interpret mode,
  from the same numpy inputs, with and without GELU, on ragged rows and
  odd M, through both bodies and every CTA width.
- What the kernels do not take is refused without a card: by the plan
  (K, the CTA width) and by the wrapper (a bf16 stream).

Tolerances, as max |got - want| / max |want|, those of
tests/test_torch_quant.py's `_check_three_ways`:
- staged (bf16 operands) against the JAX kernel: 1e-4 (the same bf16(x)
  times the same exact codes, f32 sums in another order, ~1e-6);
- the port's f32 plain version against the jnp f32 dequantised math: 1e-5;
- either bf16-operand version against the f32 math: 5e-3 (bf16 rounding
  of x, 2^-9 relative, over K-term sums).
And staged against the port's plain version at bf16 operands: 1e-5, the
f32 summation order alone (the same products, K-term sums in another
grouping: a few ulp of a sum of K terms, ~1e-7 relative here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_quant as pq
from osu_diffusion_tpu_torch.ops import quant as tq
from osu_diffusion_tpu_torch.ops.gemm_plan import GEMM_ROWS, GEMM_WIDTHS

H100_SMS = 132
KERNEL_TOL = 1e-4
F32_TOL = 1e-5
CONTRACT_TOL = 5e-3
TOL_PLAIN = 1e-5


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


PLAN_ROWS = [1, 2, 3, 16, 17, 64, 111, 256]
# (K, M): one slab of K, the DiT-B adaLN projection, M not a multiple of
# 16, the DiT-XL adaLN projection
PLAN_SHAPES = [(64, 96), (768, 4608), (1024, 1000), (1152, 6912)]


@pytest.mark.parametrize("sms", [H100_SMS, 8])
@pytest.mark.parametrize("k,m", PLAN_SHAPES, ids=[f"k{k}_m{m}" for k, m in PLAN_SHAPES])
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_adaln_plan_covers_every_column_and_slab_once(rows, k, m, sms):
    plan = tq.adaln_plan(rows, k, m, sms)
    assert (plan.rows, plan.k, plan.m) == (rows, k, m)
    if rows > tq.SKINNY_ROWS and m % 2 == 0:
        assert plan.body == "sm90"
        gemm = plan.gemm
        assert (gemm.rows, gemm.cols, gemm.depth) == (rows, m, k) and gemm.width in GEMM_WIDTHS
        seen = [tile for cta in range(gemm.grid) for tile in gemm.tiles_of(cta)]
        want = {(r, c) for r in range(0, rows, GEMM_ROWS) for c in range(0, m, gemm.width)}
        assert len(seen) == len(set(seen)) == gemm.tiles and set(seen) == want
        assert 1 <= gemm.grid <= min(sms, gemm.tiles)
        return
    assert plan.body == "sm90_skinny" and plan.gemm is None
    assert plan.cw in tq.SKINNY_WIDTHS
    assert plan.row_block in tq.SKINNY_ROW_BLOCKS and plan.smem_bytes <= tq.SMEM_LIMIT
    # at most the fewest n8 tiles that hold the block's rows; fewer only
    # where x's K would overflow shared memory, or down to 16 rows where the
    # card holds the grid at once; and no smaller block it would hold
    rb = plan.row_block
    fewest = next(r for r in tq.SKINNY_ROW_BLOCKS if r >= min(rows, tq.SKINNY_ROW_BLOCKS[-1]))
    assert rb <= fewest
    if rb < fewest and tq.skinny_smem_bytes(k, plan.cw, 2 * rb) <= tq.SMEM_LIMIT:
        assert rb >= 16 and plan.ctas <= tq.skinny_resident(k, plan.cw, rb, sms)
    if rb > 16:
        assert plan.col_slabs * -(-rows // (rb // 2)) > tq.skinny_resident(k, plan.cw, rb // 2, sms)
    # every (row block, column) once: CTA c owns columns c * cw .. + cw
    cols = [col for c in range(plan.grid[0]) for col in range(c * plan.cw, (c + 1) * plan.cw)
            if col < m]
    assert sorted(cols) == list(range(m))
    assert plan.grid[1] * plan.row_block >= rows > (plan.grid[1] - 1) * plan.row_block
    assert plan.ctas == plan.grid[0] * plan.grid[1]
    # every slab once per column slab, over each m-tile's warps, each warp's in order
    slabs = [j for kg in range(tq.SKINNY_K_WARPS) for j in plan.warp_slabs(kg)]
    assert sorted(slabs) == list(range(k // tq.K_CHUNK))
    assert all(list(plan.warp_slabs(kg)) == sorted(plan.warp_slabs(kg))
               for kg in range(tq.SKINNY_K_WARPS))
    # CTAs no narrower than 8 rows (x, read once per CTA, within half the
    # weight's bytes); the main path's 1 or 2 rows take 16 columns, two CTAs
    # an SM wherever M / 16 allows
    assert plan.cw == tq.skinny_width(rows) >= min(8 * rows, 64)
    if rows <= 2 and -(-m // 16) >= 2 * sms:
        assert plan.cw == 16 and plan.ctas >= 2 * sms


def _inputs(rng, lead, k, m):
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    w = (rng.normal(size=(k, m)) * k ** -0.5).astype(np.float32)  # JAX's (in, out) layout
    wq, s = pq.quantize_weight(jnp.asarray(w))
    b = (rng.normal(size=(m,)) * 0.1).astype(np.float32)
    return x, wq, s, b


# (lead, K, M, sms, cw): the DiT-B main shape (one row, two); ragged rows
# and odd M through the skinny body, at every CTA width (forced where the
# plan would take another); rows past SKINNY_ROWS at an even M through the
# wide body, and at an odd M through skinny row blocks
STAGED_CASES = [
    ((2,), 768, 4608, H100_SMS, None),
    ((1,), 256, 97, 8, None),
    ((3,), 192, 131, H100_SMS, 64),
    ((5,), 256, 200, H100_SMS, 16),
    ((3, 5), 320, 77, 8, None),
    ((3, 37), 128, 96, H100_SMS, None),
    ((70,), 128, 33, 8, 32),
]


@pytest.mark.parametrize("activation", [None, "gelu_tanh"])
@pytest.mark.parametrize("lead,k,m,sms,cw", STAGED_CASES,
                         ids=[f"r{'x'.join(map(str, c[0]))}_k{c[1]}_m{c[2]}_sms{c[3]}_cw{c[4]}"
                              for c in STAGED_CASES])
def test_int8_matmul_staged_matches_jax(interpret_mode, lead, k, m, sms, cw, activation):
    rng = np.random.default_rng(sum(lead) + k + m)
    x, wq, s, b = _inputs(rng, lead, k, m)
    rows = int(np.prod(lead))
    plan = tq.adaln_plan(rows, k, m, sms, cw=cw)
    assert plan.body == ("sm90" if rows > tq.SKINNY_ROWS and m % 2 == 0 else "sm90_skinny")
    args = (torch.from_numpy(x), torch.from_numpy(np.asarray(wq).T.copy()),
            torch.from_numpy(np.array(s)), torch.from_numpy(b))
    got = tq.int8_matmul_staged(*args, activation, plan)
    assert got.shape == (*lead, m) and got.dtype == torch.float32
    assert torch.isfinite(got).all()  # a column no CTA wrote would be NaN
    pallas = pq.int8_matmul(jnp.asarray(x), wq, s, jnp.asarray(b), activation=activation)
    math = jnp.asarray(x) @ (wq.astype(jnp.float32) * s[None, :]) + b
    if activation:
        math = jax.nn.gelu(math, approximate=True)
    plain32 = tq.int8_matmul_reference(*args, activation, torch.float32)
    assert rel_err(got, pallas) <= KERNEL_TOL, rel_err(got, pallas)
    assert rel_err(plain32, math) <= F32_TOL, rel_err(plain32, math)
    assert rel_err(pallas, math) <= CONTRACT_TOL, rel_err(pallas, math)
    assert rel_err(got, math) <= CONTRACT_TOL, rel_err(got, math)


# (rows, K, M, cw): the skinny body at one and two n8 tiles (16-column
# CTAs forced at 16 rows), 16-row blocks at an odd M; the wide body
BITS_CASES = [(2, 768, 4608, None), (16, 256, 130, 16), (64, 128, 45, None), (100, 192, 256, None)]


@pytest.mark.parametrize("rows,k,m,cw", BITS_CASES,
                         ids=[f"r{c[0]}_k{c[1]}_m{c[2]}_cw{c[3]}" for c in BITS_CASES])
def test_int8_matmul_staged_matches_plain_bf16(rows, k, m, cw):
    rng = np.random.default_rng(rows * k + m)
    x, wq, s, b = _inputs(rng, (rows,), k, m)
    args = (torch.from_numpy(x), torch.from_numpy(np.asarray(wq).T.copy()),
            torch.from_numpy(np.array(s)), torch.from_numpy(b))
    plan = tq.adaln_plan(rows, k, m, H100_SMS, cw=cw)
    for act in (None, "gelu_tanh"):
        got = tq.int8_matmul_staged(*args, act, plan)
        want = tq.int8_matmul_reference(*args, act, torch.bfloat16)
        assert rel_err(got, want) <= TOL_PLAIN, (act, rel_err(got, want))


def test_int8_matmul_refusals_without_a_card():
    """What the kernels do not take is refused where no card is needed: the
    plan (which every CUDA call takes) refuses K not a multiple of 64, K
    past MAX_K and a CTA width it has no build for; the wrapper refuses a bf16 stream
    on a CPU tensor too. The CPU path stays the plain version at any K
    (the int8 model runs at hidden 32 in tests/test_torch_quant.py) and
    launches nothing."""
    g = torch.Generator().manual_seed(3)
    for k in (100, 32, tq.MAX_K + 64):
        with pytest.raises(ValueError):
            tq.adaln_plan(2, k, 32, H100_SMS)
    with pytest.raises(ValueError):
        tq.adaln_plan(2, 64, 32, H100_SMS, cw=48)
    wq, s = tq.quantize_weight(torch.randn(32, 64, generator=g))
    b = torch.zeros(32)
    before = tq.int8_matmul.launches
    with pytest.raises(TypeError):
        tq.int8_matmul(torch.randn(2, 64, generator=g).to(torch.bfloat16), wq, s, b)
    wq, s = tq.quantize_weight(torch.randn(32, 100, generator=g))
    x = torch.randn(2, 100, generator=g)
    assert torch.equal(tq.int8_matmul(x, wq, s, b),
                       tq.int8_matmul_reference(x, wq, s, b, None, torch.bfloat16))
    assert tq.int8_matmul.launches == before
