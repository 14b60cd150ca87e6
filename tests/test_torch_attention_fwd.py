"""The banded-attention forward's Hopper body as an executable spec, on the
CPU.

`banded_attention_fwd_staged` (ops/banded_attention.py) walks what the
card's forward (csrc/banded_attention.cu) does for either stream type:
128-row query blocks, each block's 64-key tiles that meet its band and
valid_len (ranged: the key bounds, none for a block of pad query rows),
each 64-row half (a warpgroup) skipping the tiles outside its own rows'
band (`w_lo`/`w_hi`), and an f32 online softmax tile by tile, with q, k
and v rounded to bf16 (for an f32 input, on the chip) and P rounded to
bf16 for P.V. It is held against the port's plain version and against the
JAX package's Pallas forward at block 128 (`_banded_flash_fwd_impl`, and
`_ranged_fwd_impl` for context parallelism) in interpret mode, from the
same numpy inputs: f32 and bf16 inputs, ragged valid_len, a band that is
not a multiple of 64, T below the band, rows with no valid key, and ranged
bounds with pad query blocks; at the head dim of DiT-S/B/L (64) and, in a
few of those cases, at DiT-XL's (72: the query scaled before its rounding,
the head dim padded to 80 in a 64-column and a 16-column slab).

Tolerances:
- the LSE against the plain version: 1e-5 absolute. It involves no bf16
  rounding of P: both sides take the same f32 scores of the same bf16
  operands, and only the order of the f32 sums differs (seen: <= 5e-7).
  A wrong tile, mask or skip moves it by O(1).
- o against the plain version and against JAX: 5e-3 of max for f32
  inputs, 1e-2 for bf16 ones. The online softmax rounds P to bf16
  relative to the running row max, then rescales the sums; the plain
  version rounds it relative to the final max, JAX's kernel relative to
  its running max over 128-key blocks. So a P element may round
  differently (2^-8 relative) wherever a row's max moved after its first
  tile (seen: up to 1.9e-3 of max at the sampling shape; 1.6e-7 where each
  row sees one tile). A bf16 o is itself rounded to 2^-8 of its value, so
  one flipped rounding there is ~4e-3 of a max (chip_smoke.py's
  TRAIN_TOL_BF16 for the same reason). A wrong index or mask gives
  O(0.1-1).
- the LSE against JAX: 1e-4 absolute (ulp-level exp and log differences).
- bf16 o (the inference entry's `out_dtype` for f32 inputs): exactly
  bf16 of the f32 o.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_attention as pa
from osu_diffusion_tpu_torch.ops import banded_attention as tba
from osu_diffusion_tpu_torch.parallel.context import shard_bounds

TOL_O = {torch.float32: 5e-3, torch.bfloat16: 1e-2}
TOL_LSE = 1e-5
TOL_LSE_JAX = 1e-4
BLOCK = 128  # the Hopper forward's query block
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pa.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pa.pl, "pallas_call", patched)


def _inputs(n, h, t, seed, stream, dh=64):
    """q, k, v as numpy f32 (rounded to bf16 for the bf16 stream, so both
    packages see the same values) and as torch tensors of the stream."""
    r = np.random.RandomState(seed)
    tdt, _ = DTYPES[stream]
    arrs = [torch.from_numpy(r.randn(n, h, t, dh).astype(np.float32)).to(tdt) for _ in range(3)]
    return [a.float().numpy() for a in arrs], arrs


def _rel(got, want) -> float:
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = want.double().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check_plain(o, lse, want_o, want_lse, rows=slice(None)):
    n_h = lse.shape[0]
    lse3, want3 = lse.view(n_h, -1)[:, rows], want_lse.view(n_h, -1)[:, rows]
    has_key = want3 > -1e29
    assert (lse3 - want3).abs()[has_key].max().item() <= TOL_LSE
    assert (lse3[~has_key] < -1e29).all()
    assert _rel(o[:, :, rows].float(), want_o[:, :, rows].float()) <= TOL_O[o.dtype]


# (T, valid_len, band): the DiT-B sampling shape (kimi's 757 of 768), T not
# a tile multiple with a band below one tile, T below the band, rows with no
# valid key, and a band that is not a multiple of 64 over three blocks
CASES = [(768, 757, 128), (200, 190, 20), (50, 50, 128), (256, 60, 16), (384, 370, 100)]
XL_DH = 72  # DiT-XL's head dim, 1152 / 16


def _with_dh(cases, xl_cases, ids):
    """pytest params of `cases` at head dim 64 (ids as before) and of
    `xl_cases` at XL_DH (ids prefixed dh72_)."""
    return ([pytest.param(*c, 64, id=ids(c)) for c in cases]
            + [pytest.param(*c, XL_DH, id=f"dh{XL_DH}_{ids(c)}") for c in xl_cases])


@pytest.mark.parametrize("stream", list(DTYPES))
@pytest.mark.parametrize("t,valid,band,dh", _with_dh(CASES, [CASES[0], CASES[1], CASES[3]],
                                                      lambda c: f"t{c[0]}_valid{c[1]}_band{c[2]}"))
def test_staged_forward_matches_plain_and_jax(t, valid, band, dh, stream):
    n, h = 1, 2
    (q, k, v), (tq, tk, tv) = _inputs(n, h, t, t + valid + band, stream, dh)
    o, lse = tba.banded_attention_fwd_staged(tq, tk, tv, band, valid)
    assert o.dtype == tq.dtype and o.shape == tq.shape and lse.shape == (n * h, t)
    want_o, want_lse = tba.banded_attention_fwd_lse_reference(tq, tk, tv, band, valid, torch.bfloat16)
    _check_plain(o, lse, want_o, want_lse)
    _, jdt = DTYPES[stream]
    jo, jlse = pa._banded_flash_fwd_impl(*(jnp.asarray(a, jdt) for a in (q, k, v)), band, BLOCK,
                                         jnp.bfloat16, valid, with_lse=True)
    assert _rel(o.float(), np.asarray(jo, np.float32)) <= TOL_O[o.dtype]
    jlse = np.asarray(jlse)[:, :t]
    has_key = want_lse.numpy() > -1e29
    assert np.abs(lse.numpy() - jlse)[has_key].max() <= TOL_LSE_JAX
    if valid + band < t:  # rows whose band holds no valid key: 0, never NaN
        assert (o[:, :, valid + band:] == 0).all()


@pytest.mark.parametrize("t,valid,band", CASES[:3], ids=[f"t{c[0]}_valid{c[1]}_band{c[2]}" for c in CASES[:3]])
def test_staged_bf16_out_is_the_rounded_f32_out(t, valid, band):
    """For f32 inputs the inference entry may write o in bf16 (the int8
    block's out projection takes it so): exactly bf16 of the f32 o, as the
    kernel rounds the same f32 value from its registers."""
    _, (tq, tk, tv) = _inputs(2, 1, t, t, "f32")
    o32, lse32 = tba.banded_attention_fwd_staged(tq, tk, tv, band, valid)
    o16, lse16 = tba.banded_attention_fwd_staged(tq, tk, tv, band, valid, out_dtype=torch.bfloat16)
    assert o16.dtype == torch.bfloat16
    assert torch.equal(o16, o32.to(torch.bfloat16)) and torch.equal(lse16, lse32)
    # the wrapper on a CPU tensor: the plain version's o, rounded the same way
    got = tba.banded_attention(tq, tk, tv, band, valid, out_dtype=torch.bfloat16)
    want = tba.banded_attention_reference(tq, tk, tv, band, valid, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    with pytest.raises(ValueError):  # bf16 q writes o in its own type only
        tba.banded_attention(tq.to(torch.bfloat16), tk, tv, band, valid, out_dtype=torch.float32)


# (T_loc, band, shard index, shards, valid_len): the CP sampling shards of
# kimi (T 757 -> 768 over 2 ranks), the CP training shard's left edge, an
# interior shard with a band below two tiles
RANGED_CASES = [(384, 128, 0, 2, 757), (384, 128, 1, 2, 757), (256, 128, 0, 2, None),
                (256, 96, 1, 3, None)]


@pytest.mark.parametrize("stream", list(DTYPES))
@pytest.mark.parametrize("t_loc,band,idx,p,valid,dh",
                         _with_dh(RANGED_CASES, [RANGED_CASES[1], RANGED_CASES[3]],
                                  lambda c: f"tloc{c[0]}_band{c[1]}_shard{c[2]}of{c[3]}"))
def test_staged_ranged_forward_matches_plain_and_jax(t_loc, band, idx, p, valid, dh, stream):
    """Ranged: the rows [q_lo, q_hi) against the plain version and JAX's
    `_ranged_fwd_impl`; the pad query halves, which the kernel does not
    compute, hold 0 and an LSE of ~-1e30."""
    halo = -(-band // BLOCK) * BLOCK
    bounds = shard_bounds(t_loc, halo, types.SimpleNamespace(model_rank=idx, num_model=p), valid)
    k_lo, k_hi, q_lo, q_hi = bounds
    t = t_loc + 2 * halo
    n, h = 1, 2
    (q, k, v), (tq, tk, tv) = _inputs(n, h, t, t_loc + band + idx, stream, dh)
    o, lse = tba.banded_attention_fwd_staged(tq, tk, tv, band, bounds=bounds)
    want_o, want_lse = tba.banded_attention_fwd_lse_reference(tq, tk, tv, band, t, torch.bfloat16, bounds)
    rows = slice(q_lo, q_hi)
    _check_plain(o, lse, want_o, want_lse, rows)
    _, jdt = DTYPES[stream]
    jo, jlse = pa._ranged_fwd_impl(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bounds, jnp.int32),
                                   band, BLOCK, jnp.bfloat16, with_lse=True)
    jo = np.asarray(jo, np.float32).reshape(n, h, t, dh)
    assert _rel(o[:, :, rows].float(), jo[:, :, rows]) <= TOL_O[o.dtype]
    jlse = np.asarray(jlse).reshape(n * h, t)[:, rows]
    has_key = want_lse.view(n * h, t)[:, rows].numpy() > -1e29
    assert np.abs(lse.view(n * h, t)[:, rows].numpy() - jlse)[has_key].max() <= TOL_LSE_JAX
    for qw in range(0, t, 64):  # the pad query halves
        if qw + 64 <= q_lo or qw >= q_hi:
            assert (o[:, :, qw:qw + 64] == 0).all() and (lse.view(n, h, t)[:, :, qw:qw + 64] < -1e29).all()
