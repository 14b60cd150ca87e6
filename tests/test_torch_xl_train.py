"""DiT-XL training in the PyTorch port against the JAX package, on the CPU,
at XL widths (hidden 1152, 16 heads of 72, MLP 4608) with the depth cut to
1, inputs and draws made with numpy from a seed (or by jax.random on the
JAX side and handed over as arrays). The model comparisons are
tests/test_torch_train.py's (T 32, batch 2-3, 7 classes), run at these
widths.

- Rows 2-4 at head dim 72 alone: the port's plain versions of the forward
  with LSE, dq and dk/dv (what the wrappers run on CPU tensors) against the
  JAX package's `_fwd` and `_bwd` (`pallas_attention.py`, the training
  path's custom VJP) at the Hopper bodies' 128-row block, in interpret
  mode, each side from its own forward and the backward from JAX's o and
  LSE. Tolerance, max |port - jax| / max |jax| per output:
  tests/test_torch_attention_dq.py's 5e-3 (both round the same f32 values
  to bf16 before each product; an ulp-level difference can flip one
  rounding, 2^-8 of a term); the LSE 1e-3 absolute (f32 from the same
  bf16 operands, sums in another order).
- The DiT's loss and every parameter gradient in training mode (remat,
  `mlp_bwd="xla"`, band = T), in the f32 and the bf16 stream, JAX on its
  Pallas path in interpret mode: tests/test_torch_train.py's
  `test_dit_loss_and_grads_match_jax` tolerances for the Pallas path (5e-3
  of each tensor's max in the f32 stream, 5e-2 in the bf16 stream, which is
  compared under the MSE loss).
- The same with the MLP's fused backward on both sides (rows 9a/9b at D
  1152: JAX's `_bwd_fused_impl` Pallas kernels, the port's plain
  versions), at the same tolerances.
- Rows 5 (with LSE) and 6 at head dim 72 alone, bf16 operands: the port's
  ranged plain versions against JAX's `_ranged_fwd_impl` and
  `_ranged_bwd_impl` (the backward from JAX's o and LSE) on the CP training
  shard (band 128, halo 128) at its left edge, an interior shard and the
  right edge with a padded tail, at the unranged rows' tolerances.
- The train CLI's argument path at `--model DiT-XL` with `--mlp-bwd fused`,
  `--num-model 2 --context-parallel` or both reaches the training loop.
- Two full AdamW + EMA train steps of `train_step` against JAX
  `make_train_step`, as tests/test_torch_train.py's
  `test_two_train_steps_match_jax` and at its tolerances: f32 stream,
  band = T through the plain banded-attention Function against JAX's dense
  band mask, JAX's draws fed to the port, EMA decay 0.5, and both sides'
  AdamW eps 1e-3 where that test takes 1e-4 (its reason, scaled to XL's
  widths: where a weight's gradient is a near-zero sum of cancelling terms,
  the update g / (|g| + eps) turns on f32 summation order, and sums over
  1152-wide rows carry ~9x the terms of its 128: at eps 1e-4 one weight of
  the final layer's 4608 landed 8.4e-6 off, every other within 5e-6; at
  1e-3 every weight within 9e-7).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _check_loss_and_grads, _check_two_train_steps, interpret_mode  # noqa: F401

import osu_diffusion_tpu.ops.pallas_attention as pa
from osu_diffusion_tpu_torch.ops import banded_attention as tba

HIDDEN, HEADS = 1152, 16  # DiT-XL's widths
DH = HIDDEN // HEADS
BLOCK = 128  # the Hopper bodies' query block
ATTN_TOL = 5e-3
LSE_TOL = 1e-3


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


# (T, valid_len, band): the training window (T = band = 128, one block) and
# two blocks with a ragged tail and a band below one block
ATTN_CASES = [(128, 128, 128), (200, 190, 48)]


@pytest.mark.parametrize("t,valid,band", ATTN_CASES, ids=[f"t{c[0]}_valid{c[1]}_band{c[2]}" for c in ATTN_CASES])
def test_attention_training_rows_at_head_dim_72_match_jax(interpret_mode, t, valid, band):
    """Row 2 (o and the LSE) and rows 3/4 (dq, dk, dv) at Dh 72 with bf16
    operands: the port's plain versions against JAX's `_fwd`/`_bwd`."""
    n, h = 1, 2
    r = np.random.RandomState(t + band)
    q, k, v, do = (r.randn(n, h, t, DH).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    valid_j = jnp.asarray(valid, jnp.int32)
    o, res = pa._fwd(jq, jk, jv, valid_j, band, BLOCK, jnp.bfloat16, True)
    want_d = pa._bwd(band, BLOCK, jnp.bfloat16, True, res, jdo)[:3]
    lse = np.asarray(res[4])[:, 0, :t]  # every sublane holds the row's LSE
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    got_o, got_lse = tba.banded_attention_fwd_lse(tq, tk, tv, band, valid, torch.bfloat16)
    assert got_o.shape == (n, h, t, DH)
    assert _rel(got_o, o) <= ATTN_TOL
    keyed = lse > -1e29  # rows whose band holds a valid key
    assert np.abs(got_lse.numpy()[keyed] - lse[keyed]).max() <= LSE_TOL
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.ascontiguousarray(lse))
    dq = tba.banded_attention_bwd_dq(tq, tk, tv, to, tlse, tdo, band, valid, torch.bfloat16)
    dk, dv = tba.banded_attention_bwd_dkv(tq, tk, tv, to, tlse, tdo, band, valid, torch.bfloat16)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want_d):
        assert _rel(got, w) <= ATTN_TOL, name
    assert not dq[:, :, valid:].any()  # queries past valid_len get no gradient


XL_WIDTHS = dict(hidden=HIDDEN, depth=1, heads=HEADS)  # DiT-XL's widths, depth cut to 1


@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_xl_loss_and_grads_match_jax(interpret_mode, stream):
    """The DiT's loss and every parameter gradient at XL widths on the
    Pallas path (the kernels' bf16 operands on both sides; the port's plain
    versions), train=True with remat, band = T: tests/test_torch_train.py's
    comparison and tolerances."""
    _check_loss_and_grads("pallas", stream, **XL_WIDTHS)


def test_two_xl_train_steps_match_jax():
    """Two AdamW + EMA steps at XL widths against `make_train_step`:
    tests/test_torch_train.py's comparison and tolerances, both sides'
    AdamW eps 1e-3 (the module docstring says why)."""
    _check_two_train_steps(eps=1e-3, **XL_WIDTHS)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_xl_loss_and_grads_with_fused_mlp_bwd_match_jax(interpret_mode, stream):
    """The same comparison with the MLP's fused backward on both sides (JAX
    `DiTConfig.mlp_bwd="fused"`, whose `_bwd_fused_impl` runs its two Pallas
    kernels at D 1152; the port's `DiT(mlp_bwd="fused")`, rows 9a/9b's plain
    versions): tests/test_torch_train.py's fused-path tolerances."""
    _check_loss_and_grads("fused", stream, **XL_WIDTHS)


# (name, T_loc, shard index, shards, valid_len) of the CP training shard at
# band 128 (halo 128): the left edge, an interior shard and the right edge
# with a padded tail inside it
RANGED_XL_CASES = [("left_edge", 256, 0, 2, None), ("interior", 256, 1, 3, None),
                   ("right_edge_tail", 256, 1, 2, 380)]
RANGED_BAND = 128


@pytest.mark.parametrize("t_loc,idx,p,valid", [c[1:] for c in RANGED_XL_CASES], ids=[c[0] for c in RANGED_XL_CASES])
def test_ranged_rows_at_head_dim_72_match_jax(interpret_mode, t_loc, idx, p, valid):
    """Rows 5 (with LSE) and 6 at Dh 72 with bf16 operands (XL under context
    parallelism): the port's ranged plain versions against JAX's
    `_ranged_fwd_impl` and `_ranged_bwd_impl` (the `banded_flash_attention_ranged`
    VJP's halves), the backward from JAX's o and LSE, at the unranged rows'
    tolerances above: o, the LSE and dq on the rows [q_lo, q_hi) (dq 0 on the
    pad rows), dk and dv on every row (0 on masked keys)."""
    from osu_diffusion_tpu_torch.parallel.context import shard_bounds

    halo = RANGED_BAND
    bounds = shard_bounds(t_loc, halo, types.SimpleNamespace(model_rank=idx, num_model=p), valid)
    k_lo, k_hi, q_lo, q_hi = bounds
    t = t_loc + 2 * halo
    n, h = 1, 2
    r = np.random.RandomState(t_loc + idx + p)
    q, k, v, g = (r.randn(n, h, t, DH).astype(np.float32) for _ in range(4))
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jb = jnp.asarray(bounds, jnp.int32)
    o, lse = pa._ranged_fwd_impl(jq, jk, jv, jb, RANGED_BAND, BLOCK, jnp.bfloat16, with_lse=True)
    want_d = pa._ranged_bwd_impl(jq, jk, jv, o, lse, jg, jb, RANGED_BAND, BLOCK, jnp.bfloat16)
    o, lse = np.array(o), np.array(lse)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    got_o, got_lse = tba.banded_attention_ranged_fwd_lse(tq, tk, tv, RANGED_BAND, bounds, torch.bfloat16)
    rows = slice(q_lo, q_hi)
    assert _rel(got_o[:, :, rows], o[:, :, rows]) <= ATTN_TOL
    keyed = lse[:, rows] > -1e29
    assert keyed.any()
    assert np.abs(got_lse[:, rows].numpy()[keyed] - lse[:, rows][keyed]).max() <= LSE_TOL
    to, tlse = torch.from_numpy(o), torch.from_numpy(lse)
    dq = tba.banded_attention_ranged_bwd_dq(tq, tk, tv, to, tlse, tg, RANGED_BAND, bounds, torch.bfloat16)
    dk, dv = tba.banded_attention_ranged_bwd_dkv(tq, tk, tv, to, tlse, tg, RANGED_BAND, bounds, torch.bfloat16)
    want_d = [np.asarray(a) for a in want_d]
    assert _rel(dq[:, :, rows], want_d[0][:, :, rows]) <= ATTN_TOL
    assert not dq[:, :, :q_lo].any() and not dq[:, :, q_hi:].any()
    for name, got, w in (("dk", dk, want_d[1]), ("dv", dv, want_d[2])):
        assert _rel(got, w) <= ATTN_TOL, name
    assert not dk[:, :, :k_lo].any() and not dv[:, :, max(k_lo, k_hi):].any()


CP_FLAGS = ["--num-model", "2", "--context-parallel", "--seq-len", "512", "--band", "128"]


@pytest.mark.parametrize("flags", [["--mlp-bwd", "fused"], CP_FLAGS, ["--mlp-bwd", "fused", *CP_FLAGS]],
                         ids=["mlp_bwd_fused", "context_parallel", "both"])
def test_train_cli_takes_xl_paths(tmp_path, monkeypatch, flags):
    """`--model DiT-XL` with --mlp-bwd fused, --num-model 2
    --context-parallel or both: the train CLI's argument path reaches the
    training loop with those settings (the loop and the process group
    replaced here: the card runs them, chip_smoke.py [xl-train-fused] and
    [xl-train-cp])."""
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.train import trainer

    reached = []
    monkeypatch.setattr(trainer, "_join_process_group", lambda config: (torch.device(config.device), False))
    monkeypatch.setattr(trainer, "_train", lambda config, band, device: reached.append((config, band)) or {})
    args = build_train_parser().parse_args(["--data-path", str(tmp_path), "--model", "DiT-XL", "--device", "cpu",
                                            "--results-dir", str(tmp_path / "results"), *flags])
    train_main(args)
    (config, band), = reached
    assert config.model == "DiT-XL"
    assert config.mlp_bwd == ("fused" if "fused" in flags else "xla")
    assert config.num_model == (2 if "--context-parallel" in flags else 1)
    assert band == (128 if "--context-parallel" in flags else config.seq_len)
