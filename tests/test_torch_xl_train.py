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


@pytest.mark.parametrize("flags,match", [(["--mlp-bwd", "fused"], "fused MLP backward"),
                                         (["--num-model", "2", "--context-parallel"], "ranged attention")],
                         ids=["mlp_bwd_fused", "context_parallel"])
def test_train_cli_refuses_xl_paths_before_the_first_step(tmp_path, monkeypatch, flags, match):
    """`--model DiT-XL` with --mlp-bwd fused or --num-model 2
    --context-parallel: the train CLI's argument path raises a ValueError
    naming what is missing and ROADMAP.md before it joins a process group,
    builds a model or writes anything (so no kernel can launch)."""
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.train import trainer

    reached = []
    monkeypatch.setattr(trainer, "_join_process_group", lambda *a, **k: reached.append("join"))
    monkeypatch.setattr(trainer, "_train", lambda *a, **k: reached.append("train"))
    out = tmp_path / "results"
    args = build_train_parser().parse_args(["--data-path", str(tmp_path), "--model", "DiT-XL", "--device", "cpu",
                                            "--results-dir", str(out), *flags])
    with pytest.raises(ValueError, match=f"{match}.*ROADMAP"):
        train_main(args)
    assert not reached and not out.exists()


def test_xl_default_train_path_passes_the_width_checks():
    """The default path at DiT-XL (--mlp-bwd xla, one model rank) and the
    refused paths at the other models' widths pass `check_kernel_widths`."""
    from osu_diffusion_tpu_torch.train.trainer import TrainConfig, check_kernel_widths

    check_kernel_widths(TrainConfig(data_path="", model="DiT-XL"))
    for model in ("DiT-S", "DiT-B", "DiT-L"):
        check_kernel_widths(TrainConfig(data_path="", model=model, mlp_bwd="fused", num_model=2))
