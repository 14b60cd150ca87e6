"""DiT-XL in the PyTorch port against the JAX package, on the CPU: the
model at XL widths (hidden 1152, 16 heads of 72, MLP 4608), depth cut to
2 (the int8 model to 1), built from JAX params through the conversion;
the tile plans of the XL GEMMs; and the training entries' widths: every
attention entry (unranged and ranged) and every MLP training entry
(kernel B's training forward, the fused backward) takes XL, and refuses a
width no kernel is built for before any launch. XL training itself is
held to JAX in tests/test_torch_xl_train.py.

Tolerances:
- the f32 forward against JAX's plain path (f32 at `highest` precision,
  the dense banded mask): tests/test_torch_model.py's f32 tolerance (rtol
  1e-4, atol 1e-5): the same f32 math, sums in another order;
- the int8 forward against JAX's int8 path (the Pallas int8 kernels and
  the banded flash core at head dim 72, in interpret mode): 2e-3 of max
  |JAX| (tests/test_torch_attention_fwd.py's order for the online
  softmax's P rounding). Both round the same operands to bf16, but P is
  rounded against another running max (JAX's flash blocks of 32 keys, the
  port's plain softmax against the row's final max), which at this width
  moves outputs of up to ~4 by a few 1e-3: JAX's own path at flash block 16
  against block 32 differs by 3.1e-3 (7.4e-4 of max) at these inputs, the
  port against JAX by 5.5e-3 (1.3e-3 of max). tests/test_torch_quant.py's
  rtol 2e-3 / atol 1e-3 was set for outputs of ~2 at width 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_attention as pa
import osu_diffusion_tpu.ops.pallas_mlp as pm
import osu_diffusion_tpu.ops.pallas_quant as pq
from osu_diffusion_tpu.models.dit import DiT as JaxDiT
from osu_diffusion_tpu.models.dit import DiTConfig
from osu_diffusion_tpu.models.quantize import quantize_params
from osu_diffusion_tpu.ops.attention import banded_attention_mask
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.ops import banded_attention as tba
from osu_diffusion_tpu_torch.ops import quant as tq
from osu_diffusion_tpu_torch.ops.gemm_plan import GEMM_ROWS, SERVE_WIDTHS
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params

HIDDEN, HEADS, CLASSES, CTX = 1152, 16, 7, 144  # DiT-XL's widths, few classes
T, VALID, BAND = 96, 90, 32
H100_SMS = 132
bf16 = torch.bfloat16


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpret mode on the CPU."""
    for mod in (pa, pm, pq):
        orig = mod.pl.pallas_call

        def patched(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", patched)


def _jax_model(depth, quant=False, seed=0):
    """JAX DiT at XL widths and its f32 params as numpy, the adaLN and final
    layers perturbed (adaLN-Zero would gate every block out)."""
    cfg = dict(hidden_size=HIDDEN, depth=depth, num_heads=HEADS, num_classes=CLASSES,
               context_size=CTX, flash_block=BAND)
    params = JaxDiT(DiTConfig(**cfg)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 8)), jnp.zeros((1, 8, CTX)), jnp.zeros((1,), jnp.int32),
    )["params"]
    r = np.random.RandomState(seed)

    def perturb(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        a = np.array(leaf)
        if "adaLN" in names or ("final_layer" in names and "linear" in names):
            a = a + (0.05 * r.randn(*a.shape)).astype(a.dtype)
        return a

    return JaxDiT(DiTConfig(**cfg, quant=quant)), jax.tree_util.tree_map_with_path(perturb, params)


def _inputs(seed=1):
    """CFG batch 2 ([cond | null class], one shared x) over T rows."""
    r = np.random.RandomState(seed)
    x_half = r.randn(1, T, 2).astype(np.float32)
    return dict(
        x=np.concatenate([x_half, x_half]),
        t=np.array([500, 500]),
        o=np.tile((np.cumsum(r.rand(1, T), axis=1) * 300).astype(np.float32), (2, 1)),
        c=np.tile(r.rand(1, T, CTX).astype(np.float32), (2, 1, 1)),
        y=np.array([3, CLASSES]),
    )


def _run(jax_model, params, port, **jax_kwargs):
    inp = _inputs()
    j_args = [jnp.asarray(inp[k]) for k in ("x", "t", "o", "c", "y")]
    p_args = [torch.from_numpy(inp[k]) for k in ("x", "t", "o", "c", "y")]
    with torch.no_grad():
        want = jax_model.apply({"params": params}, *j_args, cfg_scale=2.5, valid_len=VALID,
                               method=JaxDiT.forward_with_cfg, **jax_kwargs)
        got = port.forward_with_cfg(*p_args, 2.5, band=BAND, valid_len=VALID)
    return got.numpy()[:, :VALID], np.asarray(want)[:, :VALID]


def test_xl_forward_with_cfg_matches_jax_f32():
    """Depth 2 at XL widths, f32 on both sides: JAX's plain path with the
    dense banded mask, the port's plain versions at matmul_dtype float32."""
    jax_model, params = _jax_model(depth=2)
    port = DiT(hidden_size=HIDDEN, depth=2, num_heads=HEADS, num_classes=CLASSES, context_size=CTX,
               matmul_dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax_params(params, num_label_rows=CLASSES + 1))
    assert port.blocks[0].attn.in_proj_weight.shape == (3 * HIDDEN, HIDDEN)
    assert port.blocks[0].mlp.fc1.weight.shape == (4 * HIDDEN, HIDDEN)
    got, want = _run(jax_model, params, port.eval(), attn_mask=banded_attention_mask(T, BAND))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_xl_int8_forward_matches_jax_int8_path(interpret_mode):
    """Depth 1 at XL widths, int8 weights (quantized by the port after the
    conversion, by JAX before it): the port's quant model (the int8 plain
    versions, banded attention at Dh 72, bf16 operands) against JAX
    DiT(quant=True) on its Pallas path."""
    jax_model, params = _jax_model(depth=1, quant=True)
    port = DiT(hidden_size=HIDDEN, depth=1, num_heads=HEADS, num_classes=CLASSES, context_size=CTX,
               matmul_dtype=bf16, quant=True)
    port.load_state_dict(quantize_state_dict(state_dict_from_jax_params(params, num_label_rows=CLASSES + 1)))
    got, want = _run(jax_model, quantize_params(params), port.eval(), band=BAND, use_pallas=True)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


def _covers_once(plan, cols):
    """Every (128-row, width-column) tile of the plan's output exactly once,
    the last column block ragged where the width does not divide `cols`."""
    seen = [tile for cta in range(plan.grid) for tile in plan.tiles_of(cta)]
    want = {(r, c) for r in range(0, plan.rows, GEMM_ROWS) for c in range(0, cols, plan.width)}
    assert len(seen) == len(set(seen)) == plan.tiles and set(seen) == want
    assert 1 <= plan.grid <= min(H100_SMS, plan.tiles)


@pytest.mark.parametrize("n,t", [(2, 768), (2, 96), (1, 757)], ids=["sample_t768", "t96", "n1_t757"])
def test_xl_gemm_plans(n, t):
    """The GEMMs of rows 7 and 10 (up: 4608 columns over 1152; down: 1152
    over 4608, whose 1152 columns 256 does not divide, so 128-wide tiles),
    row 11 (the qkv projection's 3456 columns over 1152, ragged at 256) and
    row 12 (the out projection: 1152 over 1152, 128-wide)."""
    d, hdim = HIDDEN, 4 * HIDDEN
    assert d in SERVE_WIDTHS
    up, down = tam.mlp_plan(n, t, d, hdim, H100_SMS)
    assert (up.rows, up.cols, up.depth) == (n * t, hdim, d) and hdim % up.width == 0
    assert (down.rows, down.cols, down.depth, down.width) == (n * t, d, hdim, 128)
    qkv = tq.qkv_plan(n, t, d, 3 * d, H100_SMS)
    assert (qkv.rows, qkv.cols, qkv.depth) == (n * t, 3 * d, d)
    out = tq.out_plan(n, t, d, H100_SMS)
    assert (out.rows, out.cols, out.depth, out.width) == (n * t, d, d, 128)
    for plan in (up, down, qkv, out):
        _covers_once(plan, plan.cols)
    # the int8 kernels' depth limit binds only the skinny body, not these GEMMs
    assert down.depth > tq.MAX_K and d <= tq.MAX_K


def _head_views(dh, dtype=torch.float32, n=1, h=2, t=64):
    qkv = torch.randn(n, t, 3 * h * dh).to(dtype)
    return [a.view(n, t, h, dh).transpose(1, 2) for a in qkv.split(h * dh, dim=-1)]


def test_attention_training_entries_refuse_xl_head_dim():
    """Every training entry, unranged (the LSE forward, dq and dk/dv: XL
    training) and ranged (context parallelism: XL under CP), takes Dh 72 as
    the inference forwards do; the input checks the wrappers run before any
    launch refuse any other head dim with a ValueError, the ranged
    backward's launch path included."""
    assert tba.HEAD_DIMS == (64, 72)
    assert not hasattr(tba, "CP_HEAD_DIM")  # one set of head dims for every entry
    for dh in tba.HEAD_DIMS:
        tba._check_head_dim(dh)
    q, k, v = _head_views(80, bf16)
    for tensors in (dict(q=q, k=k, v=v), dict(o=q, do=k)):
        with pytest.raises(ValueError, match=r"head dims \(64, 72\)"):
            tba._check_kernel_inputs(bf16, **tensors)
    with pytest.raises(ValueError, match=r"head dims \(64, 72\)"):  # the ranged dq's launch path
        tba._launch_bwd(tba.banded_attention_ranged_bwd_dq, "dq", q, k, v, q, torch.zeros(2, 64), k, 16, 64,
                        bf16, bounds=(0, 64, 0, 64))


@pytest.mark.parametrize("entry", ["train_forward", "bwd_prologue", "bwd_epilogue"])
def test_mlp_training_entries_refuse_xl_width(entry):
    """Kernel B's training forward and the fused backward's two stages take
    DiT-XL's D 1152, as the serving forwards do; at a width no kernel is
    built for (1280) their input checks raise a ValueError before any
    launch."""
    n, t, hdim = 1, 8, 4 * HIDDEN
    assert HIDDEN in tam.TRAIN_WIDTHS and HIDDEN in tam.BWD_WIDTHS and HIDDEN in SERVE_WIDTHS
    widths = tam.TRAIN_WIDTHS if entry == "train_forward" else tam.BWD_WIDTHS
    tam._check_widths(torch.randn(n, t, HIDDEN).to(bf16), hdim, bf16, widths)
    d = 1280
    x = torch.randn(n, t, d).to(bf16)
    mod = torch.randn(n, d)
    w1, w2 = torch.randn(4 * d, d).to(bf16), torch.randn(d, 4 * d).to(bf16)
    a = torch.randn(n, t, 4 * d).to(bf16)
    mlp = torch.randn(n, t, d)
    with pytest.raises(ValueError, match="the kernel takes D in"):
        if entry == "train_forward":
            tam._launch(tam.adaln_mlp_train, x, mod, mod, mod, w1, mod[0], w2, mod[0], 1e-6, bf16,
                        residuals=True)
        elif entry == "bwd_prologue":
            tam._bwd_prologue_launch(x, mlp, a, mod, w2, bf16)
        else:
            tam._bwd_epilogue_launch(a, x, x, mod, mod, w1, 1e-6, bf16)
