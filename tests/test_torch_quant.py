"""int8 weight-only serving in the PyTorch port against the JAX package, on
the CPU, at small sizes.

`quantize_weight`, the plain versions of the four int8 kernels against the
Pallas kernels they replace (interpret mode, as tests/test_quant.py runs
them) and against the f32 dequantised math, the weight conversion, the
quant DiT forward, a 4-step quant sampling chain, the sample CLI with
--quantize-weights, and the errors of the serving-only model. Inputs come
from numpy seeds and reach both frameworks as the same arrays. The kernels
themselves are tested in test_torch_kernels.py.

Tolerances, in units of max |reference|:
- port plain (bf16 operands) vs the JAX Pallas kernel: 1e-4. Both round
  the same f32 activation to bf16 and multiply by the exact int8 codes
  with f32 sums; sums run in another order (~1e-6), and where a prologue
  computes a LayerNorm or GELU first, an ulp-level difference can flip one
  bf16 rounding of an operand (2^-8 of one term of a sum of K);
- port plain (f32) vs the jnp f32 dequantised math: 1e-5 (f32 sums in
  another order);
- either kernel contract (bf16 operands) vs the f32 dequantised math:
  5e-3, as tests/test_quant.py holds the Pallas kernels (bf16 rounding of
  the activation, 2^-9 relative, over K-term sums).
"""
import argparse
import os

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
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.ops import quant as tq
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, DEPTH, HEADS, CLASSES, CTX = 64, 2, 4, 7, 144
BAND = 16
FIXTURE = os.path.join(ROOT, "assets", "toy_datasets", "visual_spacing",
                       "test - visual spacing (OliBomby) [test12].osu")  # T = 34
bf16, f32 = torch.bfloat16, torch.float32

KERNEL_TOL = 1e-4  # port plain (bf16) vs Pallas kernel, of max |reference|
F32_TOL = 1e-5  # port plain (f32) vs jnp f32 dequantised math
CONTRACT_TOL = 5e-3  # bf16-operand kernels vs f32 dequantised math


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpret mode on the CPU."""
    for mod in (pa, pm, pq):
        orig = mod.pl.pallas_call

        def patched(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", patched)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _quantized(rng, k, m, std):
    """A (K, M) f32 weight quantized by JAX: (codes (K, M), scale (M,)), and
    the port's (M, K) codes."""
    wq, s = pq.quantize_weight(jnp.asarray(rng.normal(size=(k, m)) * std, jnp.float32))
    return wq, s, _t(np.asarray(wq).T)


def _ln_mod(x, shift, scale):
    """jnp LN(x) * (1 + scale) + shift, the f32 math of the prologues."""
    xc = x - jnp.mean(x, axis=-1, keepdims=True)
    xn = xc * jax.lax.rsqrt(jnp.mean(xc * xc, axis=-1, keepdims=True) + 1e-6)
    return xn * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _deq(wq, s):
    return wq.astype(jnp.float32) * s[None, :]


def _check_three_ways(port16, port32, pallas, math):
    """port bf16 plain ~ Pallas; port f32 plain ~ f32 math; both kernel
    contracts ~ f32 math."""
    assert _rel(port16, pallas) <= KERNEL_TOL, _rel(port16, pallas)
    assert _rel(port32, math) <= F32_TOL, _rel(port32, math)
    assert _rel(pallas, math) <= CONTRACT_TOL, _rel(pallas, math)
    assert _rel(port16, math) <= CONTRACT_TOL, _rel(port16, math)


# ---------------------------------------------------------------------------
# quantize_weight
# ---------------------------------------------------------------------------


def test_quantize_weight_matches_jax():
    """The port quantizes torch's (out, in) layout row by row; JAX its
    (in, out) layout column by column. Same codes and scales, exactly, on a
    matrix with an all-zero output channel (scale 1.0, codes 0) and values
    at half-code boundaries (round half to even on both sides)."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(96, 40)) * 0.05).astype(np.float32)  # (in, out)
    w[:, 7] = 0.0
    w[3, 11] = 0.5 * (np.abs(w[:, 11]).max() / 127.0)  # exactly half a code
    wq, s = pq.quantize_weight(jnp.asarray(w))
    got_q, got_s = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    assert got_q.dtype == torch.int8 and got_s.dtype == f32
    assert tuple(got_q.shape) == (40, 96) and tuple(got_s.shape) == (40,)
    differ = int((got_q.numpy() != np.asarray(wq).T).sum())
    assert differ == 0, f"{differ} of {w.size} codes differ"
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s))
    assert got_s[7] == 1.0 and (got_q[7] == 0).all()
    # stacked leading axes, as JAX's scanned layout
    q3, s3 = tq.quantize_weight(torch.stack([torch.from_numpy(w.T.copy())] * 2))
    assert torch.equal(q3[1], got_q) and torch.equal(s3[0], got_s)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", [None, "gelu_tanh"])
@pytest.mark.parametrize("lead", [(8, 128), (6, 128), (3, 37)], ids=["n8", "n6", "ragged"])
def test_int8_matmul_plain_matches_pallas(interpret_mode, lead, activation):
    """Lead dims and ragged rows (3 x 37 = 111 rows, not a 16-row multiple);
    M = 1024 takes two 512-wide JAX M blocks."""
    rng = np.random.default_rng(sum(lead))
    k, m = 128, 1024
    wq, s, wq_t = _quantized(rng, k, m, 0.05)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    b = (rng.normal(size=(m,)) * 0.1).astype(np.float32)
    pallas = pq.int8_matmul(jnp.asarray(x), wq, s, jnp.asarray(b), activation=activation)
    math = jnp.asarray(x) @ _deq(wq, s) + b
    if activation:
        math = jax.nn.gelu(math, approximate=True)
    args = (torch.from_numpy(x), wq_t, _t(s), torch.from_numpy(b), activation)
    got = tq.int8_matmul(*args)  # a CPU tensor: the plain version, bf16 operands
    assert got.shape == (*lead, m) and got.dtype == f32
    _check_three_ways(got, tq.int8_matmul_reference(*args, matmul_dtype=f32), pallas, math)


@pytest.mark.parametrize("n", [8, 6])
def test_int8_modulated_matmul_plain_matches_pallas(interpret_mode, n):
    """n = 8 and 6 at T = 128 take JAX's multi-program batch grid (c = 4 and,
    for 6, the divisor fallback c = 3); M = 1536 takes two M blocks. The
    modulation rows are views of one (N, 6D) tensor, as the model passes."""
    rng = np.random.default_rng(n)
    t, d, m = 128, 128, 1536
    wq, s, wq_t = _quantized(rng, d, m, 0.02)
    x = rng.normal(size=(n, t, d)).astype(np.float32)
    mod = (rng.normal(size=(n, 6 * d)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(m,)) * 0.1).astype(np.float32)
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    pallas = pq.int8_modulated_matmul(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale),
                                      wq, s, jnp.asarray(b))
    math = _ln_mod(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale)) @ _deq(wq, s) + b
    tmod = torch.from_numpy(mod)
    args = (torch.from_numpy(x), tmod[:, :d], tmod[:, d:2 * d], wq_t, _t(s), torch.from_numpy(b))
    got = tq.int8_modulated_matmul(*args)
    assert got.shape == (n, t, m)
    _check_three_ways(got, tq.int8_modulated_matmul_reference(*args, matmul_dtype=f32),
                      pallas, math)


@pytest.mark.parametrize("n", [8, 6])
def test_int8_out_residual_plain_matches_pallas(interpret_mode, n):
    """d = 1024: JAX picks bm = 512 < d, so the gate is sliced per output
    block; n = 8 and 6 at T = 128 as above."""
    rng = np.random.default_rng(10 + n)
    t, d = 128, 1024
    wq, s, wq_t = _quantized(rng, d, d, 0.02)
    o = rng.normal(size=(n, t, d)).astype(np.float32)
    res = rng.normal(size=(n, t, d)).astype(np.float32)
    gate = (rng.normal(size=(n, d)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    pallas = pq.int8_out_residual(jnp.asarray(o), jnp.asarray(res), jnp.asarray(gate), wq, s,
                                  jnp.asarray(b))
    math = res + gate[:, None, :] * (jnp.asarray(o) @ _deq(wq, s) + b)
    args = (torch.from_numpy(o), torch.from_numpy(res), torch.from_numpy(gate), wq_t, _t(s),
            torch.from_numpy(b))
    got = tq.int8_out_residual(*args)
    _check_three_ways(got, tq.int8_out_residual_reference(*args, matmul_dtype=f32), pallas, math)


@pytest.mark.parametrize("n", [8, 6])
def test_adaln_mlp_quant_plain_matches_pallas(interpret_mode, n):
    """h = 2048: two JAX H blocks, whose fc2 partials carry s2 each (the
    port applies s2 once to the whole sum); n = 8 and 6 at T = 128. The
    wrapper takes the int8 codes in torch's Linear layout, as the model
    passes them."""
    rng = np.random.default_rng(20 + n)
    t, d, h = 128, 128, 2048
    w1q, s1, _ = _quantized(rng, d, h, 0.05)
    w2q, s2, _ = _quantized(rng, h, d, 0.05)
    x = rng.normal(size=(n, t, d)).astype(np.float32)
    mod = (rng.normal(size=(n, 3, d)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(h,)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    jargs = (jnp.asarray(x), *(jnp.asarray(mod[:, i]) for i in range(3)))
    pallas = pm.adaln_mlp_quant(*jargs, w1q, s1, jnp.asarray(b1), w2q, s2, jnp.asarray(b2))
    math = pm._reference_impl(*jargs, _deq(w1q, s1), b1, _deq(w2q, s2), b2, eps=1e-6)
    tmod = torch.from_numpy(mod)
    targs = (torch.from_numpy(x), tmod[:, 0], tmod[:, 1], tmod[:, 2])
    weights = (_t(w1q), _t(s1), torch.from_numpy(b1), _t(w2q), _t(s2), torch.from_numpy(b2))
    fc1_q, fc2_q = weights[0].t(), weights[3].t()  # (H, D), (D, H)
    assert fc1_q.dtype == torch.int8
    got = tam.adaln_mlp_quant(*targs, fc1_q, weights[1], weights[2], fc2_q, weights[4], weights[5])
    assert got.shape == (n, t, d) and got.dtype == f32
    _check_three_ways(got, tam.adaln_mlp_quant_reference(*targs, *weights, matmul_dtype=f32),
                      pallas, math)


def test_adaln_mlp_quant_rejects_a_bf16_stream():
    x = torch.zeros(1, 4, 128, dtype=bf16)
    fc1_q, fc2_q = torch.zeros(256, 128, dtype=torch.int8), torch.zeros(128, 256, dtype=torch.int8)
    m = torch.zeros(1, 128)
    with pytest.raises(TypeError, match="float32"):
        tam.adaln_mlp_quant(x, m, m, m, fc1_q, torch.ones(256), torch.zeros(256), fc2_q,
                            torch.ones(128), m[0])


# ---------------------------------------------------------------------------
# conversion, the model, the sampler, the CLI
# ---------------------------------------------------------------------------


def _jax_model(quant=False, seed=0):
    """JAX DiT (flash block 16 for the band) and f32 params as numpy, adaLN
    and final layers perturbed (adaLN-Zero would gate every block out)."""
    cfg = dict(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
               context_size=CTX, flash_block=16)
    base = JaxDiT(DiTConfig(**cfg))
    params = base.init(
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

    params = jax.tree_util.tree_map_with_path(perturb, params)
    return JaxDiT(DiTConfig(**cfg, quant=True)), base, params


def _port_quant(params, matmul_dtype=bf16):
    """The port's quant DiT from the JAX f32 params, quantized by the port."""
    model = DiT(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
                context_size=CTX, matmul_dtype=matmul_dtype, quant=True)
    model.load_state_dict(quantize_state_dict(
        state_dict_from_jax_params(params, num_label_rows=CLASSES + 1)))
    return model.eval()


def _inputs(t=48, seed=1):
    r = np.random.RandomState(seed)
    x_half = r.randn(1, t, 2).astype(np.float32)
    return dict(
        x=np.concatenate([x_half, x_half]),
        t=np.array([500, 500]),
        o=np.tile((np.cumsum(r.rand(1, t), axis=1) * 300).astype(np.float32), (2, 1)),
        c=np.tile(r.rand(1, t, CTX).astype(np.float32), (2, 1, 1)),
        y=np.array([3, CLASSES]),  # [cond | null class]
    )


def test_quantize_state_dict_matches_jax_quantize_params():
    """Quantizing after the conversion (the port) equals converting JAX's
    quantized tree, key for key and bit for bit; the quant model loads it
    strictly."""
    _, _, params = _jax_model()
    got = quantize_state_dict(state_dict_from_jax_params(params, num_label_rows=CLASSES + 1))
    want = state_dict_from_jax_params(quantize_params(params), num_label_rows=CLASSES + 1)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert got["blocks.0.attn.in_proj_weight"].dtype == torch.int8
    assert tuple(got["blocks.0.attn.in_proj_weight"].shape) == (3 * HIDDEN, HIDDEN)
    DiT(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
        quant=True).load_state_dict(got, strict=True)


def test_quantize_state_dict_rejects_an_int8_dict():
    _, _, params = _jax_model()
    sd = quantize_state_dict(state_dict_from_jax_params(params, num_label_rows=CLASSES + 1))
    with pytest.raises(ValueError, match="already int8"):
        quantize_state_dict(sd)


def _run(jax_model, params, port, inp, valid_len, **jax_kwargs):
    j_args = [jnp.asarray(inp[k]) for k in ("x", "t", "o", "c", "y")]
    p_args = [torch.from_numpy(inp[k]) for k in ("x", "t", "o", "c", "y")]
    with torch.no_grad():
        want = jax_model.apply({"params": params}, *j_args, cfg_scale=2.5, valid_len=valid_len,
                               method=JaxDiT.forward_with_cfg, **jax_kwargs)
        got = port.forward_with_cfg(*p_args, 2.5, band=BAND, valid_len=valid_len)
    return got.numpy()[:, :valid_len], np.asarray(want)[:, :valid_len]


def test_quant_forward_matches_jax_pallas_path(interpret_mode):
    """The quant DiT with a band and valid_len, against JAX DiT(quant=True)
    on its Pallas-interpret path (int8 kernels + banded flash core): both
    round the same operands to bf16; summation order differs, so now and
    then an operand rounds one bf16 ulp apart (as in test_torch_model's
    bf16 parity: rtol 2e-3, atol 1e-3; outputs reach ~2)."""
    qmodel, _, params = _jax_model()
    got, want = _run(qmodel, quantize_params(params), _port_quant(params), _inputs(), 37,
                     band=BAND, use_pallas=True)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)


def test_quant_forward_matches_jax_dense_path(interpret_mode):
    """The same against JAX's dense path (int8 kernels + the f32 masked
    softmax core): the port's banded core rounds q/k/v and P to bf16 and
    JAX's does not, 2^-9 relative on each operand; tests/test_quant.py
    holds JAX's two paths to each other within atol 2e-2, and so is this."""
    from osu_diffusion_tpu.ops.attention import banded_attention_mask

    qmodel, _, params = _jax_model()
    got, want = _run(qmodel, quantize_params(params), _port_quant(params), _inputs(), 37,
                     attn_mask=banded_attention_mask(48, BAND))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_quant_forward_f32_is_the_dequantised_model():
    """At matmul_dtype f32 the port's quant model computes the f32 model
    over the dequantised weights: JAX's f32 DiT (XLA dense path) with every
    block weight replaced by w_q * s, within f32 tolerance. This holds the
    quant block's folding (LN and modulation into qkv, gate and residual
    into the out projection, the whole MLP half) to the plain block."""
    from osu_diffusion_tpu.ops.attention import banded_attention_mask

    _, base, params = _jax_model()
    qparams = quantize_params(params)
    deq = jax.tree_util.tree_map(lambda a: a, params)
    for key, block in qparams.items():
        if not key.startswith("blocks_"):
            continue
        attn = block["attn"]
        deq[key]["attn"]["qkv_kernel"] = _deq(attn["qkv_kernel_q"], attn["qkv_scale"])
        deq[key]["attn"]["out_kernel"] = _deq(attn["out_kernel_q"], attn["out_scale"])
        for name in ("mlp_fc1", "mlp_fc2", "adaLN"):
            deq[key][name]["kernel"] = _deq(block[name]["kernel_q"], block[name]["scale"])
    got, want = _run(base, deq, _port_quant(params, f32), _inputs(), 37,
                     attn_mask=banded_attention_mask(48, BAND))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_quant_sampler_chain_matches_jax(interpret_mode):
    """4 CFG denoise steps of the quant model on a toy fixture (T = 34,
    padded to 48 by a 16-row bucket), the JAX Sampler on its Pallas path,
    the same initial noise and JAX's per-step draws fed to the port.
    Coordinates agree within 5e-2: at the first of 4 squaredcos steps the
    x0 prediction is 2.03e4 * (x - eps) (sqrt_recip_alphas_cumprod), so the
    ~1e-6 eps differences of two bf16-operand forwards whose sums run in
    another order become ~2e-2 before the [-1, 2] clamp (measured 2.0e-2;
    the f32 chain of test_torch_model, ~1e-7 apart, holds 5e-3)."""
    from osu_diffusion_tpu.beatmap import Beatmap
    from osu_diffusion_tpu.data import beatmap_to_sequence as jax_featurize
    from osu_diffusion_tpu.data.process import split_and_process_sequence_no_augment as jax_split
    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu.sampling import Sampler as JaxSampler
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.sampling import Sampler

    steps, cfg_scale, bucket = 4, 2.0, 16
    qmodel, _, params = _jax_model()
    (_, jo, jc), t_real = jax_split(jnp.asarray(jax_featurize(Beatmap.from_path(FIXTURE))))
    z_half = np.random.RandomState(2).randn(1, t_real, 2).astype(np.float32)
    z = np.concatenate([z_half, z_half])
    y = np.array([3, CLASSES])
    jo, jc = jo - jo[0], jc
    o2, c2 = (np.concatenate([np.asarray(a)[None]] * 2) for a in (jo, jc))
    rng = jax.random.PRNGKey(7)
    want = np.asarray(JaxSampler(
        qmodel, jax_create(str(steps), noise_schedule="squaredcos_cap_v2"), cfg_scale=cfg_scale,
        band=BAND, bucket=bucket, use_pallas=True,
    )(quantize_params(params), jnp.asarray(z), jnp.asarray(o2), jnp.asarray(c2),
      jnp.asarray(y, jnp.int32), rng))
    step_rngs = jax.random.split(rng, steps)  # JAX p_sample_loop's per-step keys

    def jax_noise(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(step_rngs[k], shape, jnp.float32)))

    sampler = Sampler(_port_quant(params), create_diffusion(str(steps), noise_schedule="squaredcos_cap_v2"),
                      cfg_scale=cfg_scale, band=BAND, bucket=bucket)
    got = sampler(torch.from_numpy(z), torch.from_numpy(o2), torch.from_numpy(c2),
                  torch.from_numpy(y), noise_fn=jax_noise).numpy()
    assert got.shape == want.shape == (2, t_real, 2)
    np.testing.assert_allclose(got, want, atol=5e-2)


def test_sample_cli_quantize_weights_writes_a_beatmap(tmp_path, monkeypatch, capsys):
    """The port's sample command with --quantize-weights on the CPU, from a
    JAX-initialized f32 checkpoint, as tests/test_quant.py drives the JAX
    CLI: the .osu it writes reparses with every hit object."""
    from osu_diffusion_tpu.beatmap import Beatmap
    from osu_diffusion_tpu_torch.cli import build_sample_parser, sample_main
    from osu_diffusion_tpu_torch.models import dit as port_dit

    def tiny(**kw):
        return DiT(hidden_size=32, depth=1, num_heads=2, **kw)

    monkeypatch.setitem(port_dit.DiT_models, "DiT-T", tiny)
    _, _, params = _jax_model()
    params = JaxDiT(DiTConfig(hidden_size=32, depth=1, num_heads=2, num_classes=CLASSES,
                              context_size=CTX)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 8)), jnp.zeros((1, 8, CTX)), jnp.zeros((1,), jnp.int32))["params"]
    ckpt = str(tmp_path / "tiny.pt")
    torch.save({"ema": state_dict_from_jax_params(params, num_label_rows=CLASSES + 1),
                "args": argparse.Namespace(model="DiT-T")}, ckpt)
    args = build_sample_parser().parse_args([
        "--beatmap", FIXTURE, "--ckpt", ckpt, "--model", "DiT-T",
        "--num-classes", str(CLASSES), "--num-sampling-steps", "2", "--quantize-weights",
        "--device", "cpu", "--results-dir", str(tmp_path / "results"),
    ])
    assert args.quantize_weights
    written = sample_main(args)
    assert "seq len 34" in capsys.readouterr().out
    assert len(written) == 1
    assert len(Beatmap.from_path(written[0]).hit_objects()) == len(Beatmap.from_path(FIXTURE).hit_objects())
    assert not build_sample_parser().parse_args(["--beatmap", "b", "--ckpt", "c"]).quantize_weights


def test_quant_model_serves_only():
    """The int8 model raises in training (train=True, or under grad) and on
    a bf16 stream."""
    _, _, params = _jax_model()
    model = _port_quant(params)
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    args = (inp["x"], inp["t"], inp["o"], inp["c"], inp["y"])
    with torch.no_grad(), pytest.raises(RuntimeError, match="serves only"):
        model(*args, train=True)
    with pytest.raises(RuntimeError, match="no_grad"):
        model(*args)
    with torch.no_grad(), pytest.raises(TypeError, match="float32"):
        model(*args, dtype=bf16)
    assert not list(model.blocks.parameters())  # the int8 weights are buffers
    with torch.no_grad():
        assert torch.isfinite(model(*args, band=BAND, valid_len=40)).all()
