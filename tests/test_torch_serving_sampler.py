"""The port's Sampler paths against the JAX Sampler (XLA path,
use_pallas=False), on the CPU: DDIM with and without CFG, in-painting, the
plain forward, the bf16 stream, the refine pass and the animation frames.

One small DiT (hidden 32, depth 4, 2 heads, 7 classes; tests/
torch_serving_setup.py) with the same weights on both sides, T = 40 padded
to 48 by a 16-row bucket, band 16, 5 steps, JAX's per-step draws fed to the
port. The port runs its plain versions in f32 (matmul_dtype float32).
The chains held against JAX's run DDIM, whose deterministic steps keep the
two packages' gap below 3e-4 here: an ancestral chain's first step
multiplies f32 ordering differences in eps by sqrt(1 / alpha_bar - 1) ~ 1e4
at t = 999 before the clamp, which put single elements up to 7e-3 apart at
this width (tests/test_torch_model.py holds the ancestral slice, the
animation test below its frames). Tolerances: chains atol 5e-3 (as the JAX
package's chain parity tests hold theirs);
in-painted known rows 1e-6 of known_x (the t = 0 step's mean is x0 there);
a bf16 forward 0.03 (tests/test_sampling_bf16.py's atol); the refine pass,
which runs at t = 0 only (gain ~1), 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
from osu_diffusion_tpu.ops.attention import banded_attention_mask
from osu_diffusion_tpu.sampling import Sampler as JaxSampler
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.sampling import Sampler
from torch_serving_setup import (
    BAND, BUCKET, CHAIN_TOL, chain_inputs, jax_model, jax_noise, known_rows, port_model,
    to_jax, to_port,
)

STEPS = 5
BF16_FORWARD_TOL = 0.03
REFINE_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm, params = jax_model()
    return jm, params, port_model(params)


def _samplers(models, **kw):
    jm, params, port = models
    jkw = dict(kw)
    if "compute_dtype" in kw:
        jkw["compute_dtype"] = jnp.bfloat16 if kw["compute_dtype"] == torch.bfloat16 else jnp.float32
    jd = jax_create(str(STEPS), noise_schedule="squaredcos_cap_v2")
    pd = create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2")
    return (JaxSampler(jm, jd, cfg_scale=2.0, band=BAND, bucket=BUCKET, **jkw),
            Sampler(port, pd, cfg_scale=2.0, band=BAND, bucket=BUCKET, **kw))


def _run(models, inp, call_kw=None, rng_seed=4, **sampler_kw):
    """(port, JAX) chains on the same inputs and draws."""
    js, ps = _samplers(models, **sampler_kw)
    call_kw = call_kw or {}
    rng = jax.random.PRNGKey(rng_seed)
    want = np.asarray(js(models[1], *to_jax(inp), rng,
                         **{k: jnp.asarray(v) for k, v in call_kw.items() if k != "use_cfg"},
                         use_cfg=call_kw.get("use_cfg", True)))
    got = ps(*to_port(inp), noise_fn=jax_noise(rng, STEPS),
             **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in call_kw.items()})
    return got.numpy(), want


@pytest.mark.parametrize("use_cfg", [True, False])
def test_ddim_chain_matches_jax(models, use_cfg):
    inp = chain_inputs(n=2, cfg=use_cfg)
    got, want = _run(models, inp, dict(use_cfg=use_cfg), method="ddim")
    assert got.shape == want.shape == inp["z"].shape
    np.testing.assert_allclose(got, want, atol=CHAIN_TOL)


@pytest.mark.parametrize("method", ["ancestral", "ddim"])
def test_inpainted_chain_keeps_known_rows_and_matches_jax(models, method):
    """Known rows end at known_x on both sides, with either method; the
    DDIM chain matches JAX's."""
    inp = chain_inputs(n=2)
    known_x, free = known_rows(inp)
    got, want = _run(models, inp, dict(known_x=known_x, known_mask=free), method=method)
    np.testing.assert_allclose(got[~free], known_x[~free], atol=1e-6)
    np.testing.assert_allclose(want[~free], known_x[~free], atol=1e-6)
    assert not np.allclose(got[free], known_x[free], atol=1e-2)  # the free rows were sampled
    if method == "ddim":
        np.testing.assert_allclose(got, want, atol=CHAIN_TOL)


def test_plain_forward_chain_matches_jax(models):
    """use_cfg=False: model.forward on every row, with an odd batch."""
    inp = chain_inputs(n=3, cfg=False)
    got, want = _run(models, inp, dict(use_cfg=False), method="ddim")
    assert got.shape == (3, inp["z"].shape[1], 2)
    np.testing.assert_allclose(got, want, atol=CHAIN_TOL)


@pytest.mark.parametrize("cfg_scale", [None, 2.5])
def test_bf16_forward_matches_jax(cfg_scale):
    """A bf16 stream on both sides (the port's plain versions with bf16
    operands): one forward within 0.03 of JAX's, and of the f32 forward."""
    jm, params = jax_model()
    port = port_model(params, matmul_dtype=torch.bfloat16)
    inp = chain_inputs(n=2)
    t_pad = 48
    z, o, c, y = (np.pad(a, [(0, 0), (0, t_pad - a.shape[1])] + [(0, 0)] * (a.ndim - 2))
                  if a.ndim > 1 else a for a in (inp[k] for k in "zocy"))
    t = np.array([500, 500])
    jargs = [jnp.asarray(a) for a in (z, t, o, c, y)]
    pargs = [torch.from_numpy(np.asarray(a)) for a in (z, t, o, c, y)]
    mask = banded_attention_mask(t_pad, BAND)

    def jax_forward(dtype):
        kw = dict(attn_mask=mask, valid_len=40, dtype=dtype)
        if cfg_scale is None:
            return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, **kw))(params, *jargs)
        return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, cfg_scale, method=type(jm).forward_with_cfg,
                                              **kw))(params, *jargs)

    want, want32 = jax_forward(jnp.bfloat16), jax_forward(None)
    with torch.no_grad():
        if cfg_scale is None:
            got = port(*pargs, band=BAND, valid_len=40, dtype=torch.bfloat16)
        else:
            got = port.forward_with_cfg(*pargs, cfg_scale, band=BAND, valid_len=40,
                                        dtype=torch.bfloat16)
    assert got.dtype == torch.float32  # the head returns f32 under a bf16 stream
    got, want, want32 = got.numpy()[:, :40], np.asarray(want)[:, :40], np.asarray(want32)[:, :40]
    np.testing.assert_allclose(got, want, atol=BF16_FORWARD_TOL)
    np.testing.assert_allclose(got, want32, atol=BF16_FORWARD_TOL)
    assert not np.allclose(got, want32, atol=1e-6)  # the stream really ran in bf16


def test_bf16_chain_runs_and_is_bounded(models):
    """The bf16 chain (mirror of tests/test_sampling_bf16.py): f32 output in
    the clamp range, mostly close to the f32 chain but not equal to it, and
    as close to JAX's bf16 chain as the f32 chain is to it."""
    jm, params, _ = models
    bf16_models = (jm, params, port_model(params, matmul_dtype=torch.bfloat16))
    inp = chain_inputs(n=2)
    got, want = _run(bf16_models, inp, compute_dtype=torch.bfloat16)
    got32, _ = _run(models, inp)
    assert got.dtype == np.float32
    assert got.min() >= -1.0 and got.max() <= 2.0
    close = np.isclose(got, got32, atol=0.12).mean()
    assert close > 0.85, close
    assert not np.allclose(got, got32, atol=1e-6)
    close_jax = np.isclose(got, want, atol=0.12).mean()
    assert close_jax > 0.85, close_jax


def test_refine_matches_jax(models):
    """The refine pass (10 t = 0 steps, CFG): the port runs it through the
    bucket with valid_len, JAX's CLI at the unpadded T with no valid_len."""
    jm, params, port = models
    inp = chain_inputs(n=2)
    iters = 10
    t_real = inp["z"].shape[1]
    jd = jax_create(str(STEPS), noise_schedule="squaredcos_cap_v2")
    z, o, c, y = to_jax(inp)
    mask = banded_attention_mask(t_real, BAND)
    t0 = jnp.zeros((2,), jnp.int32)

    @jax.jit
    def refine_chain(img, rng):  # the JAX CLI's refine chain: one scan of t = 0 steps
        def model_fn(x, t, **_):
            return jm.apply({"params": params}, x, t, o, c, y, cfg_scale=2.0, attn_mask=mask,
                            method=type(jm).forward_with_cfg)

        def body(im, r):
            return jd.p_sample(model_fn, im, t0, r, clip_denoised=True)["sample"], None

        return jax.lax.scan(body, img, jax.random.split(rng, iters))[0]

    want = refine_chain(z * 0.5, jax.random.PRNGKey(6))
    refiner = Sampler(port, create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2"),
                      cfg_scale=2.0, band=BAND, bucket=BUCKET)
    pz, po, pc, py = to_port(inp)
    got = refiner.refine(pz * 0.5, po, pc, py, iters, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REFINE_TOL)


def test_progressive_frames_match_jax(models):
    """The animation's frames: Sampler.progressive against the JAX CLI's
    `_progressive_samples` (ancestral, at the unpadded T, so its draws are
    taken there), every frame (1.8e-3 apart at most over three seeds)."""
    from osu_diffusion_tpu.cli import _progressive_samples

    jm, params, _ = models
    js, ps = _samplers(models)
    inp = chain_inputs(n=2)
    rng = jax.random.PRNGKey(8)
    want = np.asarray(_progressive_samples(js, params, *to_jax(inp), rng))
    got = ps.progressive(*to_port(inp), noise_fn=jax_noise(rng, STEPS, t_real=40)).numpy()
    assert got.shape == want.shape == (STEPS, *inp["z"].shape)
    np.testing.assert_allclose(got, want, atol=CHAIN_TOL)


def test_sampler_refusals(models):
    _, params, port = models
    diffusion = create_diffusion(str(STEPS))
    with pytest.raises(ValueError, match="sampling method"):
        Sampler(port, diffusion, method="plms")
    with pytest.raises(ValueError, match="compute_dtype"):
        Sampler(port, diffusion, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="int8 under the bf16 stream"):
        Sampler(port_model(params, quant=True), diffusion, compute_dtype=torch.bfloat16)
