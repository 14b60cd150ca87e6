"""The port's diffusion sampling half against the JAX package's, on the CPU:
p_mean_variance with denoised_fn, DDIM steps (eta 0 and 0.5) and their
reverse, and the DDIM and progressive chains with JAX's per-step draws fed
in.

Both sides run one closed-form model (no DiT): eps = tanh(0.7 x + t / 1000)
and 0.5 sin(3 x) as the learned-range variance values; the same numpy inputs
reach both as the same arrays. Tolerance: f32 arithmetic in another order,
rtol 1e-5 / atol 1e-6 on a step; a chain's coefficients (1/sqrt(alpha_bar)
up to ~60 at t near T) amplify that, rtol 1e-4 / atol 1e-5 over 5 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 5


def _both():
    return (jax_create(str(STEPS), noise_schedule="squaredcos_cap_v2"),
            create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2"))


def _model_fns():
    def jax_fn(x, t, **_):
        return jnp.concatenate([jnp.tanh(0.7 * x + t[:, None, None] / 1000.0),
                                0.5 * jnp.sin(3 * x)], -1)

    def port_fn(x, t):
        return torch.cat([torch.tanh(0.7 * x + t[:, None, None] / 1000.0),
                          0.5 * torch.sin(3 * x)], -1)

    return jax_fn, port_fn


def _x(shape=(2, 12, 2), seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _close(port_out, jax_out, tol=STEP_TOL):
    for key in jax_out:
        if key in port_out:
            np.testing.assert_allclose(np.broadcast_to(port_out[key].numpy(), jax_out[key].shape),
                                       np.asarray(jax_out[key]), **tol, err_msg=key)


@pytest.mark.parametrize("mode", ["learned_range", "no_denoised_fn"])
@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance_modes_match_jax(mode, clip):
    """The mean, variance, log variance and x0 prediction (denoised_fn,
    where given, before the clamp)."""
    jd, pd = _both()
    jfn, pfn = _model_fns()
    denoised_fn = None if mode == "no_denoised_fn" else (lambda x0: 0.5 * x0 + 0.25)
    x = _x()
    for i in (0, 2, STEPS - 1):
        t = np.array([i, i])
        want = jd.p_mean_variance(jfn, jnp.asarray(x), jnp.asarray(t), clip_denoised=clip,
                                  denoised_fn=denoised_fn)
        got = pd.p_mean_variance(pfn, torch.from_numpy(x), torch.from_numpy(t), clip_denoised=clip,
                                 denoised_fn=denoised_fn)
        assert set(got) == set(want)
        _close(got, want)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_and_reverse_match_jax(eta):
    jd, pd = _both()
    jfn, pfn = _model_fns()
    x = _x(seed=3, scale=0.5)
    rng = jax.random.PRNGKey(1)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, x.shape, jnp.float32)))
    for i in (0, 2, STEPS - 1):
        t = np.array([i, i])
        _close(pd.ddim_sample(pfn, torch.from_numpy(x), torch.from_numpy(t), noise, eta=eta),
               jd.ddim_sample(jfn, jnp.asarray(x), jnp.asarray(t), rng, eta=eta))
        _close(pd.ddim_reverse_sample(pfn, torch.from_numpy(x), torch.from_numpy(t)),
               jd.ddim_reverse_sample(jfn, jnp.asarray(x), jnp.asarray(t)))
    with pytest.raises(ValueError, match="eta"):
        pd.ddim_reverse_sample(pfn, torch.from_numpy(x), torch.from_numpy(t), eta=0.5)


def test_ddim_reverse_then_forward_roundtrip():
    """ddim_reverse_sample then ddim_sample (eta 0) invert each other under a
    deterministic model (mirror of tests/test_diffusion_extras.py), at the
    JAX test's tolerance."""
    pd = create_diffusion("10")

    def zero_eps(x, t):
        return torch.zeros(x.shape[:-1] + (2 * x.shape[-1],))

    x = torch.from_numpy(_x((2, 6, 2), seed=4, scale=0.3))
    t = torch.tensor([4, 4])
    fwd = pd.ddim_reverse_sample(zero_eps, x, t, clip_denoised=False)
    back = pd.ddim_sample(zero_eps, fwd["sample"], t + 1, torch.randn(x.shape),
                          clip_denoised=False, eta=0.0)
    np.testing.assert_allclose(back["sample"].numpy(), x.numpy(), rtol=1e-3, atol=1e-4)


def _jax_loop_draws(rng):
    keys = jax.random.split(rng, STEPS)
    return lambda k, shape: torch.from_numpy(np.array(jax.random.normal(keys[k], shape, jnp.float32)))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_loop_matches_jax(eta):
    jd, pd = _both()
    jfn, pfn = _model_fns()
    z = _x(seed=5)
    rng = jax.random.PRNGKey(2)
    want = jd.ddim_sample_loop(jfn, z.shape, rng, noise=jnp.asarray(z), eta=eta,
                               denoised_fn=lambda x0: x0 * 0.9)
    got = pd.ddim_sample_loop(pfn, torch.from_numpy(z), noise_fn=_jax_loop_draws(rng), eta=eta,
                              denoised_fn=lambda x0: x0 * 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


@pytest.mark.parametrize("clip", [True, False])
def test_progressive_frames_match_jax(clip):
    """p_sample_loop_progressive: every frame against JAX's; the progressive
    chain's last frame is p_sample_loop's result."""
    jd, pd = _both()
    jfn, pfn = _model_fns()
    z = _x(seed=6)
    rng = jax.random.PRNGKey(3)
    frames = pd.p_sample_loop_progressive(pfn, torch.from_numpy(z), noise_fn=_jax_loop_draws(rng),
                                          clip_denoised=clip)
    want = jd.p_sample_loop_progressive(jfn, z.shape, rng, noise=jnp.asarray(z), clip_denoised=clip)
    assert frames.shape == (STEPS, *z.shape)
    np.testing.assert_allclose(frames.numpy(), np.asarray(want), **CHAIN_TOL)
    last = pd.p_sample_loop(pfn, torch.from_numpy(z), noise_fn=_jax_loop_draws(rng),
                            clip_denoised=clip)
    np.testing.assert_array_equal(last.numpy(), frames[-1].numpy())


def test_progressive_draws_from_the_generator_like_the_loop():
    """With a generator (no noise_fn) the progressive chain draws what
    p_sample_loop draws: the same final sample from the same seed."""
    pd = create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2")
    _, pfn = _model_fns()
    z = torch.from_numpy(_x(seed=7))
    frames = pd.p_sample_loop_progressive(pfn, z, generator=torch.Generator().manual_seed(1))
    last = pd.p_sample_loop(pfn, z, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(frames[-1].numpy(), last.numpy())
