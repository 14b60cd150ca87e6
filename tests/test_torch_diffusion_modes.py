"""The port's diffusion beyond the trainer's parameterization, against the
JAX package's, on the CPU (f32 on both sides, the same numpy inputs):

- every (mean, variance, loss) combination the factories' flags produce,
  and the branches only `replace` reaches (xprev, learned, plain kl): the
  fields, training_losses' terms and their gradients through a closed-form
  model with weights and a model kwarg;
- p_mean_variance, p_sample and ddim_sample under each mean and variance
  type; cond_fn through condition_mean (ancestral) and condition_score
  (DDIM and its reverse step), alone and in the three chains with JAX's
  per-step draws;
- q_mean_variance and continuous_gaussian_log_likelihood; calc_bpd_loop
  with JAX's draws fed through noise_fn, on the closed-form model and on a
  small DiT with learn_sigma=False (2 blocks, hidden 64, one head) whose
  weights cross by the JAX package's params_to_torch_state_dict; its step
  program (`BpdProgram`) against the eager step loop it replaced, bit for
  bit, on both;
- forward_with_cfg on that DiT against JAX's, and the Sampler (ancestral
  and DDIM, the Δ-cache, the int8 blocks) on it under the fixed variances;
- train_step with use_kl, and with predict_xstart on a DiT with
  learn_sigma=False, against make_train_step (tests/test_torch_train.py's
  two-step comparison and tolerances);
- the JAX package's own cases of tests/test_diffusion.py and
  tests/test_diffusion_extras.py for this surface, on the port.

Tolerances: one step rtol 1e-5 / atol 1e-6 (f32 in another order); a loss
term rtol 3e-5 (the decoder NLL at t = 0 with x0 on a bin's edge, ~33 bits
from CDF differences near 1, was measured 1.01e-5 apart; the rescaled KL is
x num_timesteps, so its atol scales with it); gradients 2e-4 of each
tensor's largest entry (the KL losses under x0 prediction differentiate
that NLL's log of a CDF difference, measured up to 9e-5 apart; every other
case within 2e-5); chains rtol 1e-4 / atol 1e-5 (a chain's 1/sqrt(alpha_bar)
coefficients amplify a step's rounding); bpd rtol 1e-4 (the t = 0 decoder
NLL under the fixed small variance, ~40 bits, measured 6.3e-5 apart), and
through the DiT 1e-4 of each entry's largest value (the DiT's f32 sums in
another order).
Torch's intra-op threads are capped at 2 while the module runs (see
tests/test_torch_bench.py: a train step crawls beside busy workers).
"""
import copy
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _check_two_train_steps

from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
TERM_RTOL = 3e-5
CHAIN_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_TOL = 2e-4
BPD_RTOL = 1e-4
DIT_BPD_REL_TOL = 1e-4
STEPS = 10
MEAN_TYPES = ("epsilon", "xstart", "xprev")
VAR_TYPES = ("learned", "learned_range", "fixed_small", "fixed_large")

# the factories' flags, each group's settings: every combination below is
# one (loss, mean, variance) triple of the JAX factory
LOSS_FLAGS = {"mse": {}, "l1": dict(use_l1=True), "rescaled_mse": dict(rescale_learned_sigmas=True),
              "rescaled_l1": dict(rescale_learned_sigmas=True, use_l1=True),
              "rescaled_kl": dict(use_kl=True)}
MEAN_FLAGS = {"epsilon": {}, "xstart": dict(predict_xstart=True)}
VAR_FLAGS = {"learned_range": {}, "fixed_small": dict(learn_sigma=False, sigma_small=True),
             "fixed_large": dict(learn_sigma=False)}
FACTORY_CASES = list(itertools.product(LOSS_FLAGS, MEAN_FLAGS, VAR_FLAGS))
# the types no flag reaches, set by replacing the fields of a factory's process
REPLACED_CASES = [("kl", "epsilon", "learned_range"), ("kl", "xprev", "fixed_small"),
                  ("mse", "xprev", "learned"), ("rescaled_l1", "xprev", "learned"),
                  ("l1", "epsilon", "learned")]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Torch's intra-op threads at 2 while this module runs, then as they were."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _processes(respacing, loss="mse", mean="epsilon", var="learned_range"):
    """(JAX's, the port's) process of that parameterization: by the
    factories' flags where they reach it, else by replacing the fields."""
    if (loss, mean, var) in FACTORY_CASES:
        kw = {**LOSS_FLAGS[loss], **MEAN_FLAGS[mean], **VAR_FLAGS[var]}
        jd = jax_create(respacing, noise_schedule="squaredcos_cap_v2", **kw)
        pd = create_diffusion(respacing, noise_schedule="squaredcos_cap_v2", **kw)
    else:
        fields = dict(loss_type=loss, model_mean_type=mean, model_var_type=var)
        jd = jax_create(respacing, noise_schedule="squaredcos_cap_v2").replace(**fields)
        pd = dataclasses.replace(create_diffusion(respacing, noise_schedule="squaredcos_cap_v2"),
                                 **fields)
    return jd, pd


def _learned(d) -> bool:
    return d.model_var_type in ("learned", "learned_range")


def _weights(seed=0):
    r = np.random.RandomState(seed)
    return [(0.8 * r.randn(2, 2)).astype(np.float32) for _ in range(2)]


def _jax_model(w, learned):
    """The closed-form model: scale * tanh(x w0 + t / 1000), then (learned
    variance) 0.5 sin(x w1); `scale` is a model kwarg."""
    def fn(x, t, scale=1.0):
        mean = scale * jnp.tanh(x @ w[0] + t[:, None, None] / 1000.0)
        return jnp.concatenate([mean, 0.5 * jnp.sin(x @ w[1])], -1) if learned else mean

    return fn


def _port_model(w, learned):
    def fn(x, t, scale=1.0):
        mean = scale * torch.tanh(x @ w[0] + t[:, None, None] / 1000.0)
        return torch.cat([mean, 0.5 * torch.sin(x @ w[1])], -1) if learned else mean

    return fn


def _models(d_jax, d_port, seed=0):
    w = _weights(seed)
    return (_jax_model([jnp.asarray(a) for a in w], _learned(d_jax)),
            _port_model([torch.from_numpy(a) for a in w], _learned(d_port)))


def _cond_fns():
    """cond_fn(x, mapped t, scale): a gradient pulling x toward 0.25."""
    def jax_cond(x, t, scale=1.0):
        return -0.3 * scale * (x - 0.25) * (1.0 + t[:, None, None] / 1000.0)

    def port_cond(x, t, scale=1.0):
        return -0.3 * scale * (x - 0.25) * (1.0 + t[:, None, None] / 1000.0)

    return jax_cond, port_cond


def _x(shape=(2, 12, 2), seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _jnoise(rng, shape):
    return np.array(jax.random.normal(rng, shape, jnp.float32))


def _loop_draws(keys):
    """The JAX loops' per-step draws (step k from keys[k]) as noise_fn."""
    return lambda k, shape: torch.from_numpy(_jnoise(keys[k], shape))


def _close(port_out, jax_out, tol=STEP_TOL, keys=None):
    for key in keys or jax_out:
        np.testing.assert_allclose(np.broadcast_to(port_out[key].detach().numpy(), jax_out[key].shape),
                                   np.asarray(jax_out[key]), **tol, err_msg=key)


# -- the factory and the training losses ---------------------------------------


@pytest.mark.parametrize("loss,mean,var", FACTORY_CASES + REPLACED_CASES,
                         ids=["-".join(c) for c in FACTORY_CASES + REPLACED_CASES])
def test_training_losses_match_jax(loss, mean, var):
    """The fields, the terms (only "loss" under the KLs; "vb" only with a
    learned variance) and the gradient of the mean loss in the model's
    weights (the VLB's detached mean included), with model_kwargs, at x0
    reaching the decoder's outer bins and t = 0 (the decoder NLL) to S-1.
    100 steps, so that the rescaled losses' num_timesteps / 1000 is 0.1."""
    jd, pd = _processes("100", loss, mean, var)
    assert (pd.loss_type, pd.model_mean_type, pd.model_var_type) == \
        (jd.loss_type, jd.model_mean_type, jd.model_var_type) == (loss, mean, var)
    r = np.random.RandomState(1)
    x0 = (r.rand(4, 12, 2) * 2.2 - 1.1).astype(np.float32)
    noise = r.randn(4, 12, 2).astype(np.float32)
    t = np.array([0, 1, 50, 99])
    w = _weights(2)
    kwargs = dict(scale=0.9)

    def jax_loss(jw):
        terms = jd.training_losses(_jax_model(jw, _learned(jd)), jnp.asarray(x0), jnp.asarray(t),
                                   jnp.asarray(noise), model_kwargs=kwargs)
        return terms["loss"].mean(), terms

    (_, want), want_grads = jax.value_and_grad(jax_loss, has_aux=True)([jnp.asarray(a) for a in w])
    tw = [torch.from_numpy(a).requires_grad_(True) for a in w]
    got = pd.training_losses(_port_model(tw, _learned(pd)), torch.from_numpy(x0), torch.from_numpy(t),
                             torch.from_numpy(noise), model_kwargs=kwargs)
    assert set(got) == set(want)
    if loss.endswith("kl"):
        assert set(got) == {"loss"}
    else:
        assert ("vb" in got) == _learned(pd)
    scale = pd.num_timesteps if loss == "rescaled_kl" else 1.0
    _close(got, want, tol=dict(rtol=TERM_RTOL, atol=STEP_TOL["atol"] * scale))
    got["loss"].mean().backward()
    for i, (g, wg) in enumerate(zip(tw, want_grads)):
        wg = np.asarray(wg)
        g = np.zeros_like(wg) if g.grad is None else g.grad.numpy()
        assert np.abs(g - wg).max() <= GRAD_REL_TOL * max(np.abs(wg).max(), 1e-6), (i, g, wg)


# -- the steps, guidance and the chains ----------------------------------------


@pytest.mark.parametrize("var", VAR_TYPES)
@pytest.mark.parametrize("mean", MEAN_TYPES)
def test_steps_match_jax(mean, var):
    """p_mean_variance (every entry, "variance" included), p_sample and
    ddim_sample (eta 0.5) at t = 0, 4 and S-1 with model_kwargs, the step's
    noise JAX's draw."""
    jd, pd = _processes(str(STEPS), "mse", mean, var)
    jfn, pfn = _models(jd, pd)
    x = _x(seed=3)
    kwargs = dict(scale=0.8)
    rng = jax.random.PRNGKey(1)
    noise = torch.from_numpy(_jnoise(rng, x.shape))
    for i in (0, 4, STEPS - 1):
        t = np.array([i, i])
        jx, jt, px, pt = jnp.asarray(x), jnp.asarray(t), torch.from_numpy(x), torch.from_numpy(t)
        want = jd.p_mean_variance(jfn, jx, jt, model_kwargs=kwargs)
        got = pd.p_mean_variance(pfn, px, pt, model_kwargs=kwargs)
        assert set(got) == set(want)
        _close(got, want)
        _close(pd.p_sample(pfn, px, pt, noise, model_kwargs=kwargs),
               jd.p_sample(jfn, jx, jt, rng, model_kwargs=kwargs))
        _close(pd.ddim_sample(pfn, px, pt, noise, model_kwargs=kwargs, eta=0.5),
               jd.ddim_sample(jfn, jx, jt, rng, model_kwargs=kwargs, eta=0.5))


@pytest.mark.parametrize("var", ["learned_range", "fixed_large"])
def test_guidance_matches_jax(var):
    """cond_fn with model_kwargs: condition_mean and condition_score alone,
    and through p_sample (the mean), ddim_sample and ddim_reverse_sample
    (the score); the guided mean moves toward the gradient (the JAX
    package's own checks)."""
    jd, pd = _processes(str(STEPS), "mse", "epsilon", var)
    jfn, pfn = _models(jd, pd)
    jcond, pcond = _cond_fns()
    x = _x(seed=4)
    kwargs = dict(scale=1.5)
    rng = jax.random.PRNGKey(2)
    noise = torch.from_numpy(_jnoise(rng, x.shape))
    for i in (0, 5, STEPS - 1):
        t = np.array([i, i])
        jx, jt, px, pt = jnp.asarray(x), jnp.asarray(t), torch.from_numpy(x), torch.from_numpy(t)
        jbase = jd.p_mean_variance(jfn, jx, jt, model_kwargs=kwargs)
        pbase = pd.p_mean_variance(pfn, px, pt, model_kwargs=kwargs)
        guided = pd.condition_mean(pcond, pbase, px, pt, kwargs)
        np.testing.assert_allclose(guided.numpy(), np.asarray(jd.condition_mean(jcond, jbase, jx, jt, kwargs)),
                                   **STEP_TOL)
        moved = (guided - pbase["mean"]) * pcond(px, pd.timestep_map[pt], **kwargs)
        assert (moved >= 0).all() and (moved > 0).any()
        _close(pd.condition_score(pcond, pbase, px, pt, kwargs),
               jd.condition_score(jcond, jbase, jx, jt, kwargs))
        for name, extra in (("p_sample", {}), ("ddim_sample", dict(eta=0.5))):
            _close(getattr(pd, name)(pfn, px, pt, noise, cond_fn=pcond, model_kwargs=kwargs, **extra),
                   getattr(jd, name)(jfn, jx, jt, rng, cond_fn=jcond, model_kwargs=kwargs, **extra))
        _close(pd.ddim_reverse_sample(pfn, px, pt, cond_fn=pcond, model_kwargs=kwargs),
               jd.ddim_reverse_sample(jfn, jx, jt, cond_fn=jcond, model_kwargs=kwargs))


@pytest.mark.parametrize("loop,var", [("p_sample_loop", "fixed_small"),
                                      ("p_sample_loop_progressive", "learned"),
                                      ("ddim_sample_loop", "fixed_large")])
def test_guided_chains_match_jax(loop, var):
    """The three chains with cond_fn and model_kwargs from the same x_T,
    JAX's per-step draws fed through noise_fn."""
    jd, pd = _processes(str(STEPS), "mse", "epsilon", var)
    jfn, pfn = _models(jd, pd)
    jcond, pcond = _cond_fns()
    z = _x(seed=5)
    kwargs = dict(scale=1.2)
    rng = jax.random.PRNGKey(3)
    want = getattr(jd, loop)(jfn, z.shape, rng, noise=jnp.asarray(z), cond_fn=jcond,
                             model_kwargs=kwargs)
    got = getattr(pd, loop)(pfn, torch.from_numpy(z), noise_fn=_loop_draws(jax.random.split(rng, STEPS)),
                            cond_fn=pcond, model_kwargs=kwargs)
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


# -- the likelihood --------------------------------------------------------------


def test_q_mean_variance_matches_jax():
    """(mean, variance, log variance) at t = 0 .. 999; the JAX package's
    checks: the mean at t = 0 is sqrt(1 - beta_0) x0 and the variance the
    exp of the log variance (on its linear schedule)."""
    jd, pd = jax_create(""), create_diffusion("")
    x0 = _x((4, 3, 2), seed=6)
    t = np.array([0, 1, 500, 999])
    want = jd.q_mean_variance(jnp.asarray(x0), jnp.asarray(t))
    got = pd.q_mean_variance(torch.from_numpy(x0), torch.from_numpy(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.broadcast_to(g.numpy(), w.shape), np.asarray(w), **STEP_TOL)
    np.testing.assert_allclose(got[0][0].numpy(), np.sqrt(1 - pd.betas[0].item()) * x0[0], rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.exp(got[2].numpy()), rtol=5e-4)


def test_continuous_gaussian_log_likelihood_matches_jax():
    from osu_diffusion_tpu.diffusion.process import continuous_gaussian_log_likelihood as jax_ll
    from osu_diffusion_tpu_torch.diffusion.process import continuous_gaussian_log_likelihood

    x, means, log_scales = (_x((2, 12, 2), seed=s) for s in (11, 12, 13))
    want = jax_ll(jnp.asarray(x), means=jnp.asarray(means), log_scales=jnp.asarray(log_scales))
    got = continuous_gaussian_log_likelihood(torch.from_numpy(x), means=torch.from_numpy(means),
                                             log_scales=torch.from_numpy(log_scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


def _check_bpd(got, want, rel_tol=None):
    """calc_bpd_loop's five entries against JAX's: at BPD_RTOL, or within
    rel_tol of each entry's largest value."""
    assert set(got) == set(want) == {"total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"}
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.shape == w.shape, key
        if rel_tol is None:
            np.testing.assert_allclose(g, w, rtol=BPD_RTOL, atol=STEP_TOL["atol"], err_msg=key)
        else:
            assert np.abs(g - w).max() <= rel_tol * np.abs(w).max(), (key, g, w)


@pytest.mark.parametrize("mean,var", [("epsilon", "learned_range"), ("xstart", "fixed_small"),
                                      ("xprev", "fixed_large")])
def test_calc_bpd_loop_matches_jax(mean, var):
    """Every entry, the (N, S) arrays in descending-t order; the last column
    (t = 0) is the decoder NLL with 1/255 bins, checked on its own against
    the discretized likelihood of x0 under p's mean at t = 0."""
    from osu_diffusion_tpu_torch.diffusion.process import discretized_gaussian_log_likelihood

    steps = 5
    jd, pd = _processes(str(steps), "mse", mean, var)
    jfn, pfn = _models(jd, pd)
    x0 = np.clip(_x((3, 12, 2), seed=7, scale=0.6), -1, 1)
    kwargs = dict(scale=0.7)
    rng = jax.random.PRNGKey(4)
    want = jd.calc_bpd_loop(jfn, jnp.asarray(x0), rng, model_kwargs=kwargs)
    keys = jax.random.split(rng, steps)
    got = pd.calc_bpd_loop(pfn, torch.from_numpy(x0), noise_fn=_loop_draws(keys), model_kwargs=kwargs)
    _check_bpd(got, want)
    assert got["vb"].shape == (3, steps)
    np.testing.assert_allclose(got["total_bpd"].numpy(),
                               (got["vb"].sum(1) + got["prior_bpd"]).numpy(), rtol=1e-6)
    # t = 0: the decoder NLL at step S-1's draw
    t0 = torch.zeros(3, dtype=torch.long)
    x_t = pd.q_sample(torch.from_numpy(x0), t0, _loop_draws(keys)(steps - 1, x0.shape))
    out = pd.p_mean_variance(pfn, x_t, t0, model_kwargs=kwargs)
    nll = -discretized_gaussian_log_likelihood(torch.from_numpy(x0), means=out["mean"],
                                               log_scales=0.5 * out["log_variance"])
    np.testing.assert_allclose(got["vb"][:, -1].numpy(), (nll.mean(dim=(1, 2)) / np.log(2.0)).numpy(),
                               rtol=1e-6)


def _bpd_step_loop(d, model_fn, x_start, generator=None, noise_fn=None, model_kwargs=None):
    """calc_bpd_loop as the port ran it before its step program: a Python
    loop of eager steps, a fresh t and draw each step, the columns stacked."""
    from osu_diffusion_tpu_torch.diffusion.process import draw_noise, mean_flat

    vb, xstart_mse, mse = [], [], []
    with torch.no_grad():
        for k, i in enumerate(range(d.num_timesteps - 1, -1, -1)):
            t = torch.full((x_start.shape[0],), i, dtype=torch.long)
            noise = draw_noise(k, x_start, generator, noise_fn)
            x_t = d.q_sample(x_start, t, noise)
            out = d._vb_terms_bpd(model_fn, x_start, x_t, t, model_kwargs=model_kwargs)
            eps = d._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - noise) ** 2))
        vb, xstart_mse, mse = (torch.stack(a, dim=1) for a in (vb, xstart_mse, mse))
        prior_bpd = d._prior_bpd(x_start)
    return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd, "vb": vb,
            "xstart_mse": xstart_mse, "mse": mse}


def _check_bpd_bits(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("noise", ["generator", "noise_fn"])
@pytest.mark.parametrize("mean,var", [("epsilon", "learned_range"), ("xstart", "fixed_small"),
                                      ("xprev", "fixed_large")])
def test_calc_bpd_loop_program_equals_the_step_loop(mean, var, noise):
    """The step program (`BpdProgram`, its outputs copied into column k)
    gives the eager step loop's five entries bit for bit, with
    cuda_graph=True (eager on the CPU) and False, by both noise sources."""
    steps = 5
    jd, pd = _processes(str(steps), "mse", mean, var)
    _, pfn = _models(jd, pd)
    x0 = torch.from_numpy(np.clip(_x((3, 12, 2), seed=7, scale=0.6), -1, 1))
    kwargs = dict(scale=0.7)

    def draws():
        if noise == "generator":
            return dict(generator=torch.Generator().manual_seed(3))
        return dict(noise_fn=lambda k, shape: torch.from_numpy(_x(shape, seed=50 + k)))

    want = _bpd_step_loop(pd, pfn, x0, model_kwargs=kwargs, **draws())
    for cuda_graph in (True, False):
        _check_bpd_bits(pd.calc_bpd_loop(pfn, x0, model_kwargs=kwargs, cuda_graph=cuda_graph, **draws()),
                        want)


# -- a small DiT with C output channels ------------------------------------------

DIT = dict(hidden_size=64, depth=2, num_heads=1, num_classes=7, context_size=144)
BAND, BUCKET, T_REAL = 16, 16, 40
SPAN = (1, 2)


@pytest.fixture(scope="module")
def dit():
    """(JAX DiT, params, port DiT) with learn_sigma=False: flax-initialized,
    the adaLN and final layers perturbed (adaLN-Zero would gate the blocks
    out), the weights crossing by the JAX package's
    params_to_torch_state_dict."""
    from osu_diffusion_tpu.models.dit import DiT as JaxDiT
    from osu_diffusion_tpu.models.dit import DiTConfig
    from osu_diffusion_tpu.train.checkpoint import params_to_torch_state_dict
    from osu_diffusion_tpu_torch.models.dit import DiT

    jm = JaxDiT(DiTConfig(**DIT, learn_sigma=False))
    ctx = DIT["context_size"]
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1, 8)), jnp.zeros((1, 8, ctx)), jnp.zeros((1,), jnp.int32))["params"]
    r = np.random.RandomState(100)

    def perturb(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        a = np.array(leaf)
        if "adaLN" in names or ("final_layer" in names and "linear" in names):
            a = a + (0.05 * r.randn(*a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    port = DiT(**DIT, learn_sigma=False, matmul_dtype=torch.float32)
    sd = params_to_torch_state_dict(params, num_label_rows=DIT["num_classes"] + 1)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return jm, params, port.eval()


def _dit_inputs(n=2, t=T_REAL, seed=8, cfg=False):
    """numpy (x0 or z, o, c, y); with `cfg` the doubled batch sharing x,
    labels [1 .. | null]."""
    r = np.random.RandomState(seed)
    half = n // 2 if cfg else n
    x = np.clip(r.randn(half, t, 2) * 0.5, -1, 1).astype(np.float32)
    o = np.cumsum(r.rand(1, t) * 300, axis=1).astype(np.float32).repeat(half, 0)
    c = r.rand(1, t, DIT["context_size"]).astype(np.float32).repeat(half, 0)
    y = r.randint(0, DIT["num_classes"], half)
    if cfg:
        x, o, c = (np.concatenate([a, a]) for a in (x, o, c))
        y = np.concatenate([y, np.full(half, DIT["num_classes"])])
    return x, o, c, y


def test_calc_bpd_loop_through_a_dit_matches_jax(dit):
    """calc_bpd_loop over 4 steps through the 2-block DiT's plain forward
    (full attention, C output channels) under fixed_small, JAX's draws fed
    through noise_fn (the learned variances' bpd:
    test_calc_bpd_loop_matches_jax, and chip_smoke.py's [bpd] through the
    DiT-B kernels)."""
    jm, params, port = dit
    steps = 4
    kw = dict(learn_sigma=False, sigma_small=True)
    jd = jax_create(str(steps), noise_schedule="squaredcos_cap_v2", **kw)
    pd = create_diffusion(str(steps), noise_schedule="squaredcos_cap_v2", **kw)
    x0, o, c, y = _dit_inputs()
    jfwd = jax.jit(lambda x, t: jm.apply({"params": params}, x, t, jnp.asarray(o), jnp.asarray(c),
                                         jnp.asarray(y, jnp.int32)))
    rng = jax.random.PRNGKey(5)
    want = jd.calc_bpd_loop(jfwd, jnp.asarray(x0), rng)

    def pfwd(x, t):
        return port(x, t, torch.from_numpy(o), torch.from_numpy(c), torch.from_numpy(y))

    got = pd.calc_bpd_loop(pfwd, torch.from_numpy(x0), noise_fn=_loop_draws(jax.random.split(rng, steps)))
    assert got["vb"].shape == (2, steps)
    assert all(torch.isfinite(v).all() for v in got.values())
    _check_bpd(got, want, rel_tol=DIT_BPD_REL_TOL)


def test_calc_bpd_loop_program_through_a_dit_equals_the_step_loop(dit):
    """Through the 2-block DiT with a band and a valid_len (the model
    forward [bpd] runs on the card), the step program's five entries are
    the eager step loop's bits."""
    port = dit[2]
    pd = create_diffusion("4", noise_schedule="squaredcos_cap_v2", learn_sigma=False, sigma_small=True)
    x0, o, c, y = (torch.from_numpy(a) for a in _dit_inputs(t=48))

    def pfwd(x, t):
        return port(x, t, o, c, y, band=BAND, valid_len=T_REAL)

    want = _bpd_step_loop(pd, pfwd, x0, generator=torch.Generator().manual_seed(9))
    got = pd.calc_bpd_loop(pfwd, x0, generator=torch.Generator().manual_seed(9))
    _check_bpd_bits(got, want)


def test_forward_with_cfg_without_learn_sigma_matches_jax(dit):
    """The guided forward with C output channels: (N, T, 2), the two halves
    equal (guidance on every channel), against JAX's within 1e-5 of the
    largest value."""
    jm, params, port = dit
    x, o, c, y = _dit_inputs(n=4, cfg=True)
    t = np.array([10, 500, 10, 500])
    guided = jax.jit(lambda *a: jm.apply({"params": params}, *a, cfg_scale=2.0, method=jm.forward_with_cfg))
    want = np.asarray(guided(jnp.asarray(x), jnp.asarray(t), jnp.asarray(o), jnp.asarray(c),
                             jnp.asarray(y, jnp.int32)))
    with torch.no_grad():
        got = port.forward_with_cfg(*(torch.from_numpy(a) for a in (x, t, o, c, y)), 2.0).numpy()
    assert got.shape == want.shape == (4, T_REAL, 2)
    np.testing.assert_array_equal(got[:2], got[2:])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _sampler(model, var, **kw):
    """The Sampler over a 6-step process under the fixed variance `var`,
    CFG 2, band and bucket 16."""
    from osu_diffusion_tpu_torch.sampling import Sampler

    diffusion = create_diffusion("6", noise_schedule="squaredcos_cap_v2", learn_sigma=False,
                                 sigma_small=var == "fixed_small")
    return Sampler(model, diffusion, cfg_scale=2.0, band=BAND, bucket=BUCKET, **kw)


@pytest.mark.parametrize("var", ["fixed_small", "fixed_large"])
@pytest.mark.parametrize("method", ["ancestral", "ddim"])
def test_sampler_fixed_variance_is_the_process_chain(dit, method, var):
    """The Sampler's chain on the learn_sigma=False DiT under a fixed
    variance is the process's own loop over the padded forward_with_cfg,
    bit for bit; the ancestral chain adds the variance's noise (it differs
    from DDIM's, and between the two variances). Its parts are held against
    JAX: the steps under each variance by test_steps_match_jax, the C-channel
    forward by test_forward_with_cfg_without_learn_sigma_matches_jax. The
    chain itself is not: at t = 999 its x0 prediction multiplies a forward's
    f32 rounding by ~2e4 before the clamp: a 1e-6 relative nudge of this
    DiT's forward moved a 6-step chain by up to 0.04, and the two packages'
    DDIM chains were measured up to 0.22 apart at one input."""
    port = dit[2]
    sampler = _sampler(port, var, method=method)
    z, o, c, y = (torch.from_numpy(a) for a in _dit_inputs(n=4, seed=3, cfg=True))
    got = sampler(z, o, c, y, generator=torch.Generator().manual_seed(1))
    zp, op, cp = (torch.nn.functional.pad(a, [0, 0] * (a.ndim - 2) + [0, 48 - T_REAL]) for a in (z, o, c))

    def model_fn(x, t):
        return port.forward_with_cfg(x, t, op, cp, y, 2.0, band=BAND, valid_len=T_REAL)

    loop = sampler.diffusion.ddim_sample_loop if method == "ddim" else sampler.diffusion.p_sample_loop
    with torch.no_grad():
        want = loop(model_fn, zp, generator=torch.Generator().manual_seed(1))
    assert got.shape == z.shape and torch.isfinite(got).all()
    assert torch.equal(got, want[:, :T_REAL])
    if method == "ancestral":
        other = "fixed_large" if var == "fixed_small" else "fixed_small"
        for kw in (dict(method="ddim"), dict(var=other)):
            s = _sampler(port, kw.get("var", var), method=kw.get("method", method))
            assert not torch.allclose(got, s(z, o, c, y, generator=torch.Generator().manual_seed(1)))


def test_int8_and_delta_cache_samplers_fixed_variance(dit):
    """The int8 blocks (--quantize-weights) on the learn_sigma=False DiT
    under fixed_small: one forward with C channels within 2e-2 of the f32
    forward's largest value (the int8 weights' rounding); the exact and the
    Δ-cache (interval 2, span (1, 2)) chains of the int8 and the f32 model
    finite and repeatable bit for bit, a Δ-cache chain with 4 full steps of
    6 (a chain is as sensitive to the forward as
    test_sampler_fixed_variance_is_the_process_chain says, so none is held
    against another)."""
    from osu_diffusion_tpu_torch.models.dit import DiT
    from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict

    port = dit[2]
    qmodel = DiT(**DIT, learn_sigma=False, quant=True)
    qmodel.load_state_dict(quantize_state_dict(port.state_dict()))
    qmodel.eval()
    x, o, c, y = (torch.from_numpy(a) for a in _dit_inputs(n=4, seed=10, cfg=True))
    t = torch.tensor([10, 500, 10, 500])
    with torch.no_grad():
        f32, q = (m.forward_with_cfg(x, t, o, c, y, 2.0, band=BAND) for m in (port, qmodel))
    assert q.shape == f32.shape == (4, T_REAL, 2)
    assert (q - f32).abs().max() <= 2e-2 * f32.abs().max()
    for model, kw in ((qmodel, {}), (qmodel, dict(accel_interval=2, accel_span=SPAN)),
                      (port, dict(accel_interval=2, accel_span=SPAN))):
        sampler = _sampler(model, "fixed_small", **kw)
        out = sampler(x, o, c, y, generator=torch.Generator().manual_seed(3))
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert torch.equal(sampler(x, o, c, y, generator=torch.Generator().manual_seed(3)), out)
        if kw:
            assert sampler.last_full_model_steps == 4


# -- the train step --------------------------------------------------------------


@pytest.mark.parametrize("case", ["use_kl", "predict_xstart"])
def test_train_steps_match_jax(case):
    """Two AdamW + EMA steps against make_train_step, as
    tests/test_torch_train.py's test_two_train_steps_match_jax (its
    tolerances: metrics rtol 1e-5, params and EMA 5e-6), at hidden 64 with
    one head: the rescaled KL (the metrics only "loss"), and x0 prediction
    on a DiT with learn_sigma=False (C output channels, fixed_large, L1)."""
    if case == "use_kl":
        _check_two_train_steps(diffusion_kw=dict(use_kl=True), keys=("loss",), hidden=64, heads=1)
    else:
        _check_two_train_steps(diffusion_kw=dict(predict_xstart=True, learn_sigma=False, use_l1=True),
                               keys=("loss", "l1"), hidden=64, heads=1, learn_sigma=False)


# -- the JAX package's own cases, on the port --------------------------------------


def _zero_model(x, t, **_):
    return torch.zeros(x.shape[:-1] + (2 * x.shape[-1],))


def test_timestep_map_and_model_kwargs_reach_the_model():
    """Local step 9 of 10 reaches the model as its original timestep (> 900),
    with the model kwargs."""
    pd = create_diffusion("10")
    seen = []

    def spy(x, t, **kw):
        seen.append((int(t[0]), kw))
        return _zero_model(x, t)

    pd.p_mean_variance(spy, torch.zeros(1, 2, 2), torch.tensor([9]), model_kwargs=dict(tag=1))
    assert seen == [(int(pd.timestep_map[9]), dict(tag=1))] and seen[0][0] > 900


def test_loss_terms_of_the_jax_cases():
    """tests/test_diffusion.py's loss cases: L1 with the VLB (a zero-eps
    model's l1 is mean |noise|, loss = l1 + vb); MSE without learn_sigma
    (no vb, a zero output against noise 0.5 gives 0.25); the rescaled L1's
    VLB is 0.1 of the plain one at 100 steps; the rescaled KL gives finite
    per-sample losses."""
    r = np.random.RandomState(0)
    x0 = torch.from_numpy(r.randn(3, 8, 2).astype(np.float32))
    noise = torch.from_numpy(r.randn(3, 8, 2).astype(np.float32))
    t = torch.tensor([0, 500, 999])
    terms = create_diffusion("", use_l1=True).training_losses(_zero_model, x0, t, noise)
    assert set(terms) == {"l1", "vb", "loss"}
    torch.testing.assert_close(terms["l1"], noise.abs().mean(dim=(1, 2)), rtol=1e-5, atol=0)
    torch.testing.assert_close(terms["loss"], terms["l1"] + terms["vb"])

    terms = create_diffusion("", learn_sigma=False).training_losses(
        lambda x, t: torch.zeros_like(x), torch.ones(2, 4, 2), torch.tensor([3, 700]),
        torch.full((2, 4, 2), 0.5))
    assert "vb" not in terms
    torch.testing.assert_close(terms["mse"], torch.full((2,), 0.25))

    x1, z1, t1 = torch.ones(1, 4, 2), torch.zeros(1, 4, 2), torch.tensor([50])
    rescaled = create_diffusion("100", use_l1=True, rescale_learned_sigmas=True)
    plain = create_diffusion("100", use_l1=True)
    assert rescaled.loss_type == "rescaled_l1"
    torch.testing.assert_close(rescaled.training_losses(_zero_model, x1, t1, z1)["vb"],
                               plain.training_losses(_zero_model, x1, t1, z1)["vb"] * 0.1)

    kl = create_diffusion("", use_kl=True)
    assert kl.loss_type == "rescaled_kl"
    loss = kl.training_losses(_zero_model, torch.zeros(2, 4, 2), torch.tensor([5, 500]),
                              torch.zeros(2, 4, 2))["loss"]
    assert loss.shape == (2,) and torch.isfinite(loss).all()


@pytest.mark.parametrize("sigma_small", [True, False])
def test_fixed_variance_modes(sigma_small):
    """tests/test_diffusion_extras.py's case: the type the flags name, a
    (1, 1, 1) variance, the posterior's at most the large one."""
    d = create_diffusion("10", learn_sigma=False, sigma_small=sigma_small)
    assert d.model_var_type == ("fixed_small" if sigma_small else "fixed_large")
    x, t = torch.ones(1, 4, 2), torch.tensor([3])

    def variance(dd):
        return dd.p_mean_variance(lambda xx, tt: torch.zeros_like(xx), x, t)["variance"]

    assert variance(d).shape == (1, 1, 1)
    small = variance(create_diffusion("10", learn_sigma=False, sigma_small=True))
    large = variance(create_diffusion("10", learn_sigma=False))
    assert small.item() <= large.item()


def test_guided_chain_and_bpd_shapes():
    """tests/test_diffusion_extras.py's guided chain (a constant 0.5
    gradient) runs end to end finite, and tests/test_diffusion.py's
    calc_bpd_loop shapes (N, S) and (N,) from a generator; a one-step chain
    gives finite bpd."""
    d = create_diffusion("10")
    s = d.p_sample_loop(_zero_model, torch.randn(1, 4, 2), generator=torch.Generator().manual_seed(1),
                        cond_fn=lambda x, t: torch.full_like(x, 0.5))
    assert torch.isfinite(s).all()
    out = create_diffusion("5").calc_bpd_loop(_zero_model, torch.zeros(2, 4, 2),
                                              generator=torch.Generator().manual_seed(0))
    assert out["vb"].shape == (2, 5) and out["total_bpd"].shape == (2,)
    one = create_diffusion("1").calc_bpd_loop(_zero_model, torch.zeros(2, 4, 2),
                                              generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v).all() for v in one.values())


def test_train_step_takes_a_fixed_variance_dit():
    """The port's train_step with a learn_sigma=False DiT under x0 prediction
    and the KL loss on a DiT with a learned variance: finite metrics, the
    keys JAX's step reports."""
    from osu_diffusion_tpu_torch.models.dit import DiT
    from osu_diffusion_tpu_torch.train.train_step import make_ema, make_optimizer, train_step

    r = np.random.RandomState(0)
    raw = np.zeros((2, 16, 19), np.float32)
    raw[..., 0], raw[..., 1] = r.rand(2, 16) * 512, r.rand(2, 16) * 384
    raw[..., 2] = np.cumsum(r.rand(2, 16) * 300, axis=1)
    raw[..., 3] = 1.0
    batch = (torch.from_numpy(raw), torch.from_numpy((r.rand(2, 2) * 300).astype(np.float32)),
             torch.tensor([0, 1]))
    for learn_sigma, kw, keys in ((False, dict(predict_xstart=True, learn_sigma=False), {"loss", "mse"}),
                                  (True, dict(use_kl=True), {"loss"})):
        model = DiT(**DIT, learn_sigma=learn_sigma).train()
        model.initialize_weights(torch.Generator().manual_seed(0))
        metrics = train_step(model, make_ema(model), make_optimizer(model.parameters()),
                             create_diffusion("", **kw), copy.deepcopy(batch), band=16,
                             dtype=torch.float32, generator=torch.Generator().manual_seed(1))
        assert set(metrics) == keys and all(torch.isfinite(v) for v in metrics.values())
