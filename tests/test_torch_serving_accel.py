"""Δ-cache sampling in the port (DiT delta_mode, Sampler accel_*), on the
CPU: mirrors of every test in tests/test_accel_sampling.py and of
tests/test_quant.py::test_quant_composes_with_delta_cache on the port's
models, and the port's accelerated chains against the JAX Sampler's.

Models: tests/torch_serving_setup.py's DiT (hidden 32, depth 4, 2 heads,
span (1, 3)), jittered so every block contributes, or at the adaLN-Zero
init for the identity test; T = 40 padded to 48, band 16. Tolerances: an
"apply" forward with the Δ just recorded from the same input is the full
forward up to f32 reassociation (rtol 1e-4 / atol 1e-5, the JAX test's);
chains against JAX atol 5e-3 (f32 in another order, as the JAX package's
chain parity tests); the same chain twice, and tau = 0 against the exact
chain, bit for bit. The chains against JAX run DDIM: an ancestral chain
here amplifies the two packages' f32 ordering differences near t = T past
5e-3 in single elements, the exact chain as much as an accelerated one (up
to 7e-3 seen at 6 steps), where DDIM's deterministic steps keep the gap
below 3e-4. `adaptive_skip` at a drift of exactly f32(tau) against JAX's
comparison: exact (one comparison of the same f32 value).
"""
import copy

import jax
import numpy as np
import pytest
import torch

from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
from osu_diffusion_tpu.sampling import Sampler as JaxSampler
from osu_diffusion_tpu_torch import sampling
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.sampling import Sampler
from torch_serving_setup import (
    BAND, BUCKET, CHAIN_TOL, CLASSES, CTX, DEPTH, HEADS, HIDDEN, SPAN, chain_inputs, jax_model,
    jax_noise, known_rows, port_model, to_jax, to_port,
)

APPLY_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jittered():
    jm, params = jax_model()
    return jm, params, port_model(params)


def _forward_inputs(n=2, t=16, seed=0):
    r = np.random.RandomState(seed)
    return (torch.from_numpy(r.rand(n, t, 2).astype(np.float32)),
            torch.from_numpy(r.randint(0, 1000, (n,))),
            torch.from_numpy(np.cumsum(r.rand(n, t) * 300, axis=1).astype(np.float32)),
            torch.from_numpy(r.rand(n, t, CTX).astype(np.float32)),
            torch.from_numpy(r.randint(0, CLASSES, (n,))))


def _sampler(model, steps=10, **kw):
    return Sampler(model, create_diffusion(str(steps), noise_schedule="squaredcos_cap_v2"),
                   cfg_scale=1.5, band=BAND, bucket=BUCKET, **kw)


def _chain(sampler, inp=None, seed=4, **call_kw):
    inp = inp or chain_inputs()
    return sampler(*to_port(inp), generator=torch.Generator().manual_seed(seed), **call_kw)


# -- the two forward modes ---------------------------------------------------


@torch.no_grad()
def test_record_matches_plain_forward(jittered):
    port = jittered[2]
    args = _forward_inputs()
    out_off = port(*args)
    out_rec, delta = port(*args, delta_mode="record", delta_span=SPAN)
    assert torch.equal(out_rec, out_off)
    assert delta.shape == (2, 16, HIDDEN)
    assert delta.abs().max() > 0


@torch.no_grad()
def test_apply_with_fresh_delta_is_exact(jittered):
    port = jittered[2]
    args = _forward_inputs()
    out_full, delta = port(*args, delta_mode="record", delta_span=SPAN)
    out_skip, delta2 = port(*args, delta_mode="apply", delta_span=SPAN, delta=delta)
    np.testing.assert_allclose(out_skip.numpy(), out_full.numpy(), **APPLY_TOL)
    assert delta2 is delta


@torch.no_grad()
def test_apply_skips_mid_blocks(jittered):
    """The apply mode never reads the span's blocks: zeroing blocks 1 and 2
    changes the full forward but not the apply forward."""
    port = jittered[2]
    args = _forward_inputs()
    _, delta = port(*args, delta_mode="record", delta_span=SPAN)
    butchered = copy.deepcopy(port)
    for i in range(*SPAN):
        for p in butchered.blocks[i].parameters():
            p.zero_()
    out_skip, _ = port(*args, delta_mode="apply", delta_span=SPAN, delta=delta)
    out_skip_b, _ = butchered(*args, delta_mode="apply", delta_span=SPAN, delta=delta)
    assert torch.equal(out_skip, out_skip_b)
    assert not torch.allclose(port(*args), butchered(*args))


@torch.no_grad()
def test_cfg_forward_delta_roundtrip(jittered):
    port = jittered[2]
    args = _forward_inputs()
    out_full, delta = port.forward_with_cfg(*args, 2.0, delta_mode="record", delta_span=SPAN)
    out_skip, _ = port.forward_with_cfg(*args, 2.0, delta_mode="apply", delta_span=SPAN,
                                        delta=delta)
    np.testing.assert_allclose(out_skip.numpy(), out_full.numpy(), **APPLY_TOL)
    assert torch.equal(out_full, port.forward_with_cfg(*args, 2.0))


# -- the chains --------------------------------------------------------------


@pytest.mark.parametrize("method", ["ancestral", "ddim"])
def test_accel_chain_equals_exact_at_identity_init(method):
    """At the adaLN-Zero init every block is a no-op, so skipping the span
    changes nothing: the accelerated chain is the exact chain, bit for bit."""
    model = DiT(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
                context_size=CTX, matmul_dtype=torch.float32)
    model.initialize_weights(torch.Generator().manual_seed(0))
    model.eval()
    exact = _chain(_sampler(model, method=method))
    accel = _chain(_sampler(model, method=method, accel_interval=2, accel_span=SPAN))
    assert torch.equal(accel, exact)


def test_accel_chain_runs_and_approximates(jittered):
    """With jittered weights the skipped steps really apply Δ: the chain
    differs from the exact one, stays finite, and repeats bit for bit."""
    port = jittered[2]
    exact = _chain(_sampler(port))
    accel_sampler = _sampler(port, accel_interval=2, accel_span=SPAN)
    accel = _chain(accel_sampler)
    assert accel.shape == exact.shape
    assert torch.isfinite(accel).all()
    assert not torch.allclose(accel, exact)
    assert torch.equal(_chain(accel_sampler), accel)


def test_accel_guards(jittered):
    port = jittered[2]
    diffusion = create_diffusion("10")
    with pytest.raises(ValueError, match="outside depth"):
        Sampler(port, diffusion, accel_interval=2, accel_span=(0, 99))
    with pytest.raises(ValueError, match="outside depth"):
        port(*_forward_inputs(), delta_mode="record", delta_span=(3, 3))
    with pytest.raises(ValueError, match="delta_mode"):
        port(*_forward_inputs(), delta_mode="replay", delta_span=SPAN)
    with pytest.raises(ValueError, match="needs the recorded delta"):
        port(*_forward_inputs(), delta_mode="apply", delta_span=SPAN)

    class _Mesh:  # a CP mesh stand-in: the guard fires before any collective
        num_model = 2

    with pytest.raises(ValueError, match="context parallelism"):
        Sampler(port, diffusion, band=BAND, cp=_Mesh(), accel_interval=2)
    with pytest.raises(ValueError, match="context parallelism"):
        Sampler(port, diffusion, band=BAND, cp=_Mesh(), accel_tau=0.1)


def test_accel_inpaint_path(jittered):
    """In-painting's denoised_fn survives the Δ-cache chain: the pinned
    rows end at known_x."""
    inp = chain_inputs()
    known_x, free = known_rows(inp)
    out = _chain(_sampler(jittered[2], accel_interval=2, accel_span=SPAN), inp,
                 known_x=torch.from_numpy(known_x), known_mask=torch.from_numpy(free))
    np.testing.assert_allclose(out.numpy()[~free], known_x[~free], atol=1e-6)


def test_adaptive_tau_zero_is_exact_and_all_full(jittered):
    """tau = 0: after the first step the drift is > 0, so every step runs in
    full: the adaptive chain is the exact chain, 10 full steps of 10."""
    port = jittered[2]
    exact = _chain(_sampler(port))
    adaptive = _sampler(port, accel_tau=0.0, accel_span=SPAN)
    assert torch.equal(_chain(adaptive), exact)
    assert adaptive.last_full_model_steps == 10


def test_adaptive_huge_tau_hits_staleness_cap(jittered):
    """tau = 1e9 never sees enough drift: only the first step, the cap
    (max_skip 3) and the last step run in full, steps {0, 4, 8, 9} of 10."""
    adaptive = _sampler(jittered[2], accel_tau=1e9, accel_span=SPAN, accel_max_skip=3)
    assert torch.isfinite(_chain(adaptive)).all()
    assert adaptive.last_full_model_steps == 4


def test_adaptive_intermediate_tau_skips_and_is_deterministic(jittered):
    port = jittered[2]
    adaptive = _sampler(port, steps=20, accel_tau=0.15, accel_span=SPAN, accel_max_skip=5)
    out = _chain(adaptive)
    assert 2 <= adaptive.last_full_model_steps < 20
    assert torch.equal(_chain(adaptive), out)
    fixed = _sampler(port, steps=20, accel_interval=2, accel_span=SPAN)
    _chain(fixed)
    assert fixed.last_full_model_steps == 11  # the 10 even positions and the last step


@pytest.mark.parametrize("drift_mode", sampling.ACCEL_DRIFTS)
@pytest.mark.parametrize("tau", [0.1, 0.3])
def test_adaptive_skip_compares_in_f32_as_jax(tau, drift_mode):
    """A drift of exactly f32(tau) (x_ref [[1, 0]], x [[1, f32(tau)]]):
    `adaptive_skip` returns JAX's `drift <= tau`, tau a weak-typed f32, as
    its scan body computes it (exact: one comparison of the same f32
    drift); the comparison of the drift as a Python double with the Python
    tau decides the other way at both taus."""
    x_ref = np.array([[1.0, 0.0]], np.float32)
    x = np.array([[1.0, tau]], np.float32)
    if drift_mode == "per_sample_max":
        jax_drift = jax.numpy.max(
            jax.numpy.linalg.norm((x - x_ref).reshape(1, -1), axis=1)
            / jax.numpy.maximum(jax.numpy.linalg.norm(x_ref.reshape(1, -1), axis=1), 1e-6))
    else:
        jax_drift = jax.numpy.linalg.norm(x - x_ref) / jax.numpy.maximum(jax.numpy.linalg.norm(x_ref), 1e-6)
    want = bool(jax_drift <= tau)
    per_sample_max = drift_mode == "per_sample_max"
    tx, tref = torch.from_numpy(x), torch.from_numpy(x_ref)
    assert sampling.drift(tx, tref, per_sample_max).item() == float(np.float32(tau))
    one = torch.tensor(1, dtype=torch.int32)
    got = sampling.adaptive_skip(tx, tref, torch.tensor([3, 3]), one - 1, one, tau, 7, per_sample_max)
    assert got.dtype == torch.bool and got.ndim == 0
    assert bool(got) == want
    assert (sampling.drift(tx, tref, per_sample_max).item() <= tau) != want


def test_adaptive_skip_guards():
    """With the drift below tau, each other condition alone refuses the
    skip: max_skip steps skipped in a row, the last timestep (t = 0), no Δ
    recorded yet (n_full = 0); the same with tau a 0-d f32 tensor."""
    x_ref = torch.tensor([[1.0, 0.0]])
    x = torch.tensor([[1.0, 0.05]])
    i32 = dict(dtype=torch.int32)

    def skip(t=3, skips=0, n_full=1, tau=0.1):
        return bool(sampling.adaptive_skip(x, x_ref, torch.tensor([t, t]), torch.tensor(skips, **i32),
                                           torch.tensor(n_full, **i32), tau, 3, False))

    assert skip() and skip(skips=2) and skip(tau=torch.tensor(0.1))
    assert not skip(skips=3) and not skip(t=0) and not skip(n_full=0) and not skip(tau=0.01)


def test_adaptive_guards(jittered):
    with pytest.raises(ValueError, match="accel_drift"):
        Sampler(jittered[2], create_diffusion("10"), accel_tau=0.1, accel_drift="per_row")


def test_adaptive_per_sample_max_drift(jittered):
    """The largest row drift is at least the batch's, so per_sample_max runs
    at least as many full steps as global; both repeat bit for bit, and at
    tau = 0 per_sample_max is the exact chain."""
    port = jittered[2]
    counts = {}
    for mode in sampling.ACCEL_DRIFTS:
        s = _sampler(port, steps=20, accel_tau=0.15, accel_span=SPAN, accel_max_skip=8,
                     accel_drift=mode)
        out = _chain(s)
        counts[mode] = s.last_full_model_steps
        assert torch.equal(_chain(s), out)
    assert counts["per_sample_max"] >= counts["global"]
    strict = _sampler(port, steps=20, accel_tau=0.0, accel_span=SPAN, accel_drift="per_sample_max")
    assert torch.equal(_chain(strict), _chain(_sampler(port, steps=20)))
    assert strict.last_full_model_steps == 20


def test_quant_composes_with_delta_cache(jittered):
    """The int8 blocks inside the Δ-cache chain (--quantize-weights
    --accel-interval 3): finite, and near the exact int8 chain."""
    qmodel = port_model(jittered[1], quant=True)
    exact = _chain(_sampler(qmodel, steps=6))
    accel = _chain(_sampler(qmodel, steps=6, accel_interval=3))
    assert torch.isfinite(accel).all()
    assert (accel - exact).abs().max() < 1.0


# -- against the JAX Sampler ---------------------------------------------------

STEPS = 6


def _jax_and_port(jittered, inp, rng_seed=4, **kw):
    """(port chain, JAX chain, their full-step counts): DDIM, two variants."""
    jm, params, port = jittered
    js = JaxSampler(jm, jax_create(str(STEPS), noise_schedule="squaredcos_cap_v2"), cfg_scale=2.0,
                    band=BAND, bucket=BUCKET, method="ddim", **kw)
    ps = Sampler(port, create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2"),
                 cfg_scale=2.0, band=BAND, bucket=BUCKET, method="ddim", **kw)
    rng = jax.random.PRNGKey(rng_seed)
    want = np.asarray(js(params, *to_jax(inp), rng))
    got = ps(*to_port(inp), noise_fn=jax_noise(rng, STEPS)).numpy()
    return got, want, ps.last_full_model_steps, int(js.last_full_model_steps)


@pytest.mark.parametrize("interval,full", [(2, 4), (3, 3)])
def test_fixed_accel_chain_matches_jax(jittered, interval, full):
    got, want, n_port, n_jax = _jax_and_port(jittered, chain_inputs(n=4),
                                             accel_interval=interval, accel_span=SPAN)
    assert n_port == n_jax == full  # steps 0, 2, 4, 5 / 0, 3, 5 of 6
    np.testing.assert_allclose(got, want, atol=CHAIN_TOL)


# a tau with every drift the chain reads more than 1% away from it, so the
# ulp-level differences between the two chains cannot flip a decision
ADAPTIVE_TAU = 0.2


@pytest.mark.parametrize("drift_mode", sampling.ACCEL_DRIFTS)
def test_adaptive_accel_chain_matches_jax(jittered, drift_mode, monkeypatch):
    drifts = []

    def recorded(*args):
        d = orig(*args)
        drifts.append(d.item())
        return d

    orig = sampling.drift
    monkeypatch.setattr(sampling, "drift", recorded)
    got, want, n_port, n_jax = _jax_and_port(
        jittered, chain_inputs(n=4), accel_tau=ADAPTIVE_TAU, accel_span=SPAN, accel_max_skip=3,
        accel_drift=drift_mode)
    assert drifts and min(abs(d - ADAPTIVE_TAU) for d in drifts) > 0.01 * ADAPTIVE_TAU, drifts
    assert any(d <= ADAPTIVE_TAU for d in drifts), drifts  # the chain skipped a step
    assert n_port == n_jax < STEPS
    np.testing.assert_allclose(got, want, atol=CHAIN_TOL)
