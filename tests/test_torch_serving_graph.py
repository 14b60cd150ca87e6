"""The Sampler's one-program chains on the CPU: each chain a step program
over static buffers (sampling.py, diffusion/process.py `StepProgram`),
cached per (N, T_pad, inpaint, use_cfg, kind, stream type), with the real
length a 0-d int32 `valid_len` tensor (on the card a CUDA graph replays
the step; here the same program runs eagerly).

- (a) every chain kind the graphs cover (ancestral, DDIM, the fixed
  Δ-cache, in-painting, the plain forward, refine, progressive, and the
  adaptive Δ-cache in both drift modes and with DDIM in-painting), with a
  generator and with a `noise_fn`, equals the eager loop the Sampler ran
  before the step programs (written out below; its adaptive decision JAX's
  f32 comparison) bit for bit, with the same full steps;
- (b) two lengths in one bucket share one cache entry, and each chain
  (the adaptive one too, with its full steps an int) equals a fresh
  sampler's bit for bit; a weight change between calls is seen;
- (c) a forward with `valid_len` a 0-d tensor equals the int form bit for
  bit (f32 and int8 blocks, banded and full attention, and the banded
  attention wrappers alone), and equals JAX's `DiT.apply(...,
  valid_len=jnp.int32(t))` at tests/test_torch_model.py's one-forward f32
  tolerance (rtol 1e-4, atol 1e-5); a chain's JAX parity has too little
  margin for that, so one forward is compared;
- every kernel wrapper with a `.launches` counter is one the graphs'
  accounting updates (`launch_counters`).

Model: a JAX-initialized DiT (hidden 64, depth 3, 4 heads, 7 classes,
adaLN and final layers perturbed) through `state_dict_from_jax_params`,
the port at matmul_dtype float32; T 40 padded to 48 by a bucket of 16,
band 16, 6 steps. Torch's intra-op threads are capped at 2 for this
module, as tests/test_torch_bench.py caps them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_diffusion_tpu.models.dit import DiT as JaxDiT
from osu_diffusion_tpu.models.dit import DiTConfig
from osu_diffusion_tpu.ops.attention import banded_attention_mask as jax_band_mask
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion, draw_noise
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict
from osu_diffusion_tpu_torch.ops import adaln_mlp, banded_attention, quant
from osu_diffusion_tpu_torch.sampling import Sampler, _bucketed, _pad_time, drift, launch_counters
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params

HIDDEN, DEPTH, HEADS, CLASSES, CTX = 64, 3, 4, 7, 144
BAND, BUCKET, T, STEPS, CFG = 16, 16, 40, 6, 2.0
SPAN = (1, 2)
INTERVAL = 3
REFINE_ITERS = 3
# the adaptive Δ-cache's tau and cap: this chain's drifts after its first
# step run 1.26 to 0.19 (global) and 1.27 to 0.19 (per_sample_max), so
# both full and skipped steps come up
ADAPTIVE = dict(accel_tau=1.0, accel_span=SPAN, accel_max_skip=2)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Torch's intra-op threads at 2 while this module runs, then as they were."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_model():
    model = JaxDiT(DiTConfig(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS,
                             num_classes=CLASSES, context_size=CTX))
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 8)), jnp.zeros((1, 8, CTX)), jnp.zeros((1,), jnp.int32),
    )["params"]
    r = np.random.RandomState(7)

    def perturb(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        a = np.array(leaf)
        if "adaLN" in names or ("final_layer" in names and "linear" in names):
            a = a + (0.05 * r.randn(*a.shape)).astype(a.dtype)
        return a

    return model, jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def models():
    jm, params = _jax_model()
    sd = state_dict_from_jax_params(params, num_label_rows=CLASSES + 1)

    def port(quant_blocks=False):
        model = DiT(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
                    context_size=CTX, matmul_dtype=torch.float32, quant=quant_blocks)
        model.load_state_dict(quantize_state_dict(sd) if quant_blocks else sd)
        return model.eval()

    return jm, params, port


def _inputs(t=T, cfg=True, seed=3):
    """(z, o, c, y): with `cfg` the doubled batch [cond | uncond] sharing x."""
    r = np.random.RandomState(seed)
    z = r.randn(1, t, 2).astype(np.float32)
    o = np.cumsum(r.rand(1, t) * 300, axis=1).astype(np.float32)
    c = r.rand(1, t, CTX).astype(np.float32)
    z, o, c = (np.concatenate([a, a]) for a in (z, o, c))
    y = np.array([1, CLASSES]) if cfg else np.array([CLASSES, CLASSES])
    return [torch.from_numpy(a) for a in (z, o, c, y)]


def _known(z):
    r = np.random.RandomState(5)
    known_x = torch.from_numpy(r.rand(*z.shape).astype(np.float32))
    free = torch.ones(z.shape, dtype=torch.bool)
    free[:, z.shape[1] // 2:] = False
    return known_x, free


def _noise_fn(k, shape):
    return torch.from_numpy(np.random.RandomState(100 + k).randn(*shape).astype(np.float32))


def _eager_chain(sampler, z, o, c, y, generator, noise_fn, known_x=None, known_mask=None,
                 use_cfg=True, refine_iters=None, progressive=False):
    """The eager loop the Sampler ran before its step programs: a new x, a
    `torch.full` t and a drawn noise each step, valid_len an int."""
    model, diffusion = sampler.model, sampler.diffusion
    t_real = z.shape[1]
    t_pad = _bucketed(t_real, sampler.bucket)
    zp, op, cp = (_pad_time(a, t_pad) for a in (z, o, c))
    denoised_fn = None
    if known_x is not None:
        kx, km = _pad_time(known_x, t_pad), _pad_time(known_mask, t_pad)

        def denoised_fn(x0):
            return torch.where(km, x0, kx)

    def model_fn(x, t, **kw):
        if use_cfg:
            return model.forward_with_cfg(x, t, op, cp, y, sampler.cfg_scale, band=sampler.band,
                                          valid_len=t_real, **kw)
        return model.forward(x, t, op, cp, y, band=sampler.band, valid_len=t_real, **kw)

    s = diffusion.num_timesteps
    steps = [(k, 0) for k in range(refine_iters)] if refine_iters else enumerate(range(s - 1, -1, -1))
    step_fn = diffusion.ddim_sample if sampler.method == "ddim" and not progressive else diffusion.p_sample
    x, delta, frames = zp, None, []
    adaptive = sampler.accel_tau is not None
    x_ref, skips, n_full = torch.zeros_like(zp), 0, 0
    for k, i in steps:
        if adaptive:
            # JAX's decision: the f32 drift against tau rounded to f32
            d = drift(x, x_ref, sampler.accel_drift == "per_sample_max").item()
            skip = (d <= float(np.float32(sampler.accel_tau)) and skips < sampler.accel_max_skip
                    and i > 0 and n_full > 0)
            if skip:
                skips += 1
            else:
                x_ref, skips, n_full = x, 0, n_full + 1
        else:
            skip = sampler.accel and k % sampler.accel_interval != 0 and k < s - 1
        cell = {}

        def step_model(xx, tt):
            if not sampler.accel:
                return model_fn(xx, tt)
            out, cell["delta"] = model_fn(xx, tt, delta_mode="apply" if skip else "record",
                                          delta_span=sampler.accel_span, delta=delta)
            return out

        t = torch.full((x.shape[0],), i, dtype=torch.long)
        x = step_fn(step_model, x, t, draw_noise(k, x, generator, noise_fn),
                    clip_denoised=True, denoised_fn=denoised_fn)["sample"]
        delta = cell.get("delta")
        frames.append(x)
    if progressive:
        return torch.stack(frames)[..., :t_real, :]
    if adaptive:
        return x[:, :t_real], n_full
    return x[:, :t_real]


CHAINS = ["ancestral", "ddim", "fixed_delta", "inpaint", "no_cfg", "refine", "refine_pinned",
          "progressive", "adaptive", "adaptive_per_sample_max", "adaptive_ddim_inpaint"]


@pytest.mark.parametrize("noise", ["generator", "noise_fn"])
@pytest.mark.parametrize("chain", CHAINS)
def test_step_program_chain_equals_eager_loop(models, chain, noise):
    """(a) Each chain kind through the step program, bit for bit."""
    port = models[2]()
    kw = dict(method="ddim") if chain == "ddim" else {}
    if chain == "fixed_delta":
        kw = dict(accel_interval=INTERVAL, accel_span=SPAN)
    if chain.startswith("adaptive"):
        kw = dict(ADAPTIVE, accel_drift="per_sample_max" if chain.endswith("max") else "global")
        if chain.endswith("inpaint"):
            kw["method"] = "ddim"
    sampler = Sampler(port, create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2"),
                      cfg_scale=CFG, band=BAND, bucket=BUCKET, **kw)
    z, o, c, y = _inputs(cfg=chain not in ("no_cfg", "refine_pinned"))
    call = dict(use_cfg=chain not in ("no_cfg", "refine_pinned"))
    if chain.endswith("inpaint"):
        call["known_x"], call["known_mask"] = _known(z)

    def draws():
        if noise == "noise_fn":
            return dict(generator=None, noise_fn=_noise_fn)
        return dict(generator=torch.Generator().manual_seed(11), noise_fn=None)

    if chain.startswith("refine"):
        pinned = _known(z)[1] if chain == "refine_pinned" else None
        got = sampler.refine(z, o, c, y, REFINE_ITERS, known_mask=pinned, **draws(), **call)
        want = _eager_chain(sampler, z, o, c, y, **draws(), known_x=None if pinned is None else z,
                            known_mask=pinned, refine_iters=REFINE_ITERS, **call)
    elif chain == "progressive":
        got = sampler.progressive(z, o, c, y, **draws())
        want = _eager_chain(sampler, z, o, c, y, **draws(), progressive=True)
        assert got.shape == (STEPS, 2, T, 2)
    else:
        got = sampler(z, o, c, y, **draws(), **call)
        want = _eager_chain(sampler, z, o, c, y, **draws(), **call)
    if chain.startswith("adaptive"):
        want, n_full = want
        assert type(sampler.last_full_model_steps) is int
        assert sampler.last_full_model_steps == n_full and 1 < n_full < STEPS
        (entry,) = sampler._cache.values()
        assert set(entry.programs) == {"record", "apply"} and entry.captures == {"adaptive": 0}
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert len(sampler._cache) == 1
    if chain == "fixed_delta":
        assert sampler.last_full_model_steps == len(range(0, STEPS, INTERVAL)) + ((STEPS - 1) % INTERVAL != 0)
        (entry,) = sampler._cache.values()
        assert set(entry.programs) == {"record", "apply"}
    if chain.endswith("inpaint"):
        known_x, free = call["known_x"], call["known_mask"]
        assert (got[~free] - known_x[~free]).abs().max().item() <= 1e-6


def test_one_cache_entry_per_bucket(models):
    """(b) T 100 and 120 at bucket 128: one entry, and every chain (100,
    120, then 100 again) equals a fresh sampler's bit for bit."""
    port = models[2]()
    diffusion = create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2")

    def make():
        return Sampler(port, diffusion, cfg_scale=CFG, band=BAND, bucket=128)

    sampler = make()
    for t in (100, 120, 100):
        args = _inputs(t=t, seed=t)
        got = sampler(*args, generator=torch.Generator().manual_seed(t))
        want = make()(*args, generator=torch.Generator().manual_seed(t))
        assert got.shape == (2, t, 2)
        assert torch.equal(got, want)
    assert list(sampler._cache) == [(2, 128, False, True, "ancestral", torch.float32)]
    (entry,) = sampler._cache.values()
    assert entry.captures == {"step": 0}  # no graph on the CPU


@pytest.mark.parametrize("drift_mode", ["global", "per_sample_max"])
def test_adaptive_one_cache_entry_per_bucket(models, drift_mode):
    """(b) The adaptive Δ-cache through the cache: T 100, 120, then 100
    again at bucket 128 share one entry ("ancestral-adaptive"), each chain
    equals a fresh sampler's bit for bit with the same full steps (an
    int), and a second call repeats the first's bits."""
    port = models[2]()
    diffusion = create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2")

    def make():
        return Sampler(port, diffusion, cfg_scale=CFG, band=BAND, bucket=128, accel_drift=drift_mode,
                       **ADAPTIVE)

    sampler = make()
    for t in (100, 120, 100):
        args = _inputs(t=t, seed=t)
        got = sampler(*args, generator=torch.Generator().manual_seed(t))
        full = sampler.last_full_model_steps
        fresh = make()
        want = fresh(*args, generator=torch.Generator().manual_seed(t))
        assert got.shape == (2, t, 2) and torch.isfinite(got).all()
        assert torch.equal(got, want)
        assert type(full) is int and full == fresh.last_full_model_steps and 1 < full <= STEPS
        assert torch.equal(sampler(*args, generator=torch.Generator().manual_seed(t)), got)
        assert sampler.last_full_model_steps == full
    assert list(sampler._cache) == [(2, 128, False, True, "ancestral-adaptive", torch.float32)]
    (entry,) = sampler._cache.values()
    assert entry.captures == {"adaptive": 0}  # no graph on the CPU


def test_weight_change_between_calls(models):
    """A chain after an in-place weight update (as an eval between training
    chunks loads the EMA) equals a fresh sampler's on the new weights."""
    port = models[2]()
    diffusion = create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2")
    sampler = Sampler(port, diffusion, cfg_scale=CFG, band=BAND, bucket=BUCKET)
    args = _inputs()
    before = sampler(*args, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for block in port.blocks:
            block.mlp.fc1.weight.mul_(1.5)
    got = sampler(*args, generator=torch.Generator().manual_seed(1))
    want = Sampler(port, diffusion, cfg_scale=CFG, band=BAND, bucket=BUCKET)(
        *args, generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, want) and not torch.equal(got, before)


def _forward_args():
    z, o, c, y = _inputs(t=48, seed=9)
    t = torch.tensor([500, 500])
    return z, t, o, c, y


@pytest.mark.parametrize("quant_blocks", [False, True])
@pytest.mark.parametrize("band", [BAND, None])
@pytest.mark.parametrize("cfg", [False, True])
def test_tensor_valid_len_equals_int(models, quant_blocks, band, cfg):
    """(c) valid_len 37 as a 0-d int32 tensor: the int form's bits."""
    port = models[2](quant_blocks)
    args = _forward_args()
    with torch.no_grad():
        if cfg:
            got = port.forward_with_cfg(*args, CFG, band=band, valid_len=torch.tensor(37, dtype=torch.int32))
            want = port.forward_with_cfg(*args, CFG, band=band, valid_len=37)
        else:
            got = port(*args, band=band, valid_len=torch.tensor(37, dtype=torch.int32))
            want = port(*args, band=band, valid_len=37)
    assert torch.equal(got, want)


@pytest.mark.parametrize("valid", [37, 48])
@pytest.mark.parametrize("cfg", [False, True])
def test_tensor_valid_len_matches_jax(models, valid, cfg):
    """(c) The tensor form against JAX's traced valid_len (XLA path, the
    dense band mask), f32."""
    jm, params, port_fn = models
    port = port_fn()
    args = _forward_args()
    j_args = [jnp.asarray(a.numpy()) for a in args]
    kw = dict(attn_mask=jax_band_mask(48, BAND), valid_len=jnp.int32(valid))
    with torch.no_grad():
        vl = torch.tensor(valid, dtype=torch.int32)
        if cfg:
            got = port.forward_with_cfg(*args, CFG, band=BAND, valid_len=vl)
            want = jm.apply({"params": params}, *j_args, cfg_scale=CFG, method=JaxDiT.forward_with_cfg, **kw)
        else:
            got = port(*args, band=BAND, valid_len=vl)
            want = jm.apply({"params": params}, *j_args, **kw)
    np.testing.assert_allclose(got.numpy()[:, :valid], np.asarray(want)[:, :valid], rtol=1e-4, atol=1e-5)


def test_attention_wrappers_take_a_tensor_valid_len():
    """The inference forward (both out types) takes the tensor and gives the
    int form's bits; the training entries read a CPU tensor as an int; a
    tensor of another type or shape, or a length outside [1, T], raises."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 50, 16, generator=g) for _ in range(3))
    vl = torch.tensor(41, dtype=torch.int32)
    for out_dtype in (None, torch.bfloat16):
        assert torch.equal(banded_attention.banded_attention(q, k, v, 8, vl, out_dtype=out_dtype),
                           banded_attention.banded_attention(q, k, v, 8, 41, out_dtype=out_dtype))
    got = banded_attention.banded_attention_fwd_lse(q, k, v, 8, vl)
    want = banded_attention.banded_attention_fwd_lse(q, k, v, 8, 41)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (torch.tensor(41), torch.tensor([41], dtype=torch.int32)):
        with pytest.raises(TypeError):
            banded_attention.banded_attention(q, k, v, 8, bad)
    for length in (0, 51):
        with pytest.raises(ValueError):
            banded_attention.banded_attention(q, k, v, 8, torch.tensor(length, dtype=torch.int32))


def test_launch_counters_cover_every_wrapper():
    """Every function of the kernel modules that counts launches is one a
    replay adds its captured launches to, and so are the o casts."""
    counted = {fn for fn, name in launch_counters() if name == "launches"}
    for module in (banded_attention, adaln_mlp, quant):
        for value in vars(module).values():
            if callable(value) and hasattr(value, "launches"):
                assert value in counted, value.__name__
    assert (quant.int8_out_residual, "o_casts") in launch_counters()
