"""The PyTorch port's ops against the JAX package, on the CPU.

Embeddings, featurize and sequence processing, the diffusion tables and one
ancestral step, and the plain versions of the two CUDA kernels against the
Pallas kernels they replace (run in interpret mode, as the JAX package's own
tests run them). Inputs come from numpy and reach both frameworks as the
same arrays. The kernels themselves are tested in test_torch_kernels.py.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_attention as pa
import osu_diffusion_tpu.ops.pallas_mlp as pm
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.ops import banded_attention as tba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "assets", "toy_datasets", "**", "*.osu"),
                            recursive=True))


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpret mode on the CPU."""
    for mod in (pa, pm):
        orig = mod.pl.pallas_call

        def patched(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", patched)


# ---------------------------------------------------------------------------
# embeddings, featurize, sequence processing
# ---------------------------------------------------------------------------


def assert_sincos_close(got, want, values):
    """Sincos embeddings of the same f32 values. XLA's and torch's f32 exp
    differ by up to 2 ulp on some of the frequencies (neither is correctly
    rounded there), and cos/sin by 1 ulp; a frequency ulp (<= 6e-8) moves
    the argument by |value| * 6e-8. So each element may differ by
    2 * 6e-8 * |value| + 2 * 6e-8, and by nothing more."""
    bound = 1.2e-7 * np.abs(np.asarray(values, np.float64))[..., None] + 1.2e-7
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    diff = diff.reshape(bound.shape[:-1] + (-1,))
    assert (diff <= bound).all(), f"max excess {(diff - bound).max()}"


@pytest.mark.parametrize("dim", [256, 128, 7])
def test_embeddings_match_jax(dim):
    from osu_diffusion_tpu.ops import embeddings as je
    from osu_diffusion_tpu_torch.ops import embeddings as te

    r = np.random.RandomState(0)
    t = (r.rand(3, 40) * 1000).astype(np.float32)
    pos = (r.rand(3, 40, 2) * [512.0, 384.0]).astype(np.float32)
    o = t * 100
    assert_sincos_close(te.timestep_embedding(torch.from_numpy(t), dim),
                        je.timestep_embedding(jnp.asarray(t), dim), t)
    assert_sincos_close(te.offset_sequence_embedding(torch.from_numpy(o), dim),
                        je.offset_sequence_embedding(jnp.asarray(o), dim), o)
    assert_sincos_close(te.position_sequence_embedding(torch.from_numpy(pos), dim),
                        je.position_sequence_embedding(jnp.asarray(pos), dim), pos)
    if dim % 2:  # the zero pad column
        assert (te.timestep_embedding(torch.from_numpy(t), dim)[..., -1] == 0).all()


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: os.path.relpath(p, ROOT))
def test_featurize_and_process_match_jax(path):
    """Featurize, coordinates, times and type one-hots exactly; distances
    within 1 ulp (XLA may fuse dx*dx + dy*dy into an FMA); the distance
    embedding within the sincos bound above, doubled for that ulp."""
    from osu_diffusion_tpu.beatmap import Beatmap
    from osu_diffusion_tpu.data.featurize import beatmap_to_sequence as jax_featurize
    from osu_diffusion_tpu_torch.beatmap import Beatmap as PortBeatmap
    from osu_diffusion_tpu.data.process import calc_distances as jax_distances
    from osu_diffusion_tpu.data.process import split_and_process_sequence_no_augment as jax_split
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
    from osu_diffusion_tpu_torch.data.process import (
        calc_distances,
        split_and_process_sequence_no_augment,
    )

    # each package parses with its own beatmap layer
    seq = beatmap_to_sequence(PortBeatmap.from_path(path))
    np.testing.assert_array_equal(seq, jax_featurize(Beatmap.from_path(path)))

    (x, o, c), t = split_and_process_sequence_no_augment(torch.from_numpy(seq))
    # JAX side on a 64-row padded copy: a few shapes to compile, not one per
    # fixture; distances look backwards only, so the real rows are unchanged
    t_pad = -(-len(seq) // 64) * 64
    padded = jnp.asarray(np.concatenate([seq, np.zeros((t_pad - len(seq), seq.shape[1]), seq.dtype)]))
    (jx, jo, jc), _ = jax_split(padded)
    dist = calc_distances(torch.from_numpy(seq)).numpy()
    assert t == len(seq)
    np.testing.assert_allclose(dist, np.asarray(jax_distances(padded))[:t], rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx)[:t])
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo)[:t])
    np.testing.assert_array_equal(c[:, 128:].numpy(), np.asarray(jc)[:t, 128:])
    assert_sincos_close(c[:, :128], np.asarray(jc)[:t, :128], 2 * dist)


def test_get_beatmap_idx_matches_jax():
    from osu_diffusion_tpu.data.dataset import get_beatmap_idx as jax_idx
    from osu_diffusion_tpu_torch.data.dataset import get_beatmap_idx

    path = os.path.join(ROOT, "assets", "beatmap_idx.pickle")
    assert get_beatmap_idx(path) == jax_idx(path)


# ---------------------------------------------------------------------------
# diffusion: tables and one step, rtol 1e-6
# ---------------------------------------------------------------------------

TABLES = [
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "log_betas", "fixed_large_variance",
    "log_fixed_large_variance",
]


@pytest.mark.parametrize("respacing,schedule", [
    ("50", "squaredcos_cap_v2"), ("4", "squaredcos_cap_v2"), ("1", "squaredcos_cap_v2"),
    ("", "linear"), ("ddim25", "linear"),
])
def test_diffusion_tables_match_jax(respacing, schedule):
    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion

    want = jax_create(respacing, noise_schedule=schedule)
    got = create_diffusion(respacing, noise_schedule=schedule)
    assert got.num_timesteps == want.num_timesteps
    assert want.model_var_type == "learned_range" and want.model_mean_type == "epsilon"
    np.testing.assert_array_equal(got.timestep_map.numpy(), np.asarray(want.timestep_map))
    for name in TABLES:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("step", [0, 2, 3])
def test_p_sample_step_matches_jax(step):
    """One ancestral step from the same x, model output and noise."""
    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion

    r = np.random.RandomState(step)
    x = r.randn(2, 20, 2).astype(np.float32)
    model_out = (r.randn(2, 20, 4) * 0.5).astype(np.float32)
    jd = jax_create("4", noise_schedule="squaredcos_cap_v2")
    td = create_diffusion("4", noise_schedule="squaredcos_cap_v2")
    rng = jax.random.PRNGKey(step)
    noise = np.array(jax.random.normal(rng, x.shape, jnp.float32))
    seen = {}

    def jax_model(xx, tt):
        seen["jax"] = np.asarray(tt)
        return jnp.asarray(model_out)

    def torch_model(xx, tt):
        seen["torch"] = tt.numpy()
        return torch.from_numpy(model_out)

    t = np.full((2,), step)
    want = jd.p_sample(jax_model, jnp.asarray(x), jnp.asarray(t, jnp.int32), rng)
    got = td.p_sample(torch_model, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_array_equal(seen["torch"], seen["jax"])
    for key in ("sample", "pred_xstart"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel A's plain version vs the Pallas banded flash attention (f32)
# ---------------------------------------------------------------------------


def _qkv(n, h, t, dh, seed=0):
    r = np.random.RandomState(seed)
    return tuple(r.randn(n, h, t, dh).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("t,band,t_real", [
    (48, 16, 48),   # band < T
    (32, 64, 32),   # band >= T
    (48, 16, 37),   # t_real < T: padded keys masked, far rows fully masked
    (40, 20, 29),   # ragged T and band against the 16-row Pallas block
])
def test_banded_attention_plain_matches_pallas(interpret_mode, t, band, t_real):
    q, k, v = _qkv(2, 4, t, 16)
    want = pa.banded_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), band,
                                     block=16, matmul_dtype=jnp.float32, t_real=t_real)
    got = tba.banded_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               band, t_real, matmul_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_banded_attention_plain_zeroes_rows_without_keys():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 48, 16))
    out = tba.banded_attention(q, k, v, band=8, valid_len=20, matmul_dtype=torch.float32)
    assert torch.isfinite(out).all()
    # q - band < k < valid holds for no k once q >= valid + band - 1 = 27
    assert (out[:, :, 27:] == 0).all()
    assert (out[:, :, :27].abs().sum(-1) > 0).all()


def test_banded_attention_rejects_bad_lengths():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 8))
    with pytest.raises(ValueError):
        tba.banded_attention(q, k, v, band=4, valid_len=0)
    with pytest.raises(ValueError):
        tba.banded_attention(q, k, v, band=4, valid_len=17)
    with pytest.raises(ValueError):
        tba.banded_attention(q, k, v, band=0)


# ---------------------------------------------------------------------------
# kernel B's plain version vs the Pallas fused adaLN-MLP (f32)
# ---------------------------------------------------------------------------


def _mlp_inputs(n, t, d, h, seed=0):
    r = np.random.RandomState(seed)
    return (
        r.randn(n, t, d).astype(np.float32),
        (r.randn(n, d) * 0.1).astype(np.float32),
        (r.randn(n, d) * 0.1).astype(np.float32),
        (r.randn(n, d) * 0.1).astype(np.float32),
        (r.randn(d, h) * 0.05).astype(np.float32),
        (r.randn(h) * 0.05).astype(np.float32),
        (r.randn(h, d) * 0.05).astype(np.float32),
        (r.randn(d) * 0.05).astype(np.float32),
    )


def _packed(args):
    """numpy (x, shift, scale, gate, w1, b1, w2, b2) -> the port's arguments,
    with w1/w2 as the Linear weights in torch's (out, in) layout, as
    `adaln_mlp` takes them (f32: the plain version rounds)."""
    x, shift, scale, gate, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    return x, shift, scale, gate, w1.t().contiguous(), b1, w2.t().contiguous(), b2


def test_pack_weights_layout():
    r = np.random.RandomState(0)
    w1, w2 = torch.from_numpy(r.randn(64, 256).astype(np.float32)), torch.from_numpy(r.randn(256, 64).astype(np.float32))
    w1p, w2p = tam.pack_weights(w1, w2, torch.float32)
    assert w1p.shape == (2, 64, 128 + tam.ROW_PAD) and w2p.shape == (256, 64 + tam.ROW_PAD)
    assert torch.equal(w1p[1, 5, :128], w1[5, 128:256])  # chunk-major 128-column blocks
    assert (w1p[..., 128:] == 0).all() and (w2p[:, 64:] == 0).all()
    # the chunks back in order, the padding off: the weights themselves
    assert torch.equal(w1p[..., :128].permute(1, 0, 2).reshape(64, 256), w1)
    assert torch.equal(w2p[:, :64], w2)
    assert tam.pack_weights(w1, w2)[0].dtype == torch.bfloat16


@pytest.mark.parametrize("t,block_t", [(20, 16), (48, 16), (32, 32)])
def test_adaln_mlp_plain_matches_pallas(interpret_mode, t, block_t):
    args = _mlp_inputs(2, t, 64, 256)
    want = pm.adaln_mlp(*(jnp.asarray(a) for a in args), block_t, 1e-6, jnp.float32)
    got = tam.adaln_mlp(*_packed(args), eps=1e-6, matmul_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_adaln_mlp_plain_bf16_matches_pallas_bf16(interpret_mode):
    """Both sides round matmul operands to bf16 and accumulate in f32; what
    differs is summation order, so a rounding can flip by one bf16 ulp."""
    args = _mlp_inputs(2, 48, 64, 256, seed=1)
    want = pm.adaln_mlp(*(jnp.asarray(a) for a in args), 16, 1e-6, jnp.bfloat16)
    got = tam.adaln_mlp(*_packed(args), eps=1e-6, matmul_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
