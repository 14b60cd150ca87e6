"""The PyTorch port's DiT, checkpoint converter, sampler and sample CLI
against the JAX package, on the CPU, at a small size (depth 2, hidden 64,
4 heads, 7 classes, band and flash block 16).

The JAX model is initialized by flax, its adaLN-Zero layers perturbed so
that every block contributes, and its parameters reach the port through
`state_dict_from_jax_params`.
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
from osu_diffusion_tpu.models.dit import DiT as JaxDiT
from osu_diffusion_tpu.models.dit import DiTConfig
from osu_diffusion_tpu.ops.attention import banded_attention_mask
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.train.checkpoint import load_checkpoint, state_dict_from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, DEPTH, HEADS, CLASSES, CTX = 64, 2, 4, 7, 144
BAND = 16
FIXTURE = os.path.join(ROOT, "assets", "toy_datasets", "visual_spacing",
                       "test - visual spacing (OliBomby) [test12].osu")  # T = 34


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpret mode on the CPU."""
    for mod in (pa, pm):
        orig = mod.pl.pallas_call

        def patched(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", patched)


def _jax_model(scan_blocks=False, seed=0):
    """JAX DiT and its params as numpy, adaLN and final layers perturbed
    (adaLN-Zero would gate every block out of the output)."""
    model = JaxDiT(DiTConfig(
        hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
        context_size=CTX, flash_block=16, scan_blocks=scan_blocks,
    ))
    params = model.init(
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

    return model, jax.tree_util.tree_map_with_path(perturb, params)


def _port_model(params, matmul_dtype):
    model = DiT(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
                context_size=CTX, matmul_dtype=matmul_dtype)
    model.load_state_dict(state_dict_from_jax_params(params, num_label_rows=CLASSES + 1))
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


def _run_both(jax_model, params, port, inp, cfg_scale, valid_len, **jax_kwargs):
    j_args = [jnp.asarray(inp[k]) for k in ("x", "t", "o", "c", "y")]
    p_args = [torch.from_numpy(inp[k]) for k in ("x", "t", "o", "c", "y")]
    with torch.no_grad():
        if cfg_scale is None:
            want = jax_model.apply({"params": params}, *j_args, valid_len=valid_len, **jax_kwargs)
            got = port(*p_args, band=BAND, valid_len=valid_len)
        else:
            want = jax_model.apply({"params": params}, *j_args, cfg_scale=cfg_scale,
                                   valid_len=valid_len, method=JaxDiT.forward_with_cfg,
                                   **jax_kwargs)
            got = port.forward_with_cfg(*p_args, cfg_scale, band=BAND, valid_len=valid_len)
    return got.numpy()[:, :valid_len], np.asarray(want)[:, :valid_len]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_blocks", [False, True])
def test_converter_matches_jax_converter(scan_blocks):
    from osu_diffusion_tpu.train.checkpoint import params_to_torch_state_dict

    _, params = _jax_model(scan_blocks=scan_blocks)
    assert ("blocks" in params) == scan_blocks
    want = params_to_torch_state_dict(params, num_label_rows=CLASSES + 1)
    got = state_dict_from_jax_params(params, num_label_rows=CLASSES + 1)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    # the port's modules carry exactly these names and shapes
    port = DiT(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES)
    port.load_state_dict(got, strict=True)


def test_load_checkpoint_prefers_ema_and_checks_playfield(tmp_path):
    _, params = _jax_model()
    sd = state_dict_from_jax_params(params, num_label_rows=CLASSES + 1)
    other = {k: v + 1 for k, v in sd.items()}
    other["xoc_embedder.playfield_size"] = sd["xoc_embedder.playfield_size"]
    path = str(tmp_path / "train.pt")
    torch.save({"model": other, "ema": sd, "args": argparse.Namespace(model="tiny")}, path)
    got = load_checkpoint(path)
    assert torch.equal(got["final_layer.linear.weight"], sd["final_layer.linear.weight"])
    torch.save({"model": other}, str(tmp_path / "no_ema.pt"))
    got = load_checkpoint(str(tmp_path / "no_ema.pt"))
    assert torch.equal(got["final_layer.linear.weight"], other["final_layer.linear.weight"])
    torch.save(sd, str(tmp_path / "raw.pt"))
    assert torch.equal(load_checkpoint(str(tmp_path / "raw.pt"))["final_layer.linear.weight"],
                       sd["final_layer.linear.weight"])
    bad = dict(sd, **{"xoc_embedder.playfield_size": torch.tensor([640.0, 480.0])})
    torch.save(bad, str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "bad.pt"))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_scale", [None, 2.5])
@pytest.mark.parametrize("valid_len", [37, 48])
def test_forward_matches_jax_xla_f32(cfg_scale, valid_len):
    """f32 on both sides: the JAX dense banded mask (use_pallas=False) and
    the port's plain versions at matmul_dtype float32."""
    jax_model, params = _jax_model()
    port = _port_model(params, torch.float32)
    inp = _inputs()
    got, want = _run_both(jax_model, params, port, inp, cfg_scale, valid_len,
                          attn_mask=banded_attention_mask(48, BAND))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cfg_scale", [None, 2.5])
def test_forward_matches_jax_pallas_bf16(interpret_mode, cfg_scale):
    """bf16 matmul operands on both sides: the JAX Pallas kernels (interpret
    mode) and the port's plain versions at matmul_dtype bfloat16. Both round
    the same operands; summation order differs, so an occasional operand
    rounds one bf16 ulp (2^-8 relative) apart. Outputs here reach ~1.8 and
    differ by ~3e-4: rtol 2e-3, atol 1e-3."""
    jax_model, params = _jax_model()
    port = _port_model(params, torch.bfloat16)
    got, want = _run_both(jax_model, params, port, _inputs(), cfg_scale, 37,
                          band=BAND, use_pallas=True)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the slice: beatmap -> featurize -> sampler -> .osu, against the JAX sampler
# ---------------------------------------------------------------------------


def test_sampler_slice_matches_jax(tmp_path):
    """4 CFG denoise steps on a toy fixture (T = 34, padded to 48 by a
    16-row bucket), each side from its own featurizer, with the same initial
    noise and JAX's per-step draws fed to the port. Coordinates agree within
    5e-3 (as the JAX package's chain parity tests hold them); the port's
    result decodes to a .osu that reparses."""
    from osu_diffusion_tpu.beatmap import Beatmap
    from osu_diffusion_tpu.data import beatmap_to_sequence as jax_featurize
    from osu_diffusion_tpu.data.process import split_and_process_sequence_no_augment as jax_split
    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu.sampling import Sampler as JaxSampler
    from osu_diffusion_tpu_torch.beatmap import Beatmap as PortBeatmap
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
    from osu_diffusion_tpu_torch.export import create_beatmap
    from osu_diffusion_tpu_torch.data.process import split_and_process_sequence_no_augment
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.sampling import Sampler

    steps, cfg_scale, bucket = 4, 2.0, 16
    beatmap = Beatmap.from_path(FIXTURE)
    jax_model, params = _jax_model()
    port = _port_model(params, torch.float32)
    y = np.array([3, CLASSES])

    (_, jo, jc), t_real = jax_split(jnp.asarray(jax_featurize(beatmap)))
    port_beatmap = PortBeatmap.from_path(FIXTURE)  # the port parses with its own copy
    seq = beatmap_to_sequence(port_beatmap)
    (_, to, tc), _ = split_and_process_sequence_no_augment(torch.from_numpy(seq))
    assert 20 <= t_real <= 48
    z_half = np.random.RandomState(2).randn(1, t_real, 2).astype(np.float32)
    z = np.concatenate([z_half, z_half])

    def doubled(a):
        return jnp.concatenate([a[None], a[None]]) if isinstance(a, jax.Array) else torch.stack([a, a])

    rng = jax.random.PRNGKey(7)
    jax_sampler = JaxSampler(jax_model, jax_create(str(steps), noise_schedule="squaredcos_cap_v2"),
                             cfg_scale=cfg_scale, band=BAND, bucket=bucket)
    want = np.asarray(jax_sampler(params, jnp.asarray(z), doubled(jo - jo[0]), doubled(jc),
                                  jnp.asarray(y, jnp.int32), rng))

    step_rngs = jax.random.split(rng, steps)  # JAX p_sample_loop's per-step keys

    def jax_noise(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(step_rngs[k], shape, jnp.float32)))

    sampler = Sampler(port, create_diffusion(str(steps), noise_schedule="squaredcos_cap_v2"),
                      cfg_scale=cfg_scale, band=BAND, bucket=bucket)
    got = sampler(torch.from_numpy(z), doubled(to - to[0]), doubled(tc), torch.from_numpy(y),
                  noise_fn=jax_noise).numpy()
    assert got.shape == want.shape == (2, t_real, 2)
    np.testing.assert_allclose(got, want, atol=5e-3)

    out_seq = np.concatenate([got[0], seq[:, 2:]], axis=-1)
    path = str(tmp_path / "port.osu")
    create_beatmap(out_seq, port_beatmap, "port slice").write_path(path)
    assert len(Beatmap.from_path(path).hit_objects()) == len(beatmap.hit_objects())


def test_sample_cli_writes_a_beatmap(tmp_path, capsys):
    """The port's sample command end to end on the CPU (plain versions):
    reference-style checkpoint in, .osu out."""
    from osu_diffusion_tpu.beatmap import Beatmap
    from osu_diffusion_tpu_torch.cli import build_sample_parser, sample_main
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    torch.manual_seed(0)
    model = DiT_models["DiT-S"](num_classes=CLASSES)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "adaLN" in name or "final_layer.linear" in name:
                p.add_(torch.randn_like(p) * 0.02)
    ckpt = str(tmp_path / "dit_s.pt")
    torch.save({"ema": model.state_dict(), "args": argparse.Namespace(model="DiT-S")}, ckpt)
    args = build_sample_parser().parse_args([
        "--beatmap", FIXTURE, "--ckpt", ckpt, "--model", "DiT-S",
        "--num-classes", str(CLASSES), "--num-sampling-steps", "3", "--cfg-scale", "2.0",
        "--device", "cpu", "--results-dir", str(tmp_path / "results"),
    ])
    written = sample_main(args)
    assert "seq len 34" in capsys.readouterr().out
    assert len(written) == 1
    assert len(Beatmap.from_path(written[0]).hit_objects()) == len(Beatmap.from_path(FIXTURE).hit_objects())
