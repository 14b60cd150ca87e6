"""The port's sample CLI with the flags of the serving path, on the CPU
(plain versions): each writes a .osu that reparses; the refine pass writes
its second file, also under --quantize-weights; --plot-time trims the map
and --make-animation writes animation.gif (with matplotlib, which the port
imports only inside those branches); --quantize-weights with
--compute-dtype bf16 is refused; `serving_regime_warnings` stays silent
across the grid of the H100 sweeps behind it (neither fast flag measured
a losing regime there), and sample_main hands it the flags, the map's
length and the CFG-doubled batch. A 3-block, 32-wide DiT registered as a
CLI model, 3 denoise steps, the toy fixture visual spacing (T = 34)."""
import argparse
import os

import pytest
import torch

from osu_diffusion_tpu.beatmap import Beatmap
from osu_diffusion_tpu_torch.cli import build_sample_parser, sample_main
from osu_diffusion_tpu_torch.models.dit import DiT, DiT_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "assets", "toy_datasets", "visual_spacing",
                       "test - visual spacing (OliBomby) [test12].osu")
CLASSES = 7


def _tiny(**kwargs):
    return DiT(hidden_size=32, depth=3, num_heads=2, **kwargs)


@pytest.fixture
def cli(tmp_path, monkeypatch):
    """Runs the sample CLI on a random tiny checkpoint with extra flags
    ("{ckpt}" stands for its path); returns the paths written."""
    monkeypatch.setitem(DiT_models, "DiT-T", _tiny)
    torch.manual_seed(0)
    model = _tiny(num_classes=CLASSES)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "adaLN" in name or "final_layer.linear" in name:
                p.add_(torch.randn_like(p) * 0.05)
    ckpt = str(tmp_path / "tiny.pt")
    torch.save({"ema": model.state_dict(), "args": argparse.Namespace(model="DiT-T")}, ckpt)

    def run(*flags):
        args = build_sample_parser().parse_args([
            "--beatmap", FIXTURE, "--ckpt", ckpt, "--model", "DiT-T",
            "--num-classes", str(CLASSES), "--num-sampling-steps", "3", "--cfg-scale", "2.0",
            "--seq-len", "16", "--device", "cpu", "--results-dir", str(tmp_path / "results"),
            *[f.replace("{ckpt}", ckpt) for f in flags]])
        return sample_main(args)

    return run


def _reparses(path, n_objects=None):
    hit_objects = Beatmap.from_path(path).hit_objects()
    assert len(hit_objects) > 0
    if n_objects is not None:
        assert len(hit_objects) == n_objects


FLAGS = {
    "ddim": ["--sampling-method", "ddim"],
    "bf16": ["--compute-dtype", "bf16"],
    "augment_flip": ["--augment-flip"],
    "no_use_amp": ["--no-use-amp"],
    "accel_interval": ["--accel-interval", "2"],
    "accel_span": ["--accel-interval", "2", "--accel-span", "0", "2"],
    "accel_tau": ["--accel-tau", "0.1", "--accel-max-skip", "1"],
    "int8_accel_ddim": ["--quantize-weights", "--accel-interval", "2", "--sampling-method", "ddim"],
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_sample_cli_flag_writes_a_beatmap(cli, name):
    written = cli(*FLAGS[name])
    assert len(written) == 1 and written[0].endswith("result None 0.osu")
    _reparses(written[0], len(Beatmap.from_path(FIXTURE).hit_objects()))


@pytest.mark.parametrize("quantize", [False, True])
def test_sample_cli_refine_writes_a_second_beatmap(cli, quantize):
    written = cli("--refine-ckpt", "{ckpt}", "--refine-iters", "2",
                  *(["--quantize-weights"] if quantize else []))
    assert len(written) == 2
    assert written[0].endswith("result None 0.osu") and written[1].endswith("result None 0 2.osu")
    for path in written:
        _reparses(path, len(Beatmap.from_path(FIXTURE).hit_objects()))


def _plot_time() -> float:
    """A time (ms) a few objects into the fixture."""
    first = Beatmap.from_path(FIXTURE).hit_objects()[3].time
    return first.total_seconds() * 1000


def test_sample_cli_plot_time_trims_the_map(cli, capsys):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    written = cli("--plot-time", str(_plot_time()))
    assert "Sequence trimmed to length 16" in capsys.readouterr().out
    _reparses(written[0])


def test_sample_cli_make_animation_writes_a_gif(cli):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    written = cli("--plot-time", str(_plot_time()), "--make-animation")
    gif = os.path.join(os.path.dirname(written[0]), "animation.gif")
    assert os.path.getsize(gif) > 0
    _reparses(written[0])


def test_sample_cli_refuses_int8_with_the_bf16_stream(cli):
    with pytest.raises(ValueError, match="int8 under the bf16 stream"):
        cli("--quantize-weights", "--compute-dtype", "bf16")


# the sweeps behind serving_regime_warnings (PERF.md §6): int8 against
# f32 by dispatch batch and T, and Δ-cache intervals 1-5 by T
SWEEP_BATCHES, SWEEP_INT8_TS = (2, 8, 16, 32, 64), (32, 128, 768)
SWEEP_ACCEL_TS, SWEEP_INTERVALS = (32, 64, 128), (1, 2, 3, 4, 5)


def _silent(*args, **kwargs):
    """serving_regime_warnings' result, with any warning an error."""
    import warnings

    from osu_diffusion_tpu_torch.cli import serving_regime_warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return serving_regime_warnings(*args, **kwargs)


def test_int8_silent_across_the_measured_sweep():
    """int8 measured faster than f32 at every point of the H100 sweep,
    batch 32 at T 32 too (where the TPU's rule warned): no warning."""
    for b in SWEEP_BATCHES:
        for t in SWEEP_INT8_TS:
            assert _silent(True, 1, t_len=t, dispatch_batch=b) == [], (b, t)


def test_accel_depth_silent_across_the_measured_sweep():
    """No Δ-cache depth measured slower than a shallower one on the H100,
    interval 4 and 5 at T 32 too (where the TPU's rule warned)."""
    for t in SWEEP_ACCEL_TS:
        for k in SWEEP_INTERVALS:
            assert _silent(False, k, t_len=t, dispatch_batch=2) == [], (t, k)


def test_both_flags_in_no_losing_regime_return_nothing():
    assert _silent(True, 5, t_len=32, dispatch_batch=64) == []
    assert _silent(False, 1, t_len=757, dispatch_batch=2) == []


def test_sample_cli_checks_the_serving_regime(cli, monkeypatch, capsys):
    """sample_main passes the flags, the map's length and the CFG-doubled
    dispatch batch, as the JAX CLI does, and (no losing regime on the
    card) the run emits no RuntimeWarning."""
    import warnings

    import osu_diffusion_tpu_torch.cli as cli_module

    calls = []
    check = cli_module.serving_regime_warnings
    monkeypatch.setattr(cli_module, "serving_regime_warnings",
                        lambda *a, **k: calls.append((a, k)) or check(*a, **k))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        written = cli("--quantize-weights", "--accel-interval", "5")
    assert len(written) == 1
    t_len = int(capsys.readouterr().out.split("seq len ")[1].split()[0])  # the map's length
    assert calls == [((True, 5), {"t_len": t_len, "dispatch_batch": 2})]
