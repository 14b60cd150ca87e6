"""The port's sample CLI with the flags of the serving path, on the CPU
(plain versions): each writes a .osu that reparses; the refine pass writes
its second file, also under --quantize-weights; --plot-time trims the map
and --make-animation writes animation.gif (with matplotlib, which the port
imports only inside those branches); --quantize-weights with
--compute-dtype bf16 is refused. A 3-block, 32-wide DiT registered as a
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
