"""The port's train command end to end on the CPU (the kernels' plain
versions): DiT-S with 100 classes, batch 8, seq-len 32, 6 steps on a small
Track dataset made from the toy fixtures. It logs in the reference format,
saves a checkpoint in the reference layout, resumes from it, and the saved
file samples with the sample command."""
import math
import os
import shutil

import torch

from osu_diffusion_tpu.evals.plot_loss import parse_losses

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "assets", "toy_datasets")


def _dataset(root):
    """Two Track folders of stream fixtures plus kimi_no_bouken (757
    points), file names prefixed with their class label."""
    names = sorted(os.listdir(os.path.join(FIXTURES, "stream")))
    for i, name in enumerate(names):
        track = os.path.join(root, f"Track{i % 2:05d}", "beatmaps")
        os.makedirs(track, exist_ok=True)
        shutil.copy(os.path.join(FIXTURES, "stream", name), os.path.join(track, f"{i:06d} map.osu"))
    shutil.copy(os.path.join(FIXTURES, "kimi_no_bouken.osu"),
                os.path.join(root, "Track00000", "beatmaps", "000099 kimi.osu"))


def test_train_cli_logs_saves_resumes_and_samples(tmp_path, capsys):
    from osu_diffusion_tpu_torch.beatmap import Beatmap
    from osu_diffusion_tpu_torch.cli import build_sample_parser, build_train_parser, sample_main, train_main
    from osu_diffusion_tpu_torch.train.checkpoint import latest_checkpoint

    data = str(tmp_path / "data")
    _dataset(data)
    results = str(tmp_path / "results")
    argv = ["--data-path", data, "--data-start", "0", "--data-end", "2", "--num-classes", "100",
            "--model", "DiT-S", "--global-batch-size", "8", "--seq-len", "32", "--stride", "8",
            "--num-workers", "2", "--log-every", "2", "--epochs", "50", "--results-dir", results,
            "--ckpt-every", "4", "--device", "cpu"]
    args = build_train_parser().parse_args(argv + ["--max-steps", "6"])
    assert (args.use_bf16, args.remat, args.l1_loss, args.lr) == (True, True, True, 1e-4)
    summary = train_main(args)
    assert summary["final_step"] == 6 and math.isfinite(summary["last_loss"])

    exp = summary["experiment_dir"]
    assert os.path.basename(exp) == "000-DiT-S"
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    assert "Train Steps/Sec:" in log and log.rstrip().endswith("Done!")
    losses = parse_losses(os.path.join(exp, "log.txt"))  # the reference's loss-curve reader
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)

    ckpt_path = latest_checkpoint(summary["checkpoint_dir"])
    assert os.path.basename(ckpt_path) == "0000004.pt"
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"model", "ema", "opt", "args", "step"} and ckpt["step"] == 4
    assert ckpt["args"]["model"] == "DiT-S" and ckpt["opt"]["state"]
    assert not torch.equal(ckpt["model"]["blocks.0.mlp.fc1.weight"], ckpt["ema"]["blocks.0.mlp.fc1.weight"])

    # resume: model, EMA, optimizer and step come back; one more step runs
    resumed = train_main(build_train_parser().parse_args(argv + ["--max-steps", "5", "--ckpt", ckpt_path]))
    assert resumed["final_step"] == 5
    assert "Restored from checkpoint" in open(os.path.join(resumed["experiment_dir"], "log.txt")).read()

    # the trained file samples (its EMA weights) with the sample command
    capsys.readouterr()
    fixture = os.path.join(FIXTURES, "visual_spacing", "test - visual spacing (OliBomby) [test12].osu")
    written = sample_main(build_sample_parser().parse_args([
        "--beatmap", fixture, "--ckpt", ckpt_path, "--model", "DiT-S", "--num-classes", "100",
        "--num-sampling-steps", "2", "--device", "cpu", "--results-dir", str(tmp_path / "samples"),
    ]))
    assert "seq len 34" in capsys.readouterr().out
    assert len(written) == 1
    assert len(Beatmap.from_path(written[0]).hit_objects()) == len(Beatmap.from_path(fixture).hit_objects())
