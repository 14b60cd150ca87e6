"""The port's train command end to end on the CPU (the kernels' plain
versions): DiT-S with 100 classes, batch 8, seq-len 32, 6 steps on a small
Track dataset made from the toy fixtures. It logs in the reference format,
saves a checkpoint in the reference layout, resumes from it, and the saved
file samples with the sample command."""
import math
import os
import shutil

import pytest
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


def _train_argv(data, results, *extra):
    """DiT-S, 100 classes, batch 8, seq-len 32 on the CPU; stride 32 keeps
    an epoch to a few steps."""
    return ["--data-path", data, "--data-start", "0", "--data-end", "2", "--num-classes", "100",
            "--model", "DiT-S", "--global-batch-size", "8", "--seq-len", "32", "--stride", "32",
            "--num-workers", "2", "--log-every", "1", "--results-dir", results, "--device", "cpu",
            *extra]


def _fresh_init(num_classes):
    from osu_diffusion_tpu_torch import CONTEXT_SIZE
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.train.trainer import CLASS_DROPOUT_PROB

    model = DiT_models["DiT-S"](num_classes=num_classes, context_size=CONTEXT_SIZE,
                                class_dropout_prob=CLASS_DROPOUT_PROB)
    model.initialize_weights(torch.Generator().manual_seed(0))
    return model.state_dict()


def test_embed_only_epochs_freeze_then_unfreeze(tmp_path):
    """--embed-only-epochs 1, resumed from a 3-step checkpoint (from the
    adaLN-Zero init the label table gets no gradient until the zero-init
    layers have moved, so the fine-tuning flow starts from trained weights):
    the log has the freeze line at the start and the un-freeze line when
    epoch 1 begins, before its first step; a checkpoint inside epoch 0 has
    every weight but the label table equal to the loaded ones, bit for bit
    (though AdamW's restored moments would move them), and the table moved;
    after epoch 0 the other weights train."""
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.train.trainer import LABEL_TABLE

    data = str(tmp_path / "data")
    _dataset(data)
    first = train_main(build_train_parser().parse_args(
        _train_argv(data, str(tmp_path / "a"), "--max-steps", "3", "--ckpt-every", "3")))
    src = os.path.join(first["checkpoint_dir"], "0000003.pt")
    argv = _train_argv(data, str(tmp_path / "b"), "--epochs", "2", "--ckpt-every", "1",
                       "--embed-only-epochs", "1", "--ckpt", src)
    summary = train_main(build_train_parser().parse_args(argv))
    log = open(os.path.join(summary["experiment_dir"], "log.txt")).read()
    assert "Freezing non-embedding layers for 1 epochs" in log
    # as the JAX trainer logs it: at the start of the first unfrozen epoch
    assert log.index("Beginning epoch 1") < log.index("Un-freezing non-embedding layers") \
        < log.index("Train Loss:", log.index("Beginning epoch 1"))
    steps_epoch0 = log[:log.index("Beginning epoch 1")].count("Train Loss:")
    assert 1 <= steps_epoch0 < summary["final_step"] - 3
    losses = parse_losses(os.path.join(summary["experiment_dir"], "log.txt"))
    assert all(math.isfinite(v) for v in losses)
    loaded = torch.load(src, weights_only=True)["model"]
    ckpt_dir = summary["checkpoint_dir"]
    frozen = torch.load(os.path.join(ckpt_dir, f"{3 + steps_epoch0:07d}.pt"), weights_only=True)["model"]
    after = torch.load(os.path.join(ckpt_dir, f"{summary['final_step']:07d}.pt"), weights_only=True)["model"]
    for name, w in loaded.items():
        if name != LABEL_TABLE:
            assert torch.equal(frozen[name], w), name
    assert not torch.equal(frozen[LABEL_TABLE], loaded[LABEL_TABLE])
    assert not torch.equal(after["blocks.0.mlp.fc1.weight"], loaded["blocks.0.mlp.fc1.weight"])


def test_relearn_embeds_resumes_with_another_class_count(tmp_path):
    """--relearn-embeds with --ckpt from a 100-class run, at 150 classes (the
    dataset's labels reach 99): the weights load except the label table,
    which keeps its seeded 151-row init;
    the run starts again at step 0 with a fresh optimizer. lr 0 keeps every
    weight where the load put it, so the saved step shows exactly that."""
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.train.trainer import LABEL_TABLE

    data = str(tmp_path / "data")
    _dataset(data)
    first = train_main(build_train_parser().parse_args(
        _train_argv(data, str(tmp_path / "a"), "--max-steps", "2", "--ckpt-every", "2")))
    src = os.path.join(first["checkpoint_dir"], "0000002.pt")
    argv = _train_argv(data, str(tmp_path / "b"), "--max-steps", "1", "--ckpt-every", "1",
                       "--ckpt", src, "--relearn-embeds", "--lr", "0")
    argv[argv.index("--num-classes") + 1] = "150"
    args = build_train_parser().parse_args(argv)
    assert args.relearn_embeds
    resumed = train_main(args)
    assert resumed["final_step"] == 1  # from step 0, not the file's 2
    log = open(os.path.join(resumed["experiment_dir"], "log.txt")).read()
    assert "Restored from checkpoint" in log
    saved = torch.load(os.path.join(resumed["checkpoint_dir"], "0000001.pt"), weights_only=True)
    source = torch.load(src, weights_only=True)
    assert torch.equal(saved["model"][LABEL_TABLE], _fresh_init(150)[LABEL_TABLE])
    assert saved["model"][LABEL_TABLE].shape[0] == 151 and source["model"][LABEL_TABLE].shape[0] == 101
    for name, w in source["model"].items():
        if name != LABEL_TABLE:
            assert torch.equal(saved["model"][name], w), name
    assert all(s["step"].item() == 1 for s in saved["opt"]["state"].values())


def test_train_nodist_launcher_pins_the_refine_timestep(monkeypatch):
    """train_nodist_torch.py builds the train command's config with
    max_timestep = 1 and nothing else changed."""
    import runpy
    import sys

    from osu_diffusion_tpu_torch.cli import build_train_parser, train_config_kwargs
    from osu_diffusion_tpu_torch.train import trainer

    seen = []
    monkeypatch.setattr(trainer, "train", seen.append)
    argv = ["--data-path", "d", "--model", "DiT-S", "--mlp-bwd", "fused", "--embed-only-epochs", "2"]
    monkeypatch.setattr(sys, "argv", ["train_nodist_torch.py", *argv])
    runpy.run_path(os.path.join(ROOT, "train_nodist_torch.py"), run_name="__main__")
    assert len(seen) == 1 and seen[0].max_timestep == 1
    want = trainer.TrainConfig(**train_config_kwargs(build_train_parser().parse_args(argv)))
    assert seen[0] == trainer.TrainConfig(**{**want.__dict__, "max_timestep": 1})
    assert (want.max_timestep, want.mlp_bwd, want.embed_only_epochs) == (None, "fused", 2)


@pytest.mark.parametrize("amp", [[], ["--use-amp"], ["--no-use-amp"], ["--use-amp", "--no-use-bf16"],
                                 ["--no-use-amp", "--use-bf16"]])
def test_train_flags_give_the_jax_config(amp):
    """--use-amp (the reference's name) overrides --use-bf16 when given, and
    --fine-tune-ids and --profile-dir are taken: every config key that both
    packages have gets JAX's value for the same arguments, but for the one
    default the port sets apart: one optimizer step a call, not JAX's 8
    (train/trainer.py; tests/test_torch_train_calls.py holds the flag when
    given)."""
    from osu_diffusion_tpu.cli import build_train_parser as jax_parser
    from osu_diffusion_tpu.cli import train_config_kwargs as jax_kwargs
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_config_kwargs

    argv = ["--data-path", "d", "--model", "DiT-S", "--fine-tune-ids", "3,5", "--profile-dir", "p",
            *amp]
    want = jax_kwargs(jax_parser().parse_args(argv))
    got = train_config_kwargs(build_train_parser().parse_args(argv))
    shared = set(want) & set(got)
    assert {"use_bf16", "profile_dir", "model", "seq_len", "num_workers", "steps_per_call"} <= shared
    assert (got["steps_per_call"], want["steps_per_call"]) == (1, 8)
    shared.remove("steps_per_call")
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["use_bf16"] == ("--no-use-amp" not in amp)
    assert got["profile_dir"] == "p"


@pytest.mark.parametrize("steps", [2, 4])
def test_profile_dir_writes_a_trace(tmp_path, steps):
    """DiT-S on the CPU with --profile-dir: the trace of the first
    profile_steps (3) steps is written after step 3, or at the end of a
    shorter run; the log names it and the featurizer."""
    import json

    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from osu_diffusion_tpu_torch.data.dataset import featurizer_name

    data = str(tmp_path / "data")
    _dataset(data)
    profile_dir = str(tmp_path / "profile")
    summary = train_main(build_train_parser().parse_args(_train_argv(
        data, str(tmp_path / "results"), "--max-steps", str(steps), "--profile-dir", profile_dir)))
    assert summary["final_step"] == steps
    trace = os.path.join(profile_dir, "trace-rank0.json")
    assert os.path.getsize(trace) > 0
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    log = open(os.path.join(summary["experiment_dir"], "log.txt")).read()
    written = log.index(f"Profiler trace written to {trace}")
    # after the third step, before its log line; or after the last step
    assert log.index("(step=0000002)") < written < log.index("(step=0000003)" if steps > 3 else "Done!")
    assert f"Featurizer: {featurizer_name()}" in log
