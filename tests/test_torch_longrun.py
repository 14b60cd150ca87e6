"""The port's toy learning run (osu_diffusion_tpu_torch/tools/longrun_toy.py)
on the CPU: its dataset builder writes the same files, byte for byte, as
tools/longrun_toy.py (loaded by path), and a tiny run (hidden 32, two chunks
of 2 steps, one suite, 2 predictions of 2 sampling steps) writes one JSON
line per chunk, resumes the second chunk from the first one's checkpoint
and scores the EMA weights; with `--steps-per-call 2` each chunk is one
call of 2 steps."""
import importlib.util
import json
import os

import pytest
import torch

from osu_diffusion_tpu_torch.evals import toy
from osu_diffusion_tpu_torch.models.dit import DiT, DiT_models
from osu_diffusion_tpu_torch.tools import longrun_toy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets", "toy_datasets")


def _jax_longrun():
    spec = importlib.util.spec_from_file_location("jax_longrun_toy",
                                                  os.path.join(ROOT, "tools", "longrun_toy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("pad_rows", [None, 160])
def test_build_dataset_writes_jax_bytes(tmp_path, pad_rows):
    n = longrun_toy.build_dataset(str(tmp_path / "port"), ASSETS, pad_rows=pad_rows)
    jn = _jax_longrun().build_dataset(str(tmp_path / "jax"), ASSETS, pad_rows=pad_rows)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert n == jn == 63 and len(got) == 63
    assert got.keys() == want.keys()
    for name in got:
        assert got[name] == want[name], name


def test_tiny_run_resumes_between_chunks(tmp_path, monkeypatch, capfd):
    monkeypatch.setitem(DiT_models, "DiT-T",
                        lambda **kw: DiT(hidden_size=32, depth=2, num_heads=2, **kw))
    scored = []  # the weights each eval round scores
    evaluate_suite = toy.evaluate_suite

    def recording(sampler, *args, **kwargs):
        scored.append({k: v.clone() for k, v in sampler.model.state_dict().items()})
        return evaluate_suite(sampler, *args, **kwargs)

    monkeypatch.setattr(toy, "evaluate_suite", recording)  # main imports it when it starts
    results, log = tmp_path / "results", tmp_path / "evals.jsonl"
    longrun_toy.main([
        "--model", "DiT-T", "--total-steps", "4", "--chunk", "2", "--batch", "4",
        "--seq-len", "32", "--stride", "8", "--num-predictions", "2",
        "--num-sampling-steps", "2", "--suites", "symmetry", "--results-dir", str(results),
        "--data-dir", str(tmp_path / "data"), "--log", str(log), "--device", "cpu",
    ])
    out = capfd.readouterr().out  # capfd: the eval watchdog writes to a real stderr
    assert "dataset: 63 fixtures over 8 tracks" in out and "longrun done" in out
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4]
    for r in recs:
        assert set(r) == {"step", "train_s", "symmetry", "eval_s"}
        assert 0.0 <= r["symmetry"] <= 1.0
    exps = sorted(os.listdir(results))
    assert len(exps) == 2
    with open(results / exps[1] / "log.txt") as f:
        second = f.read()
    assert f"Restored from checkpoint at {results / exps[0] / 'checkpoints' / '0000002.pt'}" in second
    assert sorted(os.listdir(results / exps[1] / "checkpoints")) == ["0000004.pt"]
    # the last round scored the final checkpoint's EMA weights, not the raw model's
    final = torch.load(results / exps[1] / "checkpoints" / "0000004.pt", map_location="cpu")
    assert len(scored) == 2 and scored[-1].keys() == final["ema"].keys()
    assert all(torch.equal(scored[-1][k], final["ema"][k]) for k in scored[-1])
    assert not all(torch.equal(scored[-1][k], final["model"][k]) for k in scored[-1])


def test_steps_per_call_reaches_the_trainer(tmp_path, monkeypatch, capfd):
    """--steps-per-call 2 over two chunks of 2 steps: every chunk's
    TrainConfig has steps_per_call 2, each chunk is one call (the trainer
    logs it), and the run ends at step 4 with one JSON line a chunk."""
    from osu_diffusion_tpu_torch.train import trainer

    monkeypatch.setitem(DiT_models, "DiT-T",
                        lambda **kw: DiT(hidden_size=32, depth=1, num_heads=2, **kw))
    configs = []
    train = trainer.train

    def recording(config):
        configs.append(config)
        return train(config)

    monkeypatch.setattr(trainer, "train", recording)  # main imports it when it starts
    results, log = tmp_path / "results", tmp_path / "evals.jsonl"
    longrun_toy.main([
        "--model", "DiT-T", "--total-steps", "4", "--chunk", "2", "--batch", "4",
        "--seq-len", "32", "--stride", "8", "--steps-per-call", "2", "--num-predictions", "2",
        "--num-sampling-steps", "2", "--suites", "symmetry", "--results-dir", str(results),
        "--data-dir", str(tmp_path / "data"), "--log", str(log), "--device", "cpu",
    ])
    assert "longrun done" in capfd.readouterr().out
    assert [(c.steps_per_call, c.max_steps) for c in configs] == [(2, 2), (2, 4)]
    assert [json.loads(line)["step"] for line in log.read_text().splitlines()] == [2, 4]
    for exp in sorted(os.listdir(results)):
        with open(results / exp / "log.txt") as f:
            assert "2 optimizer steps a call, run eagerly on cpu" in f.read()
