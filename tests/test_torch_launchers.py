"""The port's launchers at the repo root and its sample notebook, on the CPU.

- train_torch.sh, with a `python` shim first on PATH that records its argv,
  writes checkpoints and crashes on its first call and stops the loop on
  its second: the restart resumes from the newest
  <results>/*/checkpoints/<7 digits>.pt through --ckpt.
- train_torch.bat and sample_torch.bat: one command each, the JAX files'
  flags, which the port's parsers take.
- notebooks/osu_diffusion_sample_torch.ipynb: its code cells in order in a
  process that never imports jax or the JAX package, with a fixture map, a
  seeded random DiT-S checkpoint, 2 steps and DEVICE "cpu"; a .osu is
  written.
"""
import json
import os
import shlex
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "osu_diffusion_tpu")


def test_train_launcher_resumes_from_the_newest_checkpoint(tmp_path):
    calls = tmp_path / "calls.txt"
    shim_dir = tmp_path / "bin"
    shim_dir.mkdir()
    shim = shim_dir / "python"
    shim.write_text(f"""#!/bin/bash
printf '%s\\n' "$*" >> {shlex.quote(str(calls))}
if [ "$(wc -l < {shlex.quote(str(calls))})" -eq 1 ]; then
    # the first run leaves checkpoints of two experiments, then crashes
    mkdir -p results/000-DiT-S/checkpoints results/001-DiT-S/checkpoints
    touch results/000-DiT-S/checkpoints/0000040.pt results/000-DiT-S/checkpoints/0000080.pt \\
          results/001-DiT-S/checkpoints/0000120.pt results/001-DiT-S/checkpoints/0000160.pt.tmp \\
          results/001-DiT-S/checkpoints/latest.pt
    exit 1
fi
kill -TERM "$PPID"  # the second run stops the launcher's loop
""")
    shim.chmod(0o755)
    env = dict(os.environ, PATH=f"{shim_dir}:{os.environ['PATH']}")
    res = subprocess.run(["bash", os.path.join(ROOT, "train_torch.sh"), "DATA", "--model", "DiT-S"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode != 0  # the loop never ends by itself
    argvs = [line.split() for line in calls.read_text().splitlines()]
    train = os.path.join(ROOT, "train_torch.py")
    assert argvs[0] == [train, "--data-path", "DATA", "--results-dir", "results", "--model", "DiT-S"]
    assert argvs[1] == [train, "--data-path", "DATA", "--results-dir", "results",
                        "--ckpt", "results/001-DiT-S/checkpoints/0000120.pt", "--model", "DiT-S"]
    assert "train_torch.py exited (1); restarting" in res.stdout
    assert "Resuming from results/001-DiT-S/checkpoints/0000120.pt" in res.stdout


def _bat_command(name):
    """The one command of a .bat launcher, split, without the %* tail."""
    lines = [line for line in open(os.path.join(ROOT, name)).read().splitlines() if line.strip()]
    assert len(lines) == 1, lines
    words = shlex.split(lines[0].replace("\\", "/"))
    assert words[0] == "@python" and words[-1] == "%*"
    return words[1:-1]


def _jax_bat_flags(name):
    """The flags of the JAX package's .bat launcher's python line."""
    line = next(line for line in open(os.path.join(ROOT, name)).read().splitlines()
                if line.startswith("python "))
    return shlex.split(line.replace("\\", "/"))[2:-1]


@pytest.mark.parametrize("bat,jax_bat", [("train_torch.bat", "train.bat"), ("sample_torch.bat", "sample.bat")])
def test_bat_launchers_copy_the_jax_flags(bat, jax_bat):
    from osu_diffusion_tpu_torch.cli import build_sample_parser, build_train_parser

    script, *flags = _bat_command(bat)
    assert script == jax_bat.replace(".bat", "_torch.py")
    assert os.path.exists(os.path.join(ROOT, script))
    assert flags == _jax_bat_flags(jax_bat)
    if bat.startswith("train"):
        args = build_train_parser().parse_args(flags)
    else:  # the user's %* names the map
        args = build_sample_parser().parse_args(flags + ["--beatmap", "my_map.osu"])
    assert args.model == "DiT-L"


def test_sample_notebook_runs_on_the_cpu(tmp_path):
    from osu_diffusion_tpu_torch import CONTEXT_SIZE
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    nb = json.load(open(os.path.join(ROOT, "notebooks", "osu_diffusion_sample_torch.ipynb")))
    cells = ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]
    assert any('DEVICE = "cuda"' in c for c in cells)
    text = "\n".join(cells)
    assert "build_sample_parser" in text and "sample_main" in text
    assert all(f"import {m}" not in text and f"from {m} " not in text and f"from {m}." not in text
               for m in FORBIDDEN)
    ckpt_line = next(line for line in text.splitlines() if "wget" in line)
    assert ckpt_line.lstrip().startswith("# !wget")

    model = DiT_models["DiT-S"](num_classes=52670, context_size=CONTEXT_SIZE)
    model.initialize_weights(torch.Generator().manual_seed(0))
    ckpt = tmp_path / "dit_s_random.pt"
    torch.save({"ema": model.state_dict()}, ckpt)
    del model
    os.symlink(os.path.join(ROOT, "assets"), tmp_path / "assets")  # the CLI's --beatmap-idx default
    overrides = dict(CKPT=str(ckpt), MODEL="DiT-S", DEVICE="cpu", SAMPLING_STEPS=2,
                     BEATMAP=os.path.join(ROOT, "assets", "toy_datasets", "visual_spacing",
                                          "test - visual spacing (OliBomby) [test12].osu"))
    runner = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
ns = {{}}
for cell in {cells!r}:
    exec(cell, ns)
    ns.update({{k: v for k, v in {overrides!r}.items() if k in ns}})
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print(json.dumps(ns["written"]))
"""
    # torch at 2 threads, as tests/test_torch_bench.py holds it: at one a core
    # beside busy workers a CPU forward crawls
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, "-c", runner], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    written = json.loads(res.stdout.strip().splitlines()[-1])
    assert written and all(p.endswith(".osu") for p in written)
    assert all(os.path.getsize(tmp_path / p) > 0 for p in written)
