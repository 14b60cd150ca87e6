"""Nothing under benchmarks/ imports JAX or the JAX package, by top-level
module names compared whole (the port's name begins with the JAX
package's); the reference imports nothing of the port either."""
import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "osu_diffusion_tpu"}


def sources(sub=""):
    out = []
    for base, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_is_plain(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"osu_diffusion_tpu_torch"})


def test_a_run_loads_no_jax():
    """The harness, every driver and every metric imported in one process:
    no JAX module comes with them."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmarks.run, benchmarks.harness.controls\n"
        "from benchmarks.harness.cell import find\n"
        "import json\n"
        "spec = json.load(open(%r))\n"
        "for w in spec['workloads']:\n"
        "    find(w['name'])\n"
        "import benchmarks.drivers.sample, benchmarks.drivers.train\n"
        "import osu_diffusion_tpu_torch.sampling, osu_diffusion_tpu_torch.train.train_step\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
    ) % (ROOT, os.path.join(ROOT, "BENCHMARK.json"), FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
