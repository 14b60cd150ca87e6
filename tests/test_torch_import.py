"""The PyTorch port never imports jax, flax or any module of the JAX package
(`osu_diffusion_tpu`, `osu_diffusion_tpu.*`), directly or through any import
chain, and importing it builds nothing (no kernel, no native featurizer)
and needs no CUDA."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules the port may never pull in: jax and its kin, and the JAX package
# (whose jax-free modules are copied into the port instead)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "osu_diffusion_tpu")

PROBE = r"""
import importlib, pkgutil, sys
import osu_diffusion_tpu_torch as pkg
assert "torch" not in sys.modules, "the package root imports torch"
import osu_diffusion_tpu_torch.cli  # both entry points and all they pull in
import osu_diffusion_tpu_torch.models.quantize, osu_diffusion_tpu_torch.ops.quant  # int8 serving
import osu_diffusion_tpu_torch.parallel  # the mesh and context parallelism
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import torch
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN + ("triton",))
assert not bad, bad
assert not torch.cuda.is_initialized()
from osu_diffusion_tpu_torch.ops import cuda_build
assert not cuda_build.build_info, "a kernel was built at import"
from osu_diffusion_tpu_torch import native
assert not native.build_info, "the native featurizer was built at import"
print("ok")
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", f"FORBIDDEN = {FORBIDDEN!r}\n" + PROBE],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "ok"


def _launcher_probe(launcher: str) -> subprocess.CompletedProcess:
    """Run a root launcher as a module (its main not called) and list what
    of jax or the JAX package it pulled in."""
    probe = (f"import sys, runpy; runpy.run_path({launcher!r}, run_name='not_main'); "
             f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
             "assert not bad, bad")
    return subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_sample_launcher_imports_no_jax():
    res = _launcher_probe("sample_torch.py")
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("launcher", ["train_torch.py", "chip_smoke.py", "train_nodist_torch.py",
                                      "data_loading_torch.py"])
def test_train_and_smoke_launchers_import_no_jax(launcher):
    res = _launcher_probe(launcher)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_and_its_launchers_import_no_matplotlib():
    """The GPU machine has no matplotlib: the package, the sample launcher,
    chip_smoke.py and data_loading_torch.py import it only inside the
    sample CLI's plot and animation branches and the loader CLI's
    plotfirst."""
    probe = (
        "import importlib, pkgutil, runpy, sys\n"
        "import osu_diffusion_tpu_torch as pkg\n"
        "for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "for launcher in ('sample_torch.py', 'chip_smoke.py', 'data_loading_torch.py'):\n"
        "    runpy.run_path(launcher, run_name='not_main')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'matplotlib']\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# what a GPU host may lack besides jax: the evals import these inside the
# functions that use them
ANALYTICS = ("sklearn", "pandas", "matplotlib")


@pytest.mark.parametrize("entry", [
    "runpy.run_path('osu_diffusion_tpu_torch/tools/longrun_toy.py', run_name='not_main')",
    # `python -m osu_diffusion_tpu_torch.evals.toy --help`: main parses, prints and exits 0
    "sys.argv = ['toy', '--help']\n"
    "try:\n"
    "    runpy.run_module('osu_diffusion_tpu_torch.evals.toy', run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    assert e.code == 0, e.code\n",
    # every module of the evals package
    "import pkgutil, importlib, osu_diffusion_tpu_torch.evals as ev\n"
    "for mod in pkgutil.walk_packages(ev.__path__, ev.__name__ + '.'):\n"
    "    importlib.import_module(mod.name)\n",
])
def test_evals_and_longrun_import_no_jax_or_analytics(entry):
    probe = (f"import runpy, sys\n{entry}\n"
             f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ANALYTICS!r}]\n"
             "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
