"""The JAX package's native featurizer for the port's tests: built from
native/osu_native.cpp with the JAX package's flags
(osu_diffusion_tpu/native/build.py) into a test's temporary directory and
loaded from there, so that this build never races another test's build of
the JAX package's own library file."""
import os
import shutil
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_native(out_dir):
    """osu_diffusion_tpu.native with its library loaded (skips without g++)."""
    from osu_diffusion_tpu import native

    if not native.available():
        if shutil.which("g++") is None:
            pytest.skip("no g++ on PATH to build the native featurizer")
        path = os.path.join(str(out_dir), native.LIB_NAME)
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                        os.path.join(ROOT, "native", "osu_native.cpp"), "-o", path], check=True)
        assert native.load_library(path) is not None
    return native


def port_native():
    """osu_diffusion_tpu_torch.native, built at first use (skips without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH to build the native featurizer")
    from osu_diffusion_tpu_torch import native

    assert native.available()
    return native
