"""Build the native featurizer, csrc/osu_native.cpp, with g++.

`native.load_library` calls `build` at first use; `python -m
osu_diffusion_tpu_torch.native.build` builds it by hand. The library goes to
the package's `build/` directory, named by a hash of the source, the flags,
`g++ --version` and every target option that `-march=native` sets on this
host (`g++ -march=native -Q --help=target`). The build directory can be
copied to another host: one with other CPU features then builds its own
library instead of loading code that may not run there.
"""
from __future__ import annotations

import os
import shutil
import subprocess

from osu_diffusion_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR, compile_library, digest

SRC = os.path.join(CSRC_DIR, "osu_native.cpp")
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def compiler() -> str | None:
    """g++ on PATH, or None."""
    return shutil.which("g++")


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


def library_path(gxx: str) -> tuple[str, str]:
    """(the library's path for this source, these flags, this compiler and
    this host; the first line of `g++ --version`)."""
    version = _run([gxx, "--version"])
    target = _run([gxx, "-march=native", "-Q", "--help=target"])
    name = f"libosu_native-{digest([SRC], ' '.join(FLAGS), version, target)}.so"
    return os.path.join(BUILD_DIR, name), version.splitlines()[0]


def build(gxx: str) -> dict:
    """Build the library with `gxx`, or reuse the one at its path. Returns
    {"path", "seconds" (0.0 when reused), "log", "compiler"}; raises
    cuda_build.BuildError with the compiler's output when the build fails."""
    path, compiler_version = library_path(gxx)
    return {"path": path, **compile_library([gxx, *FLAGS, SRC], path), "compiler": compiler_version}


if __name__ == "__main__":
    gxx = compiler()
    if gxx is None:
        raise SystemExit("no g++ on PATH")
    info = build(gxx)
    print(f"{info['path']} ({info['compiler']}, {info['seconds']:.1f} s)")
