"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled by
nvcc for sm_90a into a shared library under the package's `build/` directory
(named by a hash of the source and the shared `csrc/*.cuh` headers, so an
edited source rebuilds), then loaded with ctypes. `build_all` starts one nvcc
per source at once. `digest` and `compile_library` also build the native
featurizer (native/build.py). Nothing here runs at import time, and nothing
here imports torch's CUDA pieces.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()  # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": compile seconds (0.0 when a built library was reused),
#          "log": nvcc's output, including ptxas register/shared-memory lines
#          (kept beside the library, so a reused one still has it)}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.isfile(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's standard home
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


class BuildError(RuntimeError):
    """A compiler failed; the message holds its output."""


def digest(paths, *extra: str) -> str:
    """A short hash of the files' bytes and the extra strings."""
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(f.read())
    for text in extra:
        h.update(text.encode())
    return h.hexdigest()[:16]


def compile_library(cmd: list[str], lib_path: str) -> dict:
    """Reuse `lib_path` if it exists, else run `cmd + ["-o", <temporary
    file>]` and move its output there. Returns {"seconds": compile seconds
    (0.0 when reused), "log": the compiler's output, kept beside the
    library}. Several processes may build the same library at once: each
    writes its own temporary file, and `os.replace` is atomic, so a reader
    never sees half a file."""
    log_path = lib_path + ".log"
    if os.path.isfile(lib_path):
        log = open(log_path).read() if os.path.isfile(log_path) else ""
        return {"seconds": 0.0, "log": f"reused {lib_path}\n{log}"}
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    start = time.perf_counter()
    res = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    if res.returncode != 0:
        raise BuildError(f"{' '.join(cmd)} failed (exit {res.returncode}):\n{res.stdout}{res.stderr}")
    with open(f"{tmp}.log", "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(f"{tmp}.log", log_path)
    os.replace(tmp, lib_path)
    return {"seconds": time.perf_counter() - start, "log": res.stdout + res.stderr}


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its library is missing, then load it."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        # an edited source or shared header rebuilds
        headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
        lib_path = os.path.join(BUILD_DIR, f"lib{name}-{digest([src, *headers])}.so")
        build_info[name] = compile_library([nvcc_path(), *NVCC_FLAGS, src], lib_path)
        lib = ctypes.CDLL(lib_path)
        _libs[name] = lib
        return lib


def build_all(names) -> None:
    """Build (or reuse) several libraries at once, one nvcc process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(load_library, names))
