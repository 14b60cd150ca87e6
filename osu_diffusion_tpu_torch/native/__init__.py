"""ctypes binding of the native featurizer (csrc/osu_native.cpp).

The library parses a .osu file and expands its hit objects straight to the
(T, 19) float32 rows of data/featurize.py's `beatmap_to_sequence` (within
2e-3: it computes the curves in double precision), without Python objects.
It is loaded with `ctypes.CDLL`, which releases the GIL during each call, so
the loader's threads featurize in parallel.

`load_library` builds it at first use (native/build.py). With no g++ on
PATH it logs one warning and returns None, and `available()` is False; a
failed build raises.
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

from osu_diffusion_tpu_torch import FEATURE_SIZE

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_no_compiler = False
# build.build's result for the loaded library: path, seconds, log, compiler
build_info: dict = {}

_FLOAT_PP = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))


def load_library() -> ctypes.CDLL | None:
    """The library, built and loaded once per process; None without g++."""
    global _lib, _no_compiler
    from osu_diffusion_tpu_torch.native import build

    with _lock:
        if _lib is None and not _no_compiler:
            gxx = build.compiler()
            if gxx is None:
                _no_compiler = True
                logging.getLogger(__name__).warning(
                    "no g++ on PATH: the native featurizer is not built, the Python featurizer runs")
                return None
            info = build.build(gxx)
            lib = ctypes.CDLL(info["path"])
            lib.osu_featurize_file.restype = ctypes.c_int
            lib.osu_featurize_file.argtypes = [ctypes.c_char_p, _FLOAT_PP, ctypes.POINTER(ctypes.c_int)]
            lib.osu_featurize_buffer.restype = ctypes.c_int
            lib.osu_featurize_buffer.argtypes = [ctypes.c_char_p, ctypes.c_long, _FLOAT_PP,
                                                 ctypes.POINTER(ctypes.c_int)]
            lib.osu_free.restype = None
            lib.osu_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            build_info.update(info)
            _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _featurize(call, *args) -> np.ndarray:
    lib = load_library()
    if lib is None:
        raise RuntimeError("the native featurizer is not built: no g++ on PATH")
    data = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_int(0)
    status = getattr(lib, call)(*args, ctypes.byref(data), ctypes.byref(rows))
    if status != 0:
        raise RuntimeError(f"osu_native featurize failed with status {status}")
    try:  # copied out of the C buffer, which is then freed
        if rows.value == 0:
            return np.zeros((0, FEATURE_SIZE), dtype=np.float32)
        return np.ctypeslib.as_array(data, shape=(rows.value, FEATURE_SIZE)).copy()
    finally:
        lib.osu_free(data)


def featurize_file(path: str) -> np.ndarray:
    """(T, 19) float32 rows of a .osu file."""
    return _featurize("osu_featurize_file", os.fsencode(path))


def featurize_text(text: str) -> np.ndarray:
    """(T, 19) float32 rows of a .osu file's text."""
    raw = text.encode("utf-8")
    return _featurize("osu_featurize_buffer", raw, len(raw))
