"""CUDA graphs of step programs (the Sampler's chains, `calc_bpd_loop`,
the trainer's k-step calls): the warm-up before a capture, the capture
itself, with optional bodies under conditional IF nodes and the random
generators the program draws from, and the launch accounting of the
replays.

An IF node is made by `csrc/graph_cond.cu` (built by nvcc at first use,
like the kernels) through the CUDA runtime, as PyTorch's own
`CUDAGraph.begin_capture_to_if_node` does where a build has it (the H100
machine's PyTorch 2.11 has not): a captured one-thread kernel sets the
node's handle from the predicate, and the body is captured on a stream of
its own into the node's body graph. The body's allocations go to a private
memory pool of the `GraphedStep`, which keeps it while the graph lives.

A replay bypasses the kernel wrappers, so their `.launches` counters would
miss what it ran: a `GraphedStep` records, while it captures, what each of
its parts added to the counters, takes that back (the capture launched
nothing) and adds the unconditional part's counts at every replay. A
conditional body runs only where its predicate holds on the card, which
the host does not know at replay time: its owner adds its counts once it
knows how often it ran (`count_bodies`), so the counters still mean the
launches that ran on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import time
import weakref
from typing import Callable, Sequence

import torch

from osu_diffusion_tpu_torch.ops import adaln_mlp, banded_attention, cuda_build, quant


def launch_counters() -> list[tuple[object, str]]:
    """(wrapper, attribute) of every launch counter of the kernels: each
    wrapper's `.launches`, and the int8 out projection's `.o_casts`."""
    wrappers = banded_attention.WRAPPERS + adaln_mlp.WRAPPERS + quant.WRAPPERS
    return [(fn, "launches") for fn in wrappers] + [(quant.int8_out_residual, "o_casts")]


def warm_up(run: Callable[[], None], device: torch.device) -> None:
    """run() once on a side stream, the current stream waiting for it: the
    warm-up a capture needs (kernels built, their attributes set, lazy
    caches such as the bf16 weight copies filled)."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        run()
    current.wait_stream(side)


@functools.cache
def _cond_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("graph_cond")
    p = ctypes.c_void_p
    for name, argtypes in (("graph_stream_create", [ctypes.POINTER(p)]),
                           ("graph_if_begin", [p, p, p]), ("graph_if_end", [p])):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = argtypes
    lib.graph_cond_error_string.restype = ctypes.c_char_p
    lib.graph_cond_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: {_cond_lib().graph_cond_error_string(err).decode()}")


_body_streams: dict[int, list] = {}  # device index -> the body streams made so far


def _body_stream(device: torch.device, k: int) -> torch.cuda.ExternalStream:
    """The k-th body-capture stream of `device`: made once and kept for the
    process (a stream's cuBLAS workspace lives as long as the process)."""
    streams = _body_streams.setdefault(device.index, [])
    while len(streams) <= k:
        handle = ctypes.c_void_p()
        _check(_cond_lib().graph_stream_create(ctypes.byref(handle)), "creating a body stream")
        streams.append(torch.cuda.ExternalStream(handle.value, device=device))
    return streams[k]


@contextlib.contextmanager
def _no_collection():
    """No garbage collection inside the block: a capture's. A collection
    there may reset a dead graph held in a reference cycle (a Sampler and
    its chains form one), which invalidates the capture in progress."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _release(graph: torch.cuda.CUDAGraph, device_index: int, pools: list) -> None:
    """Drop the graph, then give back its bodies' pools."""
    graph.reset()
    for pool in pools:
        torch._C._cuda_releasePool(device_index, pool)


class GraphedStep:
    """`program`, then each of `bodies` ((pred, body): a 0-d bool tensor on
    the card and a callable) under a conditional IF node, captured as one
    CUDA graph: a replay runs a body only where its predicate holds when
    the node is reached. A capture error raises; nothing falls back.
    `replay` adds `program`'s counts to the launch counters; `count_bodies`
    adds each body's, times the number of replays that ran it.
    `generators`: the CUDA generators (besides the default one) that the
    program draws from, registered with the graph: each replay then draws
    the numbers that follow the last ones and moves the generator's offset
    on as an eager run would (an unregistered one cannot be drawn from
    under capture). `capture_ms` is the capture's host time, `pool_bytes`
    the device memory its private pool reserved."""

    def __init__(self, device: torch.device, program: Callable[[], None],
                 bodies: Sequence[tuple[torch.Tensor, Callable[[], None]]] = (),
                 generators: Sequence[torch.Generator] = ()):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        counters = launch_counters()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()  # as the capture does first: reserved is then what it keeps
        reserved = torch.cuda.memory_reserved(device)

        def read() -> list[int]:
            return [getattr(fn, name) for fn, name in counters]

        lib = _cond_lib() if bodies else None
        streams = [_body_stream(device, k) for k in range(len(bodies))]
        pools = [torch.cuda.graph_pool_handle() for _ in bodies]
        marks = [read()]
        start = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        if pools:
            weakref.finalize(self, _release, self.graph, device.index, pools).atexit = False
        with _no_collection(), torch.cuda.graph(self.graph):
            program()
            marks.append(read())
            capturing = torch.cuda.current_stream(device).cuda_stream
            for (pred, body), stream, pool in zip(bodies, streams, pools):
                _check(lib.graph_if_begin(capturing, stream.cuda_stream, pred.data_ptr()),
                       "adding an IF node to the graph under capture")
                try:
                    with torch.cuda.stream(stream):
                        torch._C._cuda_beginAllocateCurrentStreamToPool(device.index, pool)
                        try:
                            body()
                        finally:
                            torch._C._cuda_endAllocateToPool(device.index, pool)
                finally:
                    _check(lib.graph_if_end(stream.cuda_stream), "ending an IF body's capture")
                marks.append(read())
        self.capture_ms = (time.perf_counter() - start) * 1000
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        parts = [[(fn, name, b - a) for (fn, name), a, b in zip(counters, before, after) if b != a]
                 for before, after in zip(marks, marks[1:])]
        self.counts, self.body_counts = parts[0], parts[1:]
        for (fn, name), n in zip(counters, marks[0]):
            setattr(fn, name, n)  # the capture launched nothing

    def replay(self) -> None:
        self.graph.replay()
        for fn, name, n in self.counts:
            setattr(fn, name, getattr(fn, name) + n)

    def count_bodies(self, runs: Sequence[int]) -> None:
        """Add each body's captured counts `runs[b]` times."""
        for counts, times in zip(self.body_counts, runs):
            for fn, name, n in counts:
                setattr(fn, name, getattr(fn, name) + times * n)
