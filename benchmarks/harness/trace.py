"""The traced run's slice: torch.profiler over a bounded part of the window,
reduced in memory to a small summary (no trace file).

Spans are the benchmark's own `record_function` ranges named "bench:<what
the host does>", around its calls into the program's layers. The summary:
the slice's length (from the first span's start to the last device op's
end), the device's busy time (the union of its ops' intervals), each device
op's count and seconds by name, and the device's idle time inside the slice
by the innermost span the host was in.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "bench:"
SLICE = "slice"


class Tracer:
    """Spans that cost nothing while no slice is being profiled."""

    def __init__(self):
        self.prof = None
        self.summary = None

    def span(self, name: str):
        return record_function(PREFIX + name) if self.prof is not None else contextlib.nullcontext()

    def start(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the slice holds its own work alone
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._slice = record_function(PREFIX + SLICE)
        self._slice.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._slice.__exit__(None, None, None)
        self.prof.stop()
        self.summary = summarize(self.prof.profiler.kineto_results.events())
        self.prof = None


def summarize(events) -> dict:
    spans, ops = [], []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name().startswith(PREFIX):  # a span (and its projection on the device's timeline)
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((e.name()[len(PREFIX):], start, end))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((e.name(), start, end))
    whole = [s for s in spans if s[0] == SLICE]
    lo = whole[0][1] if whole else min((s[1] for s in spans), default=0)
    hi = max([whole[0][2] if whole else lo] + [o[2] for o in ops])
    by_name: dict[str, list] = {}
    for name, s, e in ops:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) * 1e-9
    busy, gaps, cursor = 0.0, [], lo
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        busy += (e - max(s, cursor)) * 1e-9
        cursor = e
    if cursor < hi:
        gaps.append((cursor, hi))
    inner = [s for s in spans if s[0] != SLICE]
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        covering = [s for s in inner if s[1] <= mid < s[2]]
        label = max(covering, key=lambda s: s[1])[0] if covering else "other"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9
    return {"window_s": (hi - lo) * 1e-9, "busy_s": busy,
            "kernels": {k: {"count": v[0], "s": v[1]} for k, v in by_name.items()},
            "idle": idle}


def kernel_seconds(summary: dict, names) -> tuple[float, int]:
    """Seconds and count of the device ops whose name holds any of `names`."""
    s, n = 0.0, 0
    for key, rec in summary["kernels"].items():
        if any(part in key for part in names):
            s += rec["s"]
            n += rec["count"]
    return s, n


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["s"])[:top]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:120], v["s"]] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
