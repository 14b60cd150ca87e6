"""The traced slice's reduction: busy time as the union of the device's
ops, idle time by the innermost span the host was in, kernels by name."""
import pytest
import torch

from benchmarks.harness import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._l = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._l


def test_summary():
    events = [Ev("bench:slice", CPU, 0, 1000), Ev("bench:chain", CPU, 0, 600), Ev("bench:decode", CPU, 600, 400),
              Ev("bench:chain", CUDA, 0, 600),  # a span's projection on the device: not an op
              Ev("gemm_kernel", CUDA, 100, 300), Ev("gemm_kernel", CUDA, 350, 150), Ev("attn_kernel", CUDA, 700, 100),
              Ev("aten::mm", CPU, 100, 10)]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert abs(s["busy_s"] - 500e-9) < 1e-15  # [100, 500) and [700, 800)
    assert s["kernels"]["gemm_kernel"]["count"] == 2 and s["kernels"]["gemm_kernel"]["s"] == pytest.approx(450e-9)
    assert abs(s["idle"]["chain"] - 100e-9) < 1e-15 and abs(s["idle"]["decode"] - 400e-9) < 1e-15
    assert trace.kernel_seconds(s, ("gemm", "attn")) == (pytest.approx(550e-9), 3)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "gemm_kernel" and b["idle_gaps"][0][0] == "decode"


def test_a_slice_on_the_cpu_records_spans():
    t = trace.Tracer()
    with t.span("outside"):
        pass
    t.start()
    with t.span("work"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    t.stop()
    assert t.summary["window_s"] > 0 and t.summary["busy_s"] == 0.0
    assert set(t.summary["idle"]) <= {"work", "other"}
