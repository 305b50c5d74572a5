"""The readers and the trace arithmetic on a canned profiler trace."""

from __future__ import annotations

import types

import pytest

import harness
from devtrace import Trace, breakdown
from kinds import kind

# one span of 1000 µs; kernels of every kind, a copy, a kernel that matches
# no pattern, and host operations around the gaps
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench_window", "ts": 0.0, "dur": 1000.0},
    {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::conv_bn_act_fwd_kernel(int)",
     "ts": 100.0, "dur": 200.0},
    {"ph": "X", "cat": "kernel", "name": "lstm_fwd_kernel(float const*)", "ts": 250.0,
     "dur": 100.0},
    {"ph": "X", "cat": "kernel",
     "name": "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor>",
     "ts": 500.0, "dur": 100.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 700.0,
     "dur": 50.0},
    {"ph": "X", "cat": "kernel", "name": "nchwToNhwcKernel", "ts": 800.0, "dur": 50.0},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16bf16_bf16f32", "ts": 1200.0,
     "dur": 50.0},  # outside the span
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 650.0, "dur": 110.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 860.0,
     "dur": 140.0},
    {"ph": "i", "cat": "cpu_instant_event", "name": "ignored", "ts": 10.0},
]


def test_kinds():
    assert kind("(anonymous namespace)::conv_wgrad_kernel") == "conv"
    assert kind("(anonymous namespace)::reduce_rows_kernel(float const*)") == "conv"
    assert kind("sm90_xmma_fprop_implicit_gemm_bf16") == "conv"
    assert kind("lstm_dwhh_kernel") == "lstm"
    assert kind("void at::native::reduce_kernel<512, 1>") == "eager"
    assert kind("void at::native::(anonymous namespace)::multi_tensor_apply_kernel") == "eager"
    assert kind("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT") == "matmul"
    assert kind("Memset (Device)") == "copy"
    assert kind("nchwToNhwcKernel") == "other"


def test_trace_arithmetic():
    tr = Trace(EVENTS)
    assert tr.span_s == pytest.approx(1e-3)
    assert tr.busy_intervals() == [(100.0, 350.0), (500.0, 600.0), (700.0, 750.0),
                                   (800.0, 850.0)]
    assert tr.busy_s() == pytest.approx(450e-6)
    by = tr.seconds_by_kind()
    assert by == pytest.approx({"conv": 200e-6, "lstm": 100e-6, "eager": 100e-6,
                                "copy": 50e-6, "other": 50e-6})
    gaps = dict(tr.idle_gaps())
    # [0,100] and [350,500] and [750,800]: no host op; [600,700]: aten::copy_;
    # [850,1000]: the synchronize
    assert gaps == pytest.approx({"host (no operation)": 300e-6,
                                  "cudaStreamSynchronize": 150e-6, "aten::copy_": 100e-6})
    bd = breakdown(tr)
    assert bd["device_ops"][0][0].startswith("(anonymous namespace)::conv_bn_act_fwd")
    assert bd["idle_gaps"][0] == ["host (no operation)", pytest.approx(300e-6)]


def _ctx(**kw):
    base = dict(trace=Trace(EVENTS), iterations=4, iter_s=200e-6, flops=1e9,
                conv_bound_ms=0.01, lstm_bound_ms=0.002, peak_flops=989e12)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers():
    ctx = _ctx()
    # an iteration: 200 µs outside the traced span, 112.5 µs busy inside it
    assert harness._reader("mfu_pct.train")(ctx) == pytest.approx(100 * 1e9 / (200e-6 * 989e12))
    assert harness._reader("conv_roofline.train")(ctx) == pytest.approx(100 * 4e-5 / 200e-6)
    assert harness._reader("lstm_roofline.serve")(ctx) == pytest.approx(100 * 8e-6 / 100e-6)
    assert harness._reader("eager_ms.latency")(ctx) == pytest.approx(100e-6 * 1e3 / 4)
    assert harness._reader("device_idle_pct.train")(ctx) == pytest.approx(
        100 * (1 - 112.5 / 200))
    assert harness._reader("device_ms.serve")(ctx) == pytest.approx(450e-6 * 1e3 / 4)


def test_readers_find_nothing():
    """A reader with nothing to read returns nothing, never 0."""
    bare = [EVENTS[0], EVENTS[3]]
    ctx = _ctx(trace=Trace(bare))
    assert harness._reader("conv_roofline.train")(ctx) is None
    assert harness._reader("lstm_roofline.train")(ctx) is None
    assert harness._reader("mfu_pct.train")(_ctx(iter_s=None)) is None
    assert harness._reader("device_idle_pct.serve")(_ctx(iter_s=None)) is None


def test_one_span_required():
    with pytest.raises(ValueError):
        Trace(EVENTS[1:])


def test_window_times_iterations_outside_the_traced_span(monkeypatch):
    """The seconds an iteration takes are read outside the traced span, whose
    export and profiler overhead would count against the host."""
    import time

    import devtrace
    import torch  # noqa: F401  (imported before the window, as in a run)

    def slow_record(fn):
        fn()
        time.sleep(0.05)  # the export of the trace
        return "trace"

    monkeypatch.setattr(devtrace, "record", slow_record)
    n, window_s, tr, iter_s = harness._windowed(lambda i: time.sleep(0.002), 0.1, True, 3, 5,
                                                "cpu")
    assert tr == "trace" and n > 5
    assert window_s >= 0.1
    assert 0.002 <= iter_s < 0.002 + 0.05 / (n - 5)
    n, window_s, tr, iter_s = harness._windowed(lambda i: None, 0.01, False, 3, 5, "cpu")
    assert tr is None and iter_s == pytest.approx(window_s / n)
