"""The span readers (`spans.py`, ``metrics/{host_ms,launches,idle_*}.py``)
on a canned profiler trace of two serving calls."""

from __future__ import annotations

import types

import pytest

import harness
import spans
from devtrace import Trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur)}


def _call(t0):
    """One serving call's spans from `t0` on, as the program nests them."""
    return [_x("user_annotation", "voicesplit.separate_batch", t0 + 10, 890),
            _x("user_annotation", "voicesplit.wav2spec", t0 + 20, 180),
            _x("user_annotation", "voicesplit.convs", t0 + 200, 300),
            _x("user_annotation", "voicesplit.head", t0 + 500, 300),
            _x("user_annotation", "voicesplit.lstm", t0 + 550, 150),
            _x("user_annotation", "voicesplit.spec2wav", t0 + 800, 90)]


# a span of 2000 µs holding two calls; the card busy [100, 300] (across the
# DSP front and the convs), [400, 600] (across the convs and the head),
# [850, 860] in the DSP back, and the same 1000 µs later
KERNELS = [_x("kernel", "conv_dilated_fwd_kernel", t, d)
           for t, d in ((100, 200), (400, 200), (850, 10), (1100, 200), (1400, 200),
                        (1850, 10))]
LAUNCHES = [_x("cuda_runtime", "cudaLaunchKernel", 150, 5),
            _x("cuda_driver", "cuLaunchKernelEx", 520, 5),
            _x("cuda_runtime", "cudaMemcpyAsync", 880, 5),      # not a launch
            _x("cuda_runtime", "cudaLaunchKernel", 950, 5),     # between the calls
            _x("cuda_runtime", "cudaLaunchKernelExC", 1250, 5),
            _x("cuda_runtime", "cudaGraphLaunch", 1600, 5)]
WINDOW = [_x("user_annotation", "bench_window", 0, 2000)]
EVENTS = WINDOW + _call(0) + _call(1000) + KERNELS + LAUNCHES
NAMES = ("host_ms", "launches", "idle_dsp_ms", "idle_conv_ms", "idle_head_ms")


def _ctx(events=EVENTS, iterations=2):
    return types.SimpleNamespace(trace=Trace(events), iterations=iterations, iter_s=1e-3)


def _read(name, ctx, tag="latency"):
    return harness._reader(f"{name}.{tag}")(ctx)


def test_readers_on_two_calls():
    ctx = _ctx()
    assert _read("host_ms", ctx) == pytest.approx(0.89)
    assert _read("launches", ctx) == 2.0
    # idle [0,100] [300,400] [600,850] [860,1100] [1300,1400] [1600,1850] [1860,2000]
    # DSP: [20,100] + [800,850] + [860,890], twice; convs [300,400] twice;
    # head [600,800] twice
    assert _read("idle_dsp_ms", ctx, "serve") == pytest.approx(0.16)
    assert _read("idle_conv_ms", ctx, "serve") == pytest.approx(0.10)
    assert _read("idle_head_ms", ctx, "serve") == pytest.approx(0.20)


def test_layers_idle_no_more_than_the_card():
    ctx = _ctx()
    idle_per_call = 1e-3 * sum(b - a for a, b in spans.idle(ctx.trace)) / 2
    assert idle_per_call == pytest.approx(0.59)
    layers = sum(_read(n, ctx) for n in ("idle_dsp_ms", "idle_conv_ms", "idle_head_ms"))
    assert layers <= idle_per_call
    assert _read("host_ms", ctx) >= layers


def test_gap_across_two_layers_is_split_by_overlap():
    """The gap [600, 850] straddles the head and the DSP back: 200 µs go to
    the head and 50 to the DSP, not all 250 to the span at its midpoint."""
    gap = [(600.0, 850.0)]
    assert spans.overlap(gap, [(500.0, 800.0)]) == 200.0
    assert spans.overlap(gap, [(800.0, 890.0)]) == 50.0
    # nested or repeated spans count once
    assert spans.overlap(gap, [(500.0, 800.0), (550.0, 700.0)]) == 200.0
    assert spans.overlap([(0.0, 10.0), (20.0, 30.0)], [(5.0, 25.0)]) == 10.0
    assert spans.union([(5.0, 7.0), (0.0, 6.0), (8.0, 9.0)]) == [(0.0, 7.0), (8.0, 9.0)]


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_without_the_programs_spans(name):
    """A program without spans (the parent of the spans, say) reads
    nothing, never 0."""
    bare = WINDOW + KERNELS + LAUNCHES
    assert _read(name, _ctx(bare)) is None
    assert _read(name, types.SimpleNamespace(trace=None, iterations=2, iter_s=1e-3)) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_when_the_top_spans_miss_an_iteration(name):
    assert _read(name, _ctx(iterations=3)) is None
    one_call = WINDOW + _call(0) + [e for e in EVENTS[13:] if e["ts"] < 1000]
    assert _read(name, _ctx(one_call, iterations=2)) is None
    assert _read(name, _ctx(one_call, iterations=1)) is not None


def test_train_step_is_the_top_span_without_a_serving_call():
    steps = [_x("user_annotation", "voicesplit.train_step", 0, 900),
             _x("user_annotation", "voicesplit.wav2spec", 50, 50),
             _x("user_annotation", "voicesplit.train_step", 1000, 700),
             _x("user_annotation", "voicesplit.wav2spec", 1050, 50)]
    ctx = _ctx(WINDOW + steps + KERNELS + LAUNCHES)
    assert spans.top_spans(ctx) == [(0.0, 900.0), (1000.0, 1700.0)]
    assert _read("host_ms", ctx, "train") == pytest.approx(0.8)
    assert _read("launches", ctx, "train") == 2.0
    # [50, 100] and [1050, 1100] are idle
    assert _read("idle_dsp_ms", ctx, "train") == pytest.approx(0.05)


def test_spans_outside_the_window_do_not_count():
    late = _call(2500)  # after the traced span's end
    assert spans.top_spans(_ctx(EVENTS + late)) == [(10.0, 900.0), (1010.0, 1900.0)]


def test_launch_names():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaLaunchCooperativeKernel"):
        assert spans.is_launch(name), name
    for name in ("cudaMemcpyAsync", "cudaStreamSynchronize", "aten::copy_",
                 "voicesplit.separate_batch", "bench_window"):
        assert not spans.is_launch(name), name


def test_program_spans_label_the_idle_gaps():
    """The breakdown's idle gaps carry the innermost program span where no
    operator runs."""
    gaps = dict(Trace(EVENTS).idle_gaps())
    assert gaps["host (no operation)"] == pytest.approx(380e-6)  # [860, 1100], [1860, 2000]
    assert gaps["voicesplit.head"] == pytest.approx(500e-6)  # [600, 850] twice
    assert gaps["voicesplit.convs"] == pytest.approx(200e-6)
