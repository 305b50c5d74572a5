"""The device trace of a traced span, and what the per-layer readers take
from it.

`record` runs a function under `torch.profiler` (CPU and CUDA activity),
with the span marked by a ``bench_window`` annotation, exports the Chrome
trace into the run's ``TMPDIR``, reads it back and deletes it.  `Trace`
holds the span, the device operations (kernels, copies, memsets) inside it
and the host operations, all on the profiler's one clock in microseconds.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

from kinds import kind

SPAN = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    """`events`: Chrome trace events (``ph`` "X" with ``cat``, ``name``,
    ``ts``, ``dur``).  The span is the ``bench_window`` annotation; device
    operations are clipped to it."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == SPAN]
        if len(spans) != 1:
            raise ValueError(f"expected one {SPAN} annotation, found {len(spans)}")
        s = spans[0]
        self.start, self.end = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                a, b = max(a, self.start), min(b, self.end)
                if b > a:
                    self.device.append((e["name"], a, b))
            elif e.get("cat") in HOST_CATS and e["name"] != SPAN:
                self.host.append((e["name"], a, b))
        self.device.sort(key=lambda d: d[1])

    @property
    def span_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals."""
        out: List[List[float]] = []
        for _, a, b in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def seconds_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.device:
            k = kind(name)
            out[k] = out.get(k, 0.0) + (b - a) / 1e6
        return out

    def seconds_by_name(self, of_kind: Optional[str] = None) -> List[Tuple[str, float]]:
        out: Dict[str, float] = {}
        for name, a, b in self.device:
            if of_kind is None or kind(name) == of_kind:
                out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return sorted(out.items(), key=lambda kv: -kv[1])

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Seconds of device idleness inside the span by what the host was
        doing: each gap between busy intervals (and at the span's ends) goes
        to the host operation that started last among those running at its
        midpoint (the innermost, where operations nest), or to ``host (no
        operation)``."""
        edges = [self.start]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end)
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        host = sorted(self.host, key=lambda h: h[1])
        out: Dict[str, float] = {}
        active: List[Tuple[str, float, float]] = []
        i = 0
        for a, b in gaps:  # in time order, so each operation is pushed and popped once
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            while active and active[-1][2] < mid:
                active.pop()
            label = active[-1][0] if active else "host (no operation)"
            out[label] = out.get(label, 0.0) + (b - a) / 1e6
        return sorted(out.items(), key=lambda kv: -kv[1])


def short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time and the ten host
    operations behind the most idle time, in seconds as measured."""
    return {
        "device_ops": [[short(n), s] for n, s in trace.seconds_by_name()[:10]],
        "idle_gaps": [[short(n), s] for n, s in trace.idle_gaps()[:10]],
    }


def record(fn: Callable[[], None]) -> Trace:
    """Run `fn` under the profiler inside a ``bench_window`` span and return
    its trace.  The caller synchronizes the card inside `fn`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)
