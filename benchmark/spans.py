"""The program's spans in a traced span, and the interval arithmetic that
the span readers share.

The program marks its layer boundaries with ``voicesplit.<layer>`` ranges
(`voicesplit_tpu_torch/utils/profiling.py::span`), which the profiler
writes as ``user_annotation`` events on the clock of the device trace;
`devtrace.Trace` keeps them among its host operations.  An iteration's top
span is ``voicesplit.separate_batch`` for a serving call, else
``voicesplit.train_step`` for a train step.  A program without spans, or a
trace whose top spans do not number the iterations, gives nothing to read:
the readers return None then, never 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

TOPS = ("voicesplit.separate_batch", "voicesplit.train_step")

Interval = Tuple[float, float]


def named(trace, names: Sequence[str]) -> List[Interval]:
    """The intervals of the host events called one of `names` that lie in
    the traced span, in time order."""
    return sorted((a, b) for n, a, b in trace.host
                  if n in names and a >= trace.start and b <= trace.end)


def top_spans(ctx) -> Optional[List[Interval]]:
    """Each iteration's top span, or None unless there is one an
    iteration."""
    if ctx.trace is None or ctx.iterations == 0:
        return None
    for name in TOPS:
        tops = named(ctx.trace, (name,))
        if tops:
            return tops if len(tops) == ctx.iterations else None
    return None


def union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """The length of the intersection of two unions of intervals."""
    xs, ys = union(xs), union(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> List[Interval]:
    """The card's idle intervals in the traced span: the gaps between its
    busy intervals and at the span's two ends."""
    edges = [trace.start]
    for a, b in trace.busy_intervals():
        edges += [a, b]
    edges.append(trace.end)
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def is_launch(name: str) -> bool:
    """A runtime or driver call that launches a kernel or a graph
    (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaGraphLaunch``, ...)."""
    return name.startswith("cu") and "Launch" in name


def idle_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Milliseconds an iteration that the card sat idle while the host was
    inside one of the spans `names`: the length of the idle intervals'
    intersection with those spans, not a gap's midpoint."""
    if top_spans(ctx) is None:
        return None
    return 1e-3 * overlap(idle(ctx.trace), named(ctx.trace, names)) / ctx.iterations
