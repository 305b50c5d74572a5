"""``host_ms``: the host's milliseconds to enqueue one iteration, the mean
duration of the program's top spans (``voicesplit.separate_batch`` a
serving call, ``voicesplit.train_step`` a train step; `spans.py`) in the
traced span, where the profiler's own overhead is included.  Nothing to
read without one top span an iteration."""

from spans import top_spans


def read(ctx):
    tops = top_spans(ctx)
    if tops is None:
        return None
    return 1e-3 * sum(b - a for a, b in tops) / len(tops)
