"""``device_idle_pct``: 100 · (1 − device busy time an iteration / the
seconds an iteration took outside the traced span).  The busy time is the
union of the device operations' intervals in the traced span over the
iterations it holds; the time an iteration takes is read where the
profiler does not slow the host."""


def read(ctx):
    if ctx.trace is None or ctx.iterations == 0 or not ctx.iter_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.iterations / ctx.iter_s)
