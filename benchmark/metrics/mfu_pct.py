"""``mfu_pct``: the whole step's (or call's) share of the card's bf16 peak.

The model's FLOPs of one iteration, counted from the configuration's
shapes (`costs.step_flops`), over the seconds an iteration took outside
the traced span (the profiler slows the host inside it) and the published
peak (989 TFLOP/s), in percent."""


def read(ctx):
    if not ctx.iter_s:
        return None
    return 100.0 * ctx.flops / (ctx.iter_s * ctx.peak_flops)
