"""``conv_roofline``: the conv kernels' share of their roofline.

Σ of `costs.conv_bound` over every conv of an iteration (forward; in
training also data and weight gradient), times the iterations, over the
device time of every kernel of kind ``conv`` (`kinds.py`: the port's conv
kernels and passes, and the library's convs), in percent.  Nothing to read
where no conv kernel ran."""


def read(ctx):
    conv_s = ctx.trace.seconds_by_kind().get("conv", 0.0) if ctx.trace is not None else 0.0
    if conv_s <= 0.0:
        return None
    return 100.0 * ctx.conv_bound_ms * 1e-3 * ctx.iterations / conv_s
