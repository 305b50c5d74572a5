"""``device_ms``: device milliseconds an iteration, the union of the
device operations' intervals in the traced span over the iterations it
holds.  It moves with the work the card does and not with the host, so it
stands beside a host-paced end-to-end metric as its steady part."""


def read(ctx):
    if ctx.trace is None or ctx.iterations == 0:
        return None
    return 1e3 * ctx.trace.busy_s() / ctx.iterations
