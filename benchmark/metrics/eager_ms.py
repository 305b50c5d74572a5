"""``eager_ms``: device milliseconds an iteration in PyTorch's own kernels
(kind ``eager`` in `kinds.py`: BatchNorm and the activation with their
backward, the chain's eager BatchNorm backward, DSP pointwise work, the
loss, the optimizer's foreach updates)."""


def read(ctx):
    if ctx.trace is None or ctx.iterations == 0:
        return None
    return 1e3 * ctx.trace.seconds_by_kind().get("eager", 0.0) / ctx.iterations
