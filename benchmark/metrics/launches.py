"""``launches``: kernel and graph launches an iteration, the runtime and
driver launch calls (`spans.is_launch`: ``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel``, ``cuLaunchKernelEx``,
``cudaGraphLaunch``) that start inside a top span.  The program's own
kernels, launched through ctypes, count with PyTorch's."""

from bisect import bisect_left, bisect_right

from spans import is_launch, top_spans


def read(ctx):
    tops = top_spans(ctx)
    if tops is None:
        return None
    starts = sorted(a for name, a, _ in ctx.trace.host if is_launch(name))
    n = sum(bisect_right(starts, b) - bisect_left(starts, a) for a, b in tops)
    return n / len(tops)
