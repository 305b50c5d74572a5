"""Device operations by kind, from their names.

`chip_smoke.py::PORT_KERNEL_KINDS` lists the port's kernels by their whole
names, a list that goes stale when a kernel is renamed.  This copy of its
idea classifies by fragments of the name instead, so that a renamed or new
kernel of a layer still lands in that layer, and the library's kernels
that do the same work (cuDNN's convs) land there too.  Tried in order,
case-insensitive; a name that matches none is ``other``, which the
harness prints.
"""

from __future__ import annotations

from functools import lru_cache

KINDS = (
    # the LSTM walks and their backward, dW_hh included
    ("lstm", ("lstm",)),
    # PyTorch's own kernels: elementwise, reductions, the foreach optimizer,
    # col2im (the iSTFT's overlap-add), reflect padding
    ("eager", ("at::native", "at_cuda_detail", "cub::", "elementwise", "multi_tensor_apply")),
    # every conv kernel: the port's forward, data- and weight-gradient
    # kernels with their prologue passes and reduction helpers, and the
    # library's convs
    ("conv", ("conv", "wgrad", "dgrad", "fprop", "prologue", "reduce_rows", "reduce_taps",
              "reduce_segments")),
    ("matmul", ("gemm", "gemv", "cutlass", "nvjet", "splitk", "xmma")),
    ("copy", ("memcpy", "memset")),
)


@lru_cache(maxsize=4096)
def kind(name: str) -> str:
    low = name.lower()
    for k, fragments in KINDS:
        if any(f in low for f in fragments):
            return k
    return "other"
