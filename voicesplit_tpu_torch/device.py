"""Device resolution and float32 precision settings.

Every entry point of the port runs on the CUDA card unless the caller
asks for the CPU by name.  With no card and no explicit ``device="cpu"``
it raises instead of carrying on quietly on the CPU, where only the
kernels' plain versions exist.

cuDNN convolutions default to TF32 (about three decimal digits), which
would make float32 parity with the JAX reference impossible, so both TF32
switches are turned off whenever a device is resolved.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def set_fp32_precision() -> None:
    """Full float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for by name."""
    set_fp32_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev
