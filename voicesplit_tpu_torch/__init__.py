"""PyTorch/CUDA port of voicesplit_tpu for NVIDIA Hopper (H100).

The JAX package `voicesplit_tpu` stays the reference; this package imports
nothing of it, nor JAX.  Ported so far: the serving path (spectrogram →
eval-mode mask network → mixed-phase iSTFT); the training step (`train/`:
train-mode mask network, losses, Adam, dropout and SpecAugment) and the
training entry point around it (`cli/train.py`, `train/trainer.py`,
`train/checkpoint.py`, `data/` with the native C++ loader and online
mixing, `eval/`, `utils/logging.py`); offline preprocessing
(`cli/preprocess.py`); evaluation (`cli/test.py`, `cli/sweep.py`);
streaming separation (`streaming.py`: causal convs, the forward-only
`UniLSTM` with its carry, streaming training and `cli/convert_streaming.py`)
and the rest of the DSP (Griffin-Lim, the wavernn and waveglow backends,
loudness); data-parallel training and sequence-parallel long-form
separation (`parallel/`); `torch.export` programs of the separator and the
streaming chunk step (`export.py`, `cli/export.py`), which call the serving
kernels as `torch.library` operators; profiling (`utils/profiling.py`).  Every kernel that the JAX package wrote in
Pallas has a hand-written CUDA counterpart: the BiLSTM recurrence and its
backward (`ops/lstm_cuda.py`, `csrc/lstm_fwd.cu`, `csrc/lstm_bwd.cu`), the
training step's fused conv chain (``VOICESPLIT_FUSED_CHAIN=1``) with its
forward, data-gradient and weight-gradient kernels (`ops/conv_fused.py`,
`csrc/conv_fwd.cu`, `csrc/conv_wgrad.cu`), and the
opt-in dilated conv (``VOICESPLIT_PALLAS_CONV=1``) with its forward /
data-gradient and weight-gradient kernels (`ops/conv_cuda.py`, the same
`csrc/conv_fwd.cu` and `csrc/conv_wgrad.cu`).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead.
"""

from voicesplit_tpu_torch.config import Config, load_config, load_config_from_str
from voicesplit_tpu_torch.device import resolve_device

__all__ = ["Config", "load_config", "load_config_from_str", "resolve_device"]
