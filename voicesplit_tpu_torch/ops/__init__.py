"""Operators: BatchNorm+activation (eval and train), the LSTM kernels, the
fused conv chain and its kernels, and the kernels' build (`_build`).

Importing this package registers the `torch.library` operators of the
forward kernels (``voicesplit::lstm_fwd``, ``voicesplit::bilstm_fwd``,
``voicesplit::conv_dilated_fwd``, ``voicesplit::conv_bn_act_eval``), which a
program saved by `export.py` calls; it imports no model code."""

from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda  # noqa: F401  (registers the operators)
