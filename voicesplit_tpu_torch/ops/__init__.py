"""Operators: BatchNorm+activation (eval and train), the LSTM kernels, the
fused conv chain and its kernels, and the kernels' build (`_build`)."""
