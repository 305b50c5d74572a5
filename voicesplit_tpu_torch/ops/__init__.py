"""Operators: BatchNorm+activation (eval and train) and the LSTM kernels."""
