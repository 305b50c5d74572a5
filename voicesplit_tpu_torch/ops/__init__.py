"""Serving-path operators: eval BatchNorm+activation and the LSTM kernels."""
