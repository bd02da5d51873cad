"""Hopper kernels (K1 banded fused scan, K2 Poisson samplers), their plain
PyTorch versions, and the torch.fft convolution helpers."""
