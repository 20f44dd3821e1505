"""Tensor ops of the port; hand-written CUDA kernels are built by `cuda_build`."""
