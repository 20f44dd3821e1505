"""PyTorch/CUDA port of tdgp: serves the 3DGP generator and trains it on an NVIDIA H100.

Mirrors the module names of `tdgp/`. Imports nothing of JAX or of `tdgp`.
"""
