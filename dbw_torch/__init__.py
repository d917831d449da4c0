"""Differentiable Blocks World in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper. A port of the JAX package ``dbw_tpu``; it imports no JAX."""
