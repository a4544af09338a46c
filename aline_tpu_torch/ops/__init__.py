"""Attention, role masks and the hand-written CUDA kernels."""
