"""Attention and its hand-written CUDA kernel."""
