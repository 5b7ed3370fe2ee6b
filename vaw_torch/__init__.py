"""PyTorch/CUDA port of vaw_tpu for NVIDIA Hopper (H100).

Imports torch and numpy only: never jax, flax or vaw_tpu.
"""
