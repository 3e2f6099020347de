"""PyTorch/CUDA port of the FlashAttention-2 reproduction (see README).

Mirrors the JAX package ``repro`` module by module and never imports it.
"""
