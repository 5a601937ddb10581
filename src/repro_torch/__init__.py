"""PyTorch/CUDA port of the JAX package ``repro``.

It mirrors the JAX layout (configs, core, sharding, models, kernels,
launch), imports torch and numpy and nothing of ``repro`` or jax, and runs
on a CUDA card unless a caller asks for the CPU.
"""
