"""PyTorch/CUDA port of the serving data plane (see README.md).

Imports torch and never jax, and nothing of the JAX package `repro`."""
