"""PyTorch/CUDA port of the `repro` package for one NVIDIA H100.

The JAX package `repro` stays the reference; this package imports torch,
never jax, and nothing of `repro` (it keeps its own copy of the configs).
Entry points run on the card unless the caller passes a device; every
pod GEMM on a CUDA tensor runs the hand-written Hopper kernel
(kernels/systolic_gemm/csrc), and only CPU tensors take its plain version.
"""

from .runtime import HOST_SYNCS, TOLERANCES, resolve_device, to_host

__all__ = ["HOST_SYNCS", "TOLERANCES", "resolve_device", "to_host"]
