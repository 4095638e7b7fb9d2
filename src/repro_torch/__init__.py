"""PyTorch/CUDA port of the `repro` package for one NVIDIA H100.

The JAX package `repro` stays the reference; this package imports torch,
never jax, and nothing of `repro` (it keeps its own copy of the configs).
Entry points run on the card unless the caller passes a device; every
kernel op on a CUDA tensor (the pod GEMM in both weight layouts, flash
attention, the SSD chunk scan) runs its hand-written Hopper kernel
(kernels/*/csrc), and only CPU tensors take its plain version.
"""

from .runtime import HOST_SYNCS, TOLERANCES, resolve_device, to_host

__all__ = ["HOST_SYNCS", "TOLERANCES", "resolve_device", "to_host"]
