"""The pod GEMM: Hopper kernel (csrc/), its wrapper, plain version and ops."""
