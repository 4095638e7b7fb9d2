"""Flash attention: the Hopper port of kernels/flash_attention (Pallas)."""
