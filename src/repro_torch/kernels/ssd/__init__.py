"""Mamba-2 SSD chunk scan: the Hopper kernel, its plain versions, ops."""
