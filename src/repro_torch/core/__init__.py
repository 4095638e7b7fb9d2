# Copy of src/repro/core/__init__.py (the port imports nothing of repro).
"""SOSA core: the paper's contribution (tiling, interconnect, scheduling,
granularity DSE) as a composable library. See DESIGN.md §1/§3."""

from .arrays import (AcceleratorConfig, ArrayConfig, max_pods_under_tdp,
                     monolithic, sosa)
from .interconnect import (ButterflyRouter, IcnSpec, benes_spec,
                           butterfly_spec, crossbar_spec, htree_spec,
                           make_router, mesh_spec, routed_fraction)
from .scheduler import Schedule, SliceScheduler
from .simulator import (BatchedAnalysis, DesignVector, PackedWorkloads,
                        SimResult, analyze, analyze_batch, analyze_scalar,
                        icn_efficiency, merge_workloads, pack_workloads,
                        simulate, sram_spill_bytes)
from .tiling import (GemmSpec, TileOp, TileOpGraph, TileStats, gemm_levels,
                     tile_counts, tile_gemm, tile_stats, tile_workload)

__all__ = [
    "AcceleratorConfig", "ArrayConfig", "max_pods_under_tdp", "monolithic",
    "sosa", "ButterflyRouter", "IcnSpec", "benes_spec", "butterfly_spec",
    "crossbar_spec", "htree_spec", "make_router", "mesh_spec",
    "routed_fraction", "Schedule",
    "SliceScheduler", "SimResult", "analyze", "analyze_scalar",
    "analyze_batch", "BatchedAnalysis", "DesignVector", "PackedWorkloads",
    "icn_efficiency", "pack_workloads", "merge_workloads", "simulate",
    "sram_spill_bytes",
    "GemmSpec", "TileOp", "TileOpGraph", "TileStats", "gemm_levels",
    "tile_counts", "tile_gemm", "tile_stats", "tile_workload",
]
