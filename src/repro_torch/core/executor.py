# Copy of src/repro/core/executor.py (the port imports nothing of repro).
"""Numerical executor: runs a SOSA schedule as real JAX matmuls.

This is the functional proof that the tiling + scheduling pipeline is
correct: executing the scheduled tile ops slice by slice — each op reading
its (i, j) X tile and (j, l) W tile, accumulating into its (i, l) psum
tile exactly when the scheduler says it runs — reproduces X @ W bit-for-bit
(int8 inputs, int32 accumulation like the hardware's wide psums).

`execute_schedule` is deliberately slice-ordered (not a single einsum): it
would produce wrong results if the scheduler ever violated a RAW chain, so
tests/test_executor.py doubles as a scheduler-correctness oracle.
"""

from __future__ import annotations

import numpy as np

from .arrays import ArrayConfig
from .scheduler import Schedule, SliceScheduler
from .tiling import GemmSpec, TileOpGraph, tile_workload


def execute_schedule(
    x: np.ndarray,
    w: np.ndarray,
    graph: TileOpGraph,
    schedule: Schedule,
    array: ArrayConfig,
    k_part: int | None = None,
) -> np.ndarray:
    """Execute the scheduled tile ops of a single GEMM; returns X @ W."""
    d1, d2 = x.shape
    d2b, d3 = w.shape
    assert d2 == d2b
    r, c = array.rows, array.cols
    kp = k_part if k_part is not None else r
    kp = max(1, min(kp, d1))

    acc = np.zeros((d1, d3), dtype=np.int32 if x.dtype == np.int8 else x.dtype)
    # bucket ops by slice and run slices in order
    by_slice: dict[int, list] = {}
    for op in graph.ops:
        sl, _pod = schedule.assignments[op.op_id]
        by_slice.setdefault(sl, []).append(op)
    for sl in sorted(by_slice):
        # within a slice, ops touch disjoint psum tiles (single-ported
        # banks + distinct (i, l)); order inside a slice is irrelevant.
        seen_psums = set()
        for op in by_slice[sl]:
            i0, j0, l0 = op.i * kp, op.j * r, op.l * c
            xt = x[i0:i0 + op.k, j0:j0 + op.r_eff]
            wt = w[j0:j0 + op.r_eff, l0:l0 + op.c_eff]
            key = (op.i, op.l)
            assert key not in seen_psums, "two ops hit one psum tile in a slice"
            seen_psums.add(key)
            acc[i0:i0 + op.k, l0:l0 + op.c_eff] += (
                xt.astype(np.int32) @ wt.astype(np.int32)
            ).astype(acc.dtype)
    return acc


def run_gemm_on_sosa(
    x: np.ndarray,
    w: np.ndarray,
    array: ArrayConfig | None = None,
    num_pods: int = 16,
    interconnect: str = "butterfly-2",
    k_part: int | None = None,
) -> tuple[np.ndarray, Schedule, TileOpGraph]:
    """Tile, schedule and numerically execute one GEMM end to end."""
    array = array or ArrayConfig()
    gemm = GemmSpec(d1=x.shape[0], d2=x.shape[1], d3=w.shape[1], gemm_id=0)
    graph = tile_workload([gemm], array, k_part=k_part, num_banks=num_pods)
    sched = SliceScheduler(
        num_pods=num_pods,
        array_rows=array.rows,
        pipeline_latency=array.pipeline_latency,
        interconnect=interconnect,
    ).schedule(graph)
    out = execute_schedule(x, w, graph, sched, array, k_part=k_part)
    return out, sched, graph
