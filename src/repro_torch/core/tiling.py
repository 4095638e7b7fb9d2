# Copy of src/repro/core/tiling.py (the port imports nothing of repro).
"""SOSA data tiling (§3.3): GEMM -> tile-operation DAG.

A GEMM  X (d1 x d2) @ W (d2 x d3) (+ P_in)  on weight-stationary r x c pods
is partitioned as:

  * W into (r x c) tiles  — forced by the spatial layout,
  * X's second dim into r — forced by the contraction,
  * X's first dim into chunks of `k_part` — the paper's free parameter.

The paper's contribution is k_part = r: the smallest partition that does not
expose the r-cycle weight-buffering time (double buffering), maximizing the
number of *independent* tile ops:  n_parallel = ceil(d1/r) * ceil(d3/c).
Tiles along d2 (the contraction) form read-after-write chains through the
partial-sum input (or pairwise aggregation on post-processors, §4.2).

`tile_gemm` returns a TileOpGraph whose ops carry everything the scheduler
(core/scheduler.py), the simulator (core/simulator.py) and the numerical
executor (core/executor.py) need.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Iterator

import numpy as np

from .arrays import ArrayConfig


@dataclasses.dataclass(frozen=True)
class TileOp:
    """One (k x r') @ (r' x c') multiply-accumulate tile operation."""

    op_id: int
    gemm_id: int
    # tile indices within the GEMM: X row-chunk i, contraction chunk j,
    # W column-chunk l (paper Fig 8: x_ij @ w_jl (+ y_i,j-1,l) -> y_ijl).
    i: int
    j: int
    l: int
    # effective (edge-clipped) tile dims
    k: int       # rows of the X chunk streamed through the array
    r_eff: int   # contraction size  (<= array rows)
    c_eff: int   # output columns    (<= array cols)
    depends_on: tuple[int, ...] = ()   # op_ids (RAW: psum chain, inter-GEMM)
    # memory placement (bank ids are assigned by the tiler round-robin —
    # the paper stores X/W/P tiles in dedicated bank groups, Fig 7)
    x_bank: int = 0
    w_bank: int = 0
    p_bank: int = 0
    is_aggregation: bool = False  # post-processor pair-aggregation op

    @property
    def macs(self) -> int:
        return self.k * self.r_eff * self.c_eff


@dataclasses.dataclass
class GemmSpec:
    """A GEMM extracted from a DNN layer (after conv-to-GEMM conversion)."""

    d1: int                     # filter reuse   (X rows)
    d2: int                     # features       (contraction)
    d3: int                     # filters        (W cols)
    gemm_id: int = 0
    depends_on: tuple[int, ...] = ()   # gemm_ids of producer layers
    name: str = ""

    @property
    def macs(self) -> int:
        return self.d1 * self.d2 * self.d3


@dataclasses.dataclass
class TileOpGraph:
    ops: list[TileOp]
    num_banks: int
    # per-GEMM output tile ids: (gemm_id, i, l) -> op_id producing the final
    # accumulated output tile (end of the psum chain)
    final_tiles: dict[tuple[int, int, int], int]

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def total_macs(self) -> int:
        return sum(op.macs for op in self.ops)

    def parallel_frontier(self) -> int:
        """Number of ops with no intra-graph dependencies (available at t=0)."""
        return sum(1 for op in self.ops if not op.depends_on)


def _chunks(total: int, size: int) -> list[int]:
    """Chunk sizes covering `total` in steps of `size` (last may be short)."""
    if total <= 0:
        return []
    n = math.ceil(total / size)
    out = [size] * n
    out[-1] = total - size * (n - 1)
    return out


def tile_gemm(
    gemm: GemmSpec,
    array: ArrayConfig,
    k_part: int | None = None,
    num_banks: int = 256,
    start_op_id: int = 0,
    producer_final: dict[tuple[int, int, int], int] | None = None,
    producer_gemms: tuple[int, ...] = (),
    producer_all_ops: tuple[int, ...] = (),
    faulty_banks: tuple[int, ...] = (),
) -> TileOpGraph:
    """Tile one GEMM into TileOps (k_part=None -> the paper's r x r rule).

    producer_all_ops: op_ids this GEMM's first-wave tiles must wait for
    (coarse inter-layer dependency — the paper schedules layer by layer with
    RAW dependencies between them).

    faulty_banks: bank ids masked out of the round-robin placement (a dead
    pod takes its local SRAM bank group with it — degraded-pod retiling
    spreads tiles over the survivors). Empty mask reproduces the seed
    placement bit-for-bit.
    """
    r, c = array.rows, array.cols
    if k_part is None:
        k_part = r                       # the paper's optimal partition
    k_part = max(1, min(k_part, gemm.d1))

    k_chunks = _chunks(gemm.d1, k_part)
    r_chunks = _chunks(gemm.d2, r)
    c_chunks = _chunks(gemm.d3, c)

    ops: list[TileOp] = []
    final: dict[tuple[int, int, int], int] = {}
    oid = start_op_id

    # Bank placement: X tiles keyed by (i, j), W by (j, l), P by (i, l);
    # spread round-robin over the HEALTHY banks (single-ported, one reader
    # per slice). With no faulty banks, `banks[e % num_banks] == e %
    # num_banks` — identical to the seed placement.
    dead = set(faulty_banks)
    if any(b < 0 or b >= num_banks for b in dead):
        raise ValueError(f"faulty_banks {sorted(dead)} out of range "
                         f"for {num_banks} banks")
    banks = [b for b in range(num_banks) if b not in dead]
    if not banks:
        raise ValueError("all banks faulty: nothing to tile onto")

    def xb(i: int, j: int) -> int:
        return banks[(i * len(r_chunks) + j) % len(banks)]

    def wb(j: int, l: int) -> int:
        return banks[(gemm.gemm_id * 7 + j * len(c_chunks) + l) % len(banks)]

    def pb(i: int, l: int) -> int:
        return banks[(gemm.gemm_id * 13 + i * len(c_chunks) + l) % len(banks)]

    for i, k in enumerate(k_chunks):
        for l, c_eff in enumerate(c_chunks):
            prev: int | None = None
            for j, r_eff in enumerate(r_chunks):
                deps: list[int] = []
                if prev is not None:
                    deps.append(prev)          # psum chain along contraction
                if j == 0 and producer_all_ops:
                    deps.extend(producer_all_ops)
                ops.append(
                    TileOp(
                        op_id=oid, gemm_id=gemm.gemm_id,
                        i=i, j=j, l=l, k=k, r_eff=r_eff, c_eff=c_eff,
                        depends_on=tuple(deps),
                        x_bank=xb(i, j), w_bank=wb(j, l), p_bank=pb(i, l),
                    )
                )
                prev = oid
                oid += 1
            final[(gemm.gemm_id, i, l)] = prev  # last op in the chain
    return TileOpGraph(ops=ops, num_banks=num_banks, final_tiles=final)


def tile_workload(
    gemms: list[GemmSpec],
    array: ArrayConfig,
    k_part: int | None = None,
    num_banks: int = 256,
    layer_dependencies: bool = True,
    faulty_banks: tuple[int, ...] = (),
) -> TileOpGraph:
    """Tile a whole workload (list of GEMM layers, in execution order).

    When `layer_dependencies` is True, a layer's tiles depend on *all* tiles
    of the layers named in its `depends_on` (coarse RAW through activations;
    matches the paper's layer-by-layer scheduling). Tiles of layers with no
    producer/consumer relation (e.g. parallel branches, multi-tenant
    workloads) remain independent and interleave freely — the source of the
    paper's multi-tenancy gain (§6.1, Fig 11).
    """
    all_ops: list[TileOp] = []
    final: dict[tuple[int, int, int], int] = {}
    last_ops_of_gemm: dict[int, tuple[int, ...]] = {}
    oid = 0
    for gemm in gemms:
        producers: tuple[int, ...] = ()
        if layer_dependencies and gemm.depends_on:
            prod: list[int] = []
            for gid in gemm.depends_on:
                prod.extend(last_ops_of_gemm.get(gid, ()))
            producers = tuple(prod)
        g = tile_gemm(
            gemm, array, k_part=k_part, num_banks=num_banks,
            start_op_id=oid, producer_all_ops=producers,
            faulty_banks=faulty_banks,
        )
        all_ops.extend(g.ops)
        final.update(g.final_tiles)
        # consumers only need the *final* (fully accumulated) tiles
        last_ops_of_gemm[gemm.gemm_id] = tuple(
            opid for (gid, _, _), opid in g.final_tiles.items()
            if gid == gemm.gemm_id
        )
        oid += len(g.ops)
    return TileOpGraph(ops=all_ops, num_banks=num_banks, final_tiles=final)


# ---------------------------------------------------------------------------
# tile statistics fast path (no TileOp materialization)
# ---------------------------------------------------------------------------
#
# The DSE sweeps only need *counts* out of the tiling — how many tile ops a
# GEMM produces, the RAW-chain depth along the contraction, and the mean
# streamed activation rows k̄ — all of which are closed-form in (d1, d2, d3)
# and the array shape. `tile_stats` computes them as NumPy arrays over a
# whole workload at once; `gemm_levels` gives the topological level of each
# GEMM (parallel branches share a level), which is the schedule's outer
# barrier structure in the analytical wave model (simulator.analyze).


def gemm_levels(gemms: list[GemmSpec]) -> np.ndarray:
    """Topological level per GEMM, aligned with `gemms` order.

    Same rule as the offline scheduler's layer-by-layer barriers: a GEMM
    sits one level past its deepest producer; GEMMs with no producer/consumer
    relation (parallel branches, multi-tenant streams) share a level.
    Producers are resolved in gemm_id order; dangling ids are ignored.
    """
    depth: dict[int, int] = {}
    for g in sorted(gemms, key=lambda g: g.gemm_id):
        d = 0
        for pid in g.depends_on:
            if pid in depth:
                d = max(d, depth[pid] + 1)
        depth[g.gemm_id] = d
    return np.array([depth[g.gemm_id] for g in gemms], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class TileStats:
    """Per-GEMM tile counts for one workload on one array shape.

    All fields are int64/float64 arrays of length len(gemms), in the same
    order as the input workload.
    """

    d1: np.ndarray
    d2: np.ndarray
    d3: np.ndarray
    macs: np.ndarray      # d1*d2*d3
    level: np.ndarray     # topological level (gemm_levels)
    n_i: np.ndarray       # activation chunks  ceil(d1/k_part)
    n_j: np.ndarray       # RAW psum-chain depth  ceil(d2/rows)
    n_l: np.ndarray       # weight column chunks  ceil(d3/cols)
    tiles: np.ndarray     # n_i * n_j * n_l
    k_eff: np.ndarray     # mean streamed rows per tile of this GEMM, d1/n_i

    @property
    def total_tiles(self) -> int:
        return int(self.tiles.sum())

    @property
    def total_macs(self) -> int:
        return int(self.macs.sum())

    @property
    def k_bar(self) -> float:
        """Tile-weighted mean activation rows streamed per tile op."""
        t = self.tiles.sum()
        return float((self.tiles * self.k_eff).sum() / t) if t else 0.0

    @property
    def max_chain(self) -> int:
        """Longest RAW psum chain in the workload (critical path, tiles)."""
        return int(self.n_j.max()) if len(self.n_j) else 0

    @property
    def parallel_frontier(self) -> int:
        """Tile ops with no intra-workload dependency available at t=0
        (first-level GEMMs' first chain links): sum of n_i*n_l there."""
        if not len(self.level):
            return 0
        first = self.level == self.level.min()
        return int((self.n_i[first] * self.n_l[first]).sum())


def tile_counts(d1, d2, d3, rows, cols, k_part=None):
    """`tile_gemm`'s chunk counts (n_i, n_j, n_l) as a broadcast-friendly
    closed form: same k_part clipping (the paper's r x r rule when k_part
    is None), same ceil divisions. All args may be NumPy arrays of any
    mutually broadcastable shapes — the single source of the formula for
    both `tile_stats` and the batched engine (simulator.analyze_batch)."""
    kp = rows if k_part is None else k_part
    kpg = np.maximum(1, np.minimum(kp, d1))
    n_i = -(-d1 // kpg)
    n_j = -(-d2 // rows)
    n_l = -(-d3 // cols)
    return n_i, n_j, n_l


def tile_stats(
    gemms: list[GemmSpec],
    array: ArrayConfig,
    k_part: int | None = None,
) -> TileStats:
    """Closed-form tile counts for `tile_gemm`'s partitioning, vectorized
    over a workload — verified property-based against the materializing
    tiler in tests/test_dse_batch.py.
    """
    d1 = np.array([g.d1 for g in gemms], dtype=np.int64)
    d2 = np.array([g.d2 for g in gemms], dtype=np.int64)
    d3 = np.array([g.d3 for g in gemms], dtype=np.int64)
    n_i, n_j, n_l = tile_counts(d1, d2, d3, array.rows, array.cols, k_part)
    return TileStats(
        d1=d1, d2=d2, d3=d3,
        macs=d1 * d2 * d3,
        level=gemm_levels(gemms),
        n_i=n_i, n_j=n_j, n_l=n_l,
        tiles=n_i * n_j * n_l,
        k_eff=d1 / n_i,
    )
