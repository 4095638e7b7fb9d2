# Copy of src/repro/parallel/autoshard.py (the port imports nothing of repro).
"""SOSA-model-driven sharding & blocking decisions.

The paper's three pillars, applied at mesh scale (DESIGN.md §2):

  1. *Granularity*: each TPU chip's MXU is a 128x128 weight-stationary
     array — a "pod". `choose_blocks` runs the same effective-throughput
     trade-off as core/dse.py over Pallas block candidates: larger blocks
     amortize HBM traffic (the paper's memory-energy term), smaller blocks
     avoid edge waste when layer dims don't divide (the utilization term).

  2. *Tiling*: `plan_report` counts the parallel tiles each sharding plan
     exposes per device-GEMM — the paper's "#tiles >= #pods" criterion
     decides how much batch/sequence partitioning a shape needs.

  3. *Interconnect*: plans are scored with the analytical wave model
     (core/simulator.analyze) on the per-device GEMM trace, so a plan that
     starves pods (too little partitioning) or thrashes memory (too much)
     loses — the Fig 12b curve, reproduced at mesh scale.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from ..configs.base import ArchConfig, ShapeConfig
from ..core.arrays import ArrayConfig, AcceleratorConfig
from ..core.simulator import analyze
from ..core.tiling import GemmSpec, tile_stats
from ..core.workloads import transformer_lm

MXU = 128  # TPU MXU dimension: the per-chip "pod" granularity


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    name: str
    dp: int                 # batch ways (pod x data)
    tp: int                 # model ways
    microbatches: int = 1   # grad-accum splits (train only)
    seq_shard: bool = False # sequence-parallel residuals

    def describe(self) -> str:
        return (f"{self.name}: dp={self.dp} tp={self.tp} "
                f"ubatch={self.microbatches} sp={self.seq_shard}")


def device_gemms(cfg: ArchConfig, shape: ShapeConfig, plan: ShardPlan
                 ) -> list[GemmSpec]:
    """The GEMM trace one device executes under a plan (weight GEMMs of
    one layer stack pass, dims divided by the plan's ways)."""
    b_local = max(1, shape.global_batch // (plan.dp * plan.microbatches))
    seq = 1 if shape.is_decode else shape.seq_len
    heads = max(1, cfg.n_heads)
    tp_heads = plan.tp if heads % plan.tp == 0 else 1
    d_ff = cfg.moe.d_ff_expert if cfg.moe else max(1, cfg.d_ff)
    ff_local = max(1, d_ff // (1 if cfg.moe else plan.tp))
    return transformer_lm(
        n_layers=1,
        d_model=cfg.d_model,
        n_heads=max(1, heads // tp_heads),
        d_ff=ff_local,
        seq=seq,
        batch=b_local,
        vocab=0,
        n_kv_heads=max(1, cfg.n_kv_heads or 1),
        include_attention=not shape.is_decode,
    )


def tiles_exposed(gemms: list[GemmSpec], block: int = MXU) -> int:
    """Parallel tile count under the paper's r x r partitioning at MXU
    granularity — the quantity the tiling pillar maximizes."""
    total = 0
    for g in gemms:
        total += math.ceil(g.d1 / block) * math.ceil(g.d3 / block)
    return total


def candidate_plans(cfg: ArchConfig, shape: ShapeConfig, mesh_shape: dict
                    ) -> list[ShardPlan]:
    dp = 1
    for ax in ("pod", "data"):
        dp *= mesh_shape.get(ax, 1)
    tp = mesh_shape.get("model", 1)
    plans = [ShardPlan("dp-tp", dp, tp)]
    if shape.kind == "train":
        plans.append(ShardPlan("dp-tp+sp", dp, tp, seq_shard=True))
        for ub in (2, 4):
            if shape.global_batch // dp >= ub:
                plans.append(ShardPlan(f"dp-tp+ub{ub}", dp, tp,
                                       microbatches=ub, seq_shard=True))
    return plans


def score_plan(cfg: ArchConfig, shape: ShapeConfig, plan: ShardPlan,
               chip_pods: int = 1) -> float:
    """Effective throughput (TOPS @ chip power) of the per-device trace on
    an MXU-granularity pod model."""
    gemms = device_gemms(cfg, shape, plan)
    accel = AcceleratorConfig(
        array=ArrayConfig(rows=MXU, cols=MXU), num_pods=chip_pods,
        icn_mw_per_byte=0.0)
    res = analyze(gemms, accel, interconnect="crossbar")
    return res.effective_tops_at_tdp * plan.microbatches  # same total work


def choose_plan(cfg: ArchConfig, shape: ShapeConfig, mesh_shape: dict
                ) -> tuple[ShardPlan, list[tuple[str, float]]]:
    plans = candidate_plans(cfg, shape, mesh_shape)
    scored = [(p, score_plan(cfg, shape, p)) for p in plans]
    scored.sort(key=lambda t: -t[1])
    return scored[0][0], [(p.describe(), s) for p, s in scored]


# --------------------------------------------------------------------------
# tile_stats-driven Pallas block autotuner
# --------------------------------------------------------------------------
#
# The Pallas pod GEMM's (block_m, block_n, block_k) IS the paper's pod
# geometry: block_k is the array's contraction rows, block_n its output
# columns, block_m the activation rows streamed through per tile — so the
# same closed-form tiling model that drives the chip-level DSE
# (core.tiling.tile_stats with ArrayConfig(rows=block_k, cols=block_n),
# k_part=block_m) gives the kernel's exact grid counts (n_i, n_j, n_l).
# `choose_blocks` scores every candidate geometry with a roofline over
# those counts and is lru-cached per (shape, dtype) — the per-shape cache
# the serving hot loop relies on (one autotune per layer shape, ever).

# MXU peak: one 128x128 MAC wave per cycle; HBM: ~1 KiB/cycle at ~1 GHz
# (the v4-class ridge of ~16 MACs/byte — only the ratio matters here).
_MACS_PER_CYCLE = 128 * 128
_HBM_BYTES_PER_CYCLE = 1024
_VMEM_BUDGET = 12 * 2 ** 20   # working-set ceiling of the ~16 MiB VMEM


def _rup8(d: int) -> int:
    return max(8, ((d + 7) // 8) * 8)


@functools.lru_cache(maxsize=4096)
def _choose_blocks_cached(m: int, k: int, n: int,
                          candidates=(128, 256, 512),
                          dtype_bytes: int = 2, out_bytes: int = 4,
                          vmem_budget: int = _VMEM_BUDGET
                          ) -> tuple[int, int, int]:
    """The cached autotuner body behind `choose_blocks` (which adds the
    obs telemetry: cache hit/miss counters + per-shape utilization)."""
    # selection key: roofline time, then HBM traffic (a compute-bound tie
    # must not pick the max-traffic geometry), then VMEM footprint
    best, best_key = (MXU, MXU, MXU), (float("inf"),) * 3
    seen_eff: set[tuple[int, int, int]] = set()
    spec = [GemmSpec(d1=m, d2=k, d3=n)]
    for bm in candidates:
        for bn in candidates:
            for bk in candidates:
                # kernel-effective blocks (ops.systolic_gemm clips the same
                # way: min(block, sublane-rounded dim))
                bm_e = min(bm, _rup8(m))
                bn_e = min(bn, _rup8(n))
                bk_e = min(bk, _rup8(k))
                if (bm_e, bn_e, bk_e) in seen_eff:
                    continue
                seen_eff.add((bm_e, bn_e, bk_e))
                # VMEM working set: double-buffered streaming blocks + the
                # f32/int32 accumulator scratch + the output block
                vmem = (2 * (bm_e * bk_e + bk_e * bn_e) * dtype_bytes
                        + bm_e * bn_e * (4 + out_bytes))
                if vmem > vmem_budget:
                    continue
                st = tile_stats(spec, ArrayConfig(rows=bk_e, cols=bn_e),
                                k_part=bm_e)
                n_i, n_j, n_l = (int(st.n_i[0]), int(st.n_j[0]),
                                 int(st.n_l[0]))
                padded_macs = (n_i * bm_e) * (n_j * bk_e) * (n_l * bn_e)
                # HBM traffic of the kernel's K-minor grid walk: every
                # (i, j, l) step streams one x and one w block; outputs
                # write once per (i, l)
                traffic = (n_i * n_l * n_j * (bm_e * bk_e + bk_e * bn_e)
                           * dtype_bytes
                           + n_i * n_l * bm_e * bn_e * out_bytes)
                t = max(padded_macs / _MACS_PER_CYCLE,
                        traffic / _HBM_BYTES_PER_CYCLE)
                key = (t, traffic, vmem)
                if key < best_key:
                    best, best_key = (bm, bn, bk), key
    return best


def tile_utilization(m: int, k: int, n: int,
                     blocks: tuple[int, int, int]) -> float:
    """Padded-MAC utilization of an (m x k) @ (k x n) GEMM under a block
    geometry: useful MACs over the MACs the padded grid actually streams
    (the kernel pads every dim to its clipped block). This is the tile
    component of the paper's effective-throughput metric — the live
    effective-TOPS gauge (obs/drift.py) multiplies measured token
    throughput by it."""
    bm, bn, bk = blocks
    bm_e, bn_e, bk_e = (min(bm, _rup8(m)), min(bn, _rup8(n)),
                        min(bk, _rup8(k)))
    st = tile_stats([GemmSpec(d1=m, d2=k, d3=n)],
                    ArrayConfig(rows=bk_e, cols=bn_e), k_part=bm_e)
    n_i, n_j, n_l = int(st.n_i[0]), int(st.n_j[0]), int(st.n_l[0])
    padded = (n_i * bm_e) * (n_j * bk_e) * (n_l * bn_e)
    return (m * k * n) / padded if padded else 0.0


def choose_blocks(m: int, k: int, n: int,
                  candidates=(128, 256, 512),
                  dtype_bytes: int = 2, out_bytes: int = 4,
                  vmem_budget: int = _VMEM_BUDGET) -> tuple[int, int, int]:
    """Pallas GEMM block sizes for an (m x k) @ (k x n) GEMM, chosen by the
    SOSA DSE cost model (see kernels/systolic_gemm/systolic_gemm.py for the
    full autotuner contract).

    For each candidate (bm, bn, bk) the kernel-effective geometry (blocks
    clipped to the padded problem, exactly as ops.systolic_gemm clips) is
    scored as a roofline: max(padded-MAC compute time, HBM stream time)
    over `tile_stats`' closed-form grid counts, subject to the VMEM budget
    (double-buffered x/w blocks + accumulator + output block). Returns the
    best (block_m, block_n, block_k); results are lru-cached per shape
    (`choose_blocks.cache_info()` / `.cache_clear()` reach the cache).

    Every call records telemetry into the process-global obs registry
    (obs.metrics.registry): an `autotune.cache{result=hit|miss}` counter,
    and — on a miss — the chosen geometry (`autotune.choice{...}`) plus
    the shape's padded-MAC utilization gauge `autotune.tile_util{shape=
    MxKxN}`, the tile component of the live effective-TOPS gauge.
    Recording is host-side Python at trace time only (block choice happens
    while jit traces, never per device call).
    """
    before = _choose_blocks_cached.cache_info().misses
    blocks = _choose_blocks_cached(
        m, k, n, tuple(candidates), dtype_bytes, out_bytes, vmem_budget)
    hit = _choose_blocks_cached.cache_info().misses == before
    from ..obs.metrics import registry
    reg = registry()
    reg.counter("autotune.cache", result="hit" if hit else "miss").inc()
    if not hit:
        shape = f"{m}x{k}x{n}"
        bm, bn, bk = blocks
        reg.counter("autotune.choice", shape=shape,
                    blocks=f"{bm}x{bn}x{bk}").inc()
        reg.gauge("autotune.tile_util", shape=shape).set(
            tile_utilization(m, k, n, blocks))
    return blocks


choose_blocks.cache_info = _choose_blocks_cached.cache_info
choose_blocks.cache_clear = _choose_blocks_cached.cache_clear


@functools.lru_cache(maxsize=4096)
def choose_blocks_grouped(g: int, m: int, k: int, n: int,
                          candidates=(128, 256, 512),
                          dtype_bytes: int = 2, out_bytes: int = 4,
                          vmem_budget: int = _VMEM_BUDGET
                          ) -> tuple[int, int, int]:
    """Block geometry for the grouped pod GEMM: G independent (m x k x n)
    problems in one launch (kernels.systolic_gemm.grouped_systolic_gemm_
    pallas). The grid tiles the *per-group* problem and the VMEM working
    set is one group's blocks, so the score is exactly `choose_blocks` of
    (m, k, n): the group axis multiplies padded MACs and HBM traffic by G
    uniformly and cannot shift the roofline argmin. Kept as its own cached
    entry point so grouped shapes (MoE experts: small per-expert m = G_cap
    rows) autotune independently of the dense shapes they share dims with.
    """
    assert g >= 1
    return choose_blocks(m, k, n, candidates=candidates,
                         dtype_bytes=dtype_bytes, out_bytes=out_bytes,
                         vmem_budget=vmem_budget)


# The transposed-weight kernel (systolic_gemm_nt_pallas: x [M,K] @ w[N,K]^T,
# the tied-embedding LM head) reuses `choose_blocks(m, k, n)` unchanged:
# its w block is [bn, bk] instead of [bk, bn] — identical bytes, identical
# grid walk, identical psum-chain depth — so the roofline is layout-
# invariant. ops.systolic_gemm_t calls choose_blocks with the logical
# (M, K, N) of the product, exactly like the untransposed path.


def plan_report(cfg: ArchConfig, shape: ShapeConfig, mesh_shape: dict) -> str:
    plan, table = choose_plan(cfg, shape, mesh_shape)
    gemms = device_gemms(cfg, shape, plan)
    lines = [f"autoshard {cfg.name} x {shape.name}:"]
    for desc, score in table:
        lines.append(f"  {desc:40s} eff={score:8.2f} TOPS")
    lines.append(f"  -> {plan.describe()}; tiles/device="
                 f"{tiles_exposed(gemms)} (pods-per-chip criterion: >= 1)")
    return "\n".join(lines)
