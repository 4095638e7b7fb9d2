# Copy of src/repro/core/simulator.py (the port imports nothing of repro).
"""SOSA performance/energy simulator.

Three evaluation paths over the same tiling model:

  * `simulate(...)`      — slice-accurate: runs the real offline scheduler
    (core/scheduler.py) with the functional Butterfly-k router, bank ports
    and RAW chains, then reduces the schedule to cycles / utilization /
    effective throughput / energy. This is the paper's own methodology
    (their artifact is a cycle-accurate simulator driven by a compiler).

  * `analyze(...)`       — analytical: closed-form wave model of the same
    tiling, used for the Fig-5 design-space sweeps where running the full
    scheduler for every (r, c) point would be needlessly slow. Validated
    against `simulate` in tests (tests/test_simulator.py). Since the
    batched engine landed this is a thin single-point wrapper around
    `analyze_batch`; the original pure-Python closed form survives as
    `analyze_scalar` and serves as the property-test oracle
    (tests/test_dse_batch.py).

  * `analyze_batch(...)` — the batched DSE engine: the same wave model as
    array-shaped NumPy over an entire design grid x workload suite at
    once. Workloads are packed into flat per-GEMM arrays
    (`pack_workloads`), hardware points into a `DesignVector`, and every
    (point, workload) metric falls out of one broadcasted evaluation —
    no per-point Python, which is what makes the Fig-5 grid ~2 orders of
    magnitude faster than the scalar loop.

All report the paper's headline metric, effective throughput @ TDP
(= isopower peak throughput x utilization, Table 2).

Interconnect latency exposure (Table 1 'cycles per tile op'): a slice's
service time is max(k, r) streaming cycles + array fill/drain latency +
any interconnect round-trip not hidden under the streaming time:
    exposed = max(0, 2*stages - max(k, r))
Benes' 2logN-1 (+copy network) stages exceed the 32-cycle tiles and become
exposed — the paper's core argument against it.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np

from .arrays import (ACT_BYTES, E_MAC_PJ, E_SRAM_PJ_PER_BYTE, OPS_PER_MAC,
                     PSUM_BYTES, WEIGHT_BYTES, AcceleratorConfig)
from .interconnect import (benes_spec, butterfly_spec, crossbar_spec,
                           htree_spec, mesh_spec)
from .scheduler import SliceScheduler
from .tiling import (GemmSpec, TileOpGraph, gemm_levels, tile_counts,
                     tile_workload)


def _faulty_ids(faulty_pods, num_pods: int) -> tuple[int, ...]:
    """Normalize a degraded-pod mask to explicit pod ids.

    An int n masks the n highest-numbered pods (the convention the
    analytical paths price by count alone); a sequence names the dead pods
    directly. Validates 0 <= id < num_pods and at least one survivor."""
    if isinstance(faulty_pods, (int, np.integer)):
        n = int(faulty_pods)
        if not 0 <= n < num_pods:
            raise ValueError(f"faulty_pods={n} out of range for "
                             f"{num_pods} pods")
        return tuple(range(num_pods - n, num_pods))
    ids = tuple(sorted(set(int(p) for p in faulty_pods)))
    if any(p < 0 or p >= num_pods for p in ids):
        raise ValueError(f"faulty_pods {list(ids)} out of range for "
                         f"{num_pods} pods")
    if len(ids) >= num_pods:
        raise ValueError("all pods faulty: nothing to run on")
    return ids


def _faulty_count(faulty_pods) -> int:
    """Number of dead pods in a mask (int passes through)."""
    if isinstance(faulty_pods, (int, np.integer)):
        return int(faulty_pods)
    return len(set(int(p) for p in faulty_pods))


def icn_spec_for(name: str, ports: int):
    if name.startswith("butterfly"):
        k = int(name.split("-")[1]) if "-" in name else 1
        return butterfly_spec(ports, k)
    return {
        "benes": benes_spec, "crossbar": crossbar_spec,
        "mesh": mesh_spec, "htree": htree_spec,
    }[name](ports)


@dataclasses.dataclass
class SimResult:
    name: str
    total_macs: int
    total_cycles: int
    num_pods: int
    utilization: float            # useful MACs / (PEs * cycles)
    busy_pods: float              # fraction of pod-slices with work
    cycles_per_tile: float        # avg service latency per tile op
    effective_tops_at_tdp: float  # the paper's headline metric
    peak_tops_at_tdp: float
    energy_joules: float
    avg_power_watts: float
    num_tile_ops: int
    num_slices: int

    @property
    def effective_tops_per_watt(self) -> float:
        if self.avg_power_watts == 0:
            return 0.0
        macs_per_s = self.total_macs / (self.total_cycles / 1e9)
        return macs_per_s * OPS_PER_MAC / 1e12 / self.avg_power_watts


def _slice_cycles(accel: AcceleratorConfig, icn_name: str, k_bar: float) -> float:
    """Service cycles per slice: streaming + fill/drain + exposed icn."""
    arr = accel.array
    stream = max(k_bar, arr.rows)
    spec = icn_spec_for(icn_name, max(2, accel.num_pods))
    exposed = max(0.0, 2 * spec.stages - stream)
    return stream + arr.pipeline_latency + exposed


def _energy(accel: AcceleratorConfig, graph: TileOpGraph, icn_name: str,
            total_cycles: float) -> tuple[float, float]:
    """(energy J, avg power W): MAC energy + bank bytes + interconnect."""
    arr = accel.array
    spec = icn_spec_for(icn_name, max(2, accel.num_pods))
    e = 0.0
    for op in graph.ops:
        e += op.macs * E_MAC_PJ
        xbytes = op.k * op.r_eff * ACT_BYTES
        wbytes = op.r_eff * op.c_eff * WEIGHT_BYTES
        pbytes = op.k * op.c_eff * PSUM_BYTES * (2 if op.j > 0 else 1)
        moved = xbytes + wbytes + pbytes
        e += moved * (E_SRAM_PJ_PER_BYTE + spec.mw_per_byte)  # pJ (mW/B @1GHz == pJ/B)
    e *= 1e-12
    t = total_cycles / arr.clock_hz
    return e, (e / t if t > 0 else 0.0)


def simulate(
    gemms: list[GemmSpec],
    accel: AcceleratorConfig,
    interconnect: str = "butterfly-2",
    k_part: int | None = None,
    name: str = "",
    faulty_pods=0,
) -> SimResult:
    """Slice-accurate simulation: tile -> schedule -> metrics.

    faulty_pods (int count or sequence of pod ids) retiles and reschedules
    over the survivors: a dead pod takes its local SRAM bank group with it
    (matching bank masks in tile_workload) while fabric geometry and the
    full-machine utilization denominator stay fixed."""
    arr = accel.array
    dead = _faulty_ids(faulty_pods, accel.num_pods)
    graph = tile_workload(gemms, arr, k_part=k_part,
                          num_banks=accel.num_pods, faulty_banks=dead)
    sched = SliceScheduler(
        num_pods=accel.num_pods,
        array_rows=arr.rows,
        pipeline_latency=arr.pipeline_latency,
        interconnect=interconnect,
        faulty_pods=dead,
    ).schedule(graph)

    k_bar = (sum(op.k for op in graph.ops) / len(graph.ops)) if graph.ops else arr.rows
    slice_cyc = _slice_cycles(accel, interconnect, k_bar)
    total_cycles = sched.num_slices * slice_cyc
    total_macs = graph.total_macs
    util = total_macs / (accel.num_pods * arr.num_pe * total_cycles) if total_cycles else 0.0
    energy, power = _energy(accel, graph, interconnect, total_cycles)
    return SimResult(
        name=name,
        total_macs=total_macs,
        total_cycles=int(total_cycles),
        num_pods=accel.num_pods,
        utilization=util,
        busy_pods=sched.pods_busy_fraction(),
        cycles_per_tile=slice_cyc,
        effective_tops_at_tdp=accel.peak_ops_at_tdp * util / 1e12,
        peak_tops_at_tdp=accel.peak_ops_at_tdp / 1e12,
        energy_joules=energy,
        avg_power_watts=power,
        num_tile_ops=len(graph.ops),
        num_slices=sched.num_slices,
    )


# ---------------------------------------------------------------------------
# analytical wave model (fast path for the Fig-5 DSE sweeps)
# ---------------------------------------------------------------------------

# relative pod-availability per fabric (Table 1 busy-pods, normalized to the
# full-permutation fabrics); only Butterfly-1's limited combinatorial power
# costs throughput. Butterfly-1's ratio is *calibrated* from the functional
# router (interconnect.routed_fraction) on first use rather than hardcoded
# from the paper; the measured value is regression-pinned to within 5% of
# Table 1's 66.81/72.41 in tests/test_tenancy.py.
_ICN_EFFICIENCY = {
    "butterfly-2": 1.0, "butterfly-4": 1.0, "butterfly-8": 1.0,
    "crossbar": 1.0, "benes": 1.0, "mesh": 0.55, "htree": 0.45,
}
_CALIBRATED_ICN = ("butterfly-1",)


def icn_efficiency(name: str) -> float:
    """Busy-pod efficiency of a fabric for the analytical wave model.

    Fabrics with restricted combinatorial power are measured against the
    functional router under the scheduler's own traffic model (random
    permutation slices with the 8-candidate destination search) and
    normalized to the corresponding full-permutation fabric — here,
    Butterfly-1 relative to Butterfly-2. The result is cached module-wide;
    every other fabric keeps its Table-1 value.
    """
    if name in _CALIBRATED_ICN and name not in _ICN_EFFICIENCY:
        from .interconnect import routed_fraction
        k = int(name.split("-")[1])
        _ICN_EFFICIENCY[name] = (routed_fraction(name)
                                 / routed_fraction(f"butterfly-{2 * k}"))
    return _ICN_EFFICIENCY.get(name, 1.0)


def _levels(gemms: list[GemmSpec]) -> list[list[GemmSpec]]:
    """Group layers into topological levels (parallel branches share one).

    Thin wrapper over tiling.gemm_levels — one leveling rule for the
    scalar oracle, the batched engine, and the memory-sweep benchmark."""
    depth = gemm_levels(gemms)
    lv: dict[int, list[GemmSpec]] = defaultdict(list)
    for i in sorted(range(len(gemms)), key=lambda i: gemms[i].gemm_id):
        lv[int(depth[i])].append(gemms[i])
    return [lv[i] for i in sorted(lv)]


def analyze_scalar(
    gemms: list[GemmSpec],
    accel: AcceleratorConfig,
    interconnect: str = "butterfly-2",
    k_part: int | None = None,
    name: str = "",
    faulty_pods=0,
) -> SimResult:
    """Closed-form wave model of the tiled schedule (pure-Python reference).

    Per level: every GEMM contributes ceil(d1/k)*ceil(d3/c) independent
    psum chains of length ceil(d2/r). Chains from all GEMMs of the level
    run concurrently in waves of `pods` (scaled by the fabric's busy-pod
    efficiency); the level cannot finish faster than its longest chain.

    This is the original scalar implementation, kept verbatim as the
    independent oracle for the batched engine (`analyze_batch`); use
    `analyze` for single points — it routes through the batched engine.
    """
    arr = accel.array
    r, c = arr.rows, arr.cols
    kp = k_part if k_part is not None else r
    # degraded pods shrink the wave width only: the fabric, bank count and
    # the peak/utilization denominators keep full-machine geometry
    _faulty_ids(faulty_pods, accel.num_pods)      # validate
    healthy = accel.num_pods - _faulty_count(faulty_pods)
    eff_pods = healthy * icn_efficiency(interconnect)

    total_macs = 0
    total_slices = 0.0
    total_tiles = 0
    k_sum = 0.0
    for level in _levels(gemms):
        pod_slices = 0.0
        crit = 0.0
        for g in level:
            kpg = max(1, min(kp, g.d1))
            n_i = math.ceil(g.d1 / kpg)
            n_j = math.ceil(g.d2 / r)
            n_l = math.ceil(g.d3 / c)
            pod_slices += n_i * n_j * n_l
            crit = max(crit, n_j)
            total_macs += g.macs
            total_tiles += n_i * n_j * n_l
            k_sum += n_i * n_j * n_l * (g.d1 / n_i)
        total_slices += max(crit, pod_slices / eff_pods)

    k_bar = (k_sum / total_tiles) if total_tiles else r
    slice_cyc = _slice_cycles(accel, interconnect, k_bar)
    total_cycles = total_slices * slice_cyc
    util = total_macs / (accel.num_pods * arr.num_pe * total_cycles) if total_cycles else 0.0
    busy = total_tiles / (total_slices * accel.num_pods) if total_slices else 0.0

    # energy: same accounting as the slice-accurate path without scheduling
    spec = icn_spec_for(interconnect, max(2, accel.num_pods))
    e_pj = 0.0
    for g in gemms:
        n_j = math.ceil(g.d2 / r)
        e_pj += g.macs * E_MAC_PJ
        e_pj += g.d1 * g.d2 * ACT_BYTES * (E_SRAM_PJ_PER_BYTE + spec.mw_per_byte)
        e_pj += g.d2 * g.d3 * WEIGHT_BYTES * (E_SRAM_PJ_PER_BYTE + spec.mw_per_byte)
        e_pj += g.d1 * g.d3 * PSUM_BYTES * (2 * n_j - 1) * (
            E_SRAM_PJ_PER_BYTE + spec.mw_per_byte)
    energy = e_pj * 1e-12
    t = total_cycles / arr.clock_hz if total_cycles else 0.0
    power = energy / t if t > 0 else 0.0

    return SimResult(
        name=name,
        total_macs=total_macs,
        total_cycles=int(total_cycles),
        num_pods=accel.num_pods,
        utilization=util,
        busy_pods=min(1.0, busy),
        cycles_per_tile=slice_cyc,
        effective_tops_at_tdp=accel.peak_ops_at_tdp * util / 1e12,
        peak_tops_at_tdp=accel.peak_ops_at_tdp / 1e12,
        energy_joules=energy,
        avg_power_watts=power,
        num_tile_ops=total_tiles,
        num_slices=int(total_slices),
    )


# ---------------------------------------------------------------------------
# batched DSE engine: the wave model as array-shaped NumPy over a whole
# (design point x workload) grid in one call
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedWorkloads:
    """A workload suite flattened into per-GEMM arrays for batched analysis.

    GEMMs are sorted by (workload, level) so both the per-level wave
    reduction and the per-workload totals are contiguous-segment reductions
    (np.ufunc.reduceat) — no Python per-GEMM loop anywhere downstream.
    """

    names: tuple[str, ...]
    d1: np.ndarray             # (G,) int64, G = total GEMMs across workloads
    d2: np.ndarray
    d3: np.ndarray
    macs: np.ndarray           # (G,) d1*d2*d3
    seg_starts: np.ndarray     # (S,) first GEMM of each (workload, level)
    wl_seg_starts: np.ndarray  # (W,) first segment of each workload
    wl_gemm_starts: np.ndarray  # (W,) first GEMM of each workload

    @property
    def num_workloads(self) -> int:
        return len(self.names)

    def level_working_set_bytes(self) -> np.ndarray:
        """(S,) SRAM working set per (workload, level) segment: live
        activation tiles + double-buffered weights + int16 psum tiles —
        the same per-level accounting benchmarks/memory_sweep.py originally
        ran as a Python loop, as one reduceat over the packed arrays."""
        ws = (self.d1 * self.d2 * ACT_BYTES
              + 2 * self.d2 * self.d3 * WEIGHT_BYTES
              + self.d1 * self.d3 * PSUM_BYTES)
        return np.add.reduceat(ws, self.seg_starts)


def pack_workloads(
    workloads: dict[str, list[GemmSpec]] | list[list[GemmSpec]],
) -> PackedWorkloads:
    """Flatten a workload suite into reduceat-ready arrays (see above)."""
    if isinstance(workloads, dict):
        items = list(workloads.items())
    else:
        items = [(f"wl{i}", wl) for i, wl in enumerate(workloads)]
    if not items or any(not wl for _, wl in items):
        raise ValueError("pack_workloads needs at least one non-empty workload")

    names: list[str] = []
    d1: list[np.ndarray] = []
    d2: list[np.ndarray] = []
    d3: list[np.ndarray] = []
    seg_starts: list[int] = []
    wl_seg_starts: list[int] = []
    wl_gemm_starts: list[int] = []
    g_off = 0
    for name, wl in items:
        names.append(name)
        lv = gemm_levels(wl)
        order = np.argsort(lv, kind="stable")
        lv = lv[order]
        d1.append(np.array([wl[i].d1 for i in order], dtype=np.int64))
        d2.append(np.array([wl[i].d2 for i in order], dtype=np.int64))
        d3.append(np.array([wl[i].d3 for i in order], dtype=np.int64))
        wl_seg_starts.append(len(seg_starts))
        wl_gemm_starts.append(g_off)
        # level-segment boundaries within this workload
        bounds = np.flatnonzero(np.r_[True, lv[1:] != lv[:-1]]) + g_off
        seg_starts.extend(bounds.tolist())
        g_off += len(wl)

    d1a = np.concatenate(d1)
    d2a = np.concatenate(d2)
    d3a = np.concatenate(d3)
    return PackedWorkloads(
        names=tuple(names), d1=d1a, d2=d2a, d3=d3a, macs=d1a * d2a * d3a,
        seg_starts=np.asarray(seg_starts, dtype=np.int64),
        wl_seg_starts=np.asarray(wl_seg_starts, dtype=np.int64),
        wl_gemm_starts=np.asarray(wl_gemm_starts, dtype=np.int64),
    )


def sram_spill_bytes(packed: PackedWorkloads, sram_bytes) -> np.ndarray:
    """Per-workload bytes spilled to DRAM over a grid of SRAM capacities.

    `sram_bytes` is a scalar or (B,) array of total on-chip capacities
    (banks x bank size); each (workload, level) working set beyond capacity
    spills (Fig 13 / §6.4 model). Returns (B, W) — with the capacities axis
    broadcast, the whole (bank-size x design) sweep needs just one
    `analyze_batch` call for the compute side (benchmarks/memory_sweep.py).
    """
    ws = packed.level_working_set_bytes().astype(np.float64)      # (S,)
    cap = np.atleast_1d(np.asarray(sram_bytes, dtype=np.float64))
    spill = np.maximum(0.0, ws[None, :] - cap[:, None])           # (B, S)
    return np.add.reduceat(spill, packed.wl_seg_starts, axis=1)   # (B, W)


@dataclasses.dataclass(frozen=True)
class DesignVector:
    """Per-design-point hardware quantities, shape (P,) each — everything
    the wave model needs, with the interconnect spec already resolved."""

    rows: np.ndarray               # int64
    cols: np.ndarray
    num_pods: np.ndarray
    pipeline_latency: np.ndarray   # int64, fill/drain cycles
    peak_ops_at_tdp: np.ndarray    # float64, ops/s isopower-normalized
    icn_stages: np.ndarray         # int64, one-way traversal depth
    icn_energy_mw: np.ndarray      # float64, spec mW/B for the energy model
    icn_eff: np.ndarray            # float64, busy-pod efficiency (Table 1)
    clock_hz: float = 1e9

    @property
    def num_points(self) -> int:
        return len(self.rows)

    def repeat(self, n: int) -> "DesignVector":
        """The same design point replicated n times (e.g. to sweep a
        per-point parameter like k_part over fixed hardware)."""
        return DesignVector(
            rows=np.repeat(self.rows, n), cols=np.repeat(self.cols, n),
            num_pods=np.repeat(self.num_pods, n),
            pipeline_latency=np.repeat(self.pipeline_latency, n),
            peak_ops_at_tdp=np.repeat(self.peak_ops_at_tdp, n),
            icn_stages=np.repeat(self.icn_stages, n),
            icn_energy_mw=np.repeat(self.icn_energy_mw, n),
            icn_eff=np.repeat(self.icn_eff, n),
            clock_hz=self.clock_hz,
        )

    @classmethod
    def from_accel(cls, accel: AcceleratorConfig,
                   interconnect: str = "butterfly-2") -> "DesignVector":
        """Single-point vector from a config object (exact scalar specs)."""
        arr = accel.array
        spec = icn_spec_for(interconnect, max(2, accel.num_pods))
        as1 = lambda v, dt: np.asarray([v], dtype=dt)  # noqa: E731
        return cls(
            rows=as1(arr.rows, np.int64), cols=as1(arr.cols, np.int64),
            num_pods=as1(accel.num_pods, np.int64),
            pipeline_latency=as1(arr.pipeline_latency, np.int64),
            peak_ops_at_tdp=as1(accel.peak_ops_at_tdp, np.float64),
            icn_stages=as1(spec.stages, np.int64),
            icn_energy_mw=as1(spec.mw_per_byte, np.float64),
            icn_eff=as1(icn_efficiency(interconnect), np.float64),
            clock_hz=arr.clock_hz,
        )


@dataclasses.dataclass(frozen=True)
class BatchedAnalysis:
    """`analyze` over a (P design points x W workloads) grid; every metric
    array is shaped (P, W) unless noted."""

    names: tuple[str, ...]
    design: DesignVector
    total_macs: np.ndarray             # (W,)
    total_cycles: np.ndarray           # float; int-truncated on materialize
    num_slices: np.ndarray
    level_slices: np.ndarray           # (P, S) wave count per (wl, level)
                                       # segment — tenancy/planner.py reads
                                       # per-tenant completion out of these
    num_tile_ops: np.ndarray
    utilization: np.ndarray
    busy_pods: np.ndarray
    cycles_per_tile: np.ndarray
    effective_tops_at_tdp: np.ndarray
    peak_tops_at_tdp: np.ndarray       # (P,)
    energy_joules: np.ndarray
    avg_power_watts: np.ndarray

    @property
    def effective_tops_per_watt(self) -> np.ndarray:
        """(P, W), same int-cycle truncation as SimResult's property."""
        cyc = np.maximum(1.0, np.floor(self.total_cycles))
        macs_per_s = self.total_macs[None, :] / (cyc / 1e9)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = macs_per_s * OPS_PER_MAC / 1e12 / self.avg_power_watts
        return np.where(self.avg_power_watts > 0, out, 0.0)

    def result(self, p: int, w: int = 0, name: str | None = None) -> SimResult:
        """Materialize one grid cell as a scalar SimResult."""
        return SimResult(
            name=self.names[w] if name is None else name,
            total_macs=int(self.total_macs[w]),
            total_cycles=int(self.total_cycles[p, w]),
            num_pods=int(self.design.num_pods[p]),
            utilization=float(self.utilization[p, w]),
            busy_pods=float(self.busy_pods[p, w]),
            cycles_per_tile=float(self.cycles_per_tile[p, w]),
            effective_tops_at_tdp=float(self.effective_tops_at_tdp[p, w]),
            peak_tops_at_tdp=float(self.peak_tops_at_tdp[p]),
            energy_joules=float(self.energy_joules[p, w]),
            avg_power_watts=float(self.avg_power_watts[p, w]),
            num_tile_ops=int(self.num_tile_ops[p, w]),
            num_slices=int(self.num_slices[p, w]),
        )


def analyze_batch(
    packed: PackedWorkloads,
    design: DesignVector,
    k_part: int | np.ndarray | None = None,
    faulty_pods: int | np.ndarray = 0,
) -> BatchedAnalysis:
    """The closed-form wave model, broadcast over the full grid.

    Shapes: P design points, G GEMMs (all workloads concatenated),
    S (workload, level) segments, W workloads. The per-GEMM intermediates
    are (P, G); reduceat folds them to (P, S) level waves and then (P, W)
    workload totals. `k_part` may be a scalar (applied everywhere), an
    array of shape (P,) (per-point activation partition — used by the
    tiling sweep), or None for the paper's k = rows rule.

    `faulty_pods` (scalar count or (P,) per-point counts) shrinks the wave
    width to the surviving pods while keeping the fabric spec and the
    peak/utilization denominators at full-machine geometry — predictions
    are therefore monotone non-increasing in masked pods by construction
    (eff_pods only ever enters as a divisor under a max with the RAW
    critical path).
    """
    d1, d2, d3 = packed.d1[None, :], packed.d2[None, :], packed.d3[None, :]
    r = design.rows[:, None]
    c = design.cols[:, None]

    if k_part is None:
        kp = r
    else:
        kp = np.asarray(k_part, dtype=np.int64)
        # scalar -> everywhere; (P,)/(P,1) -> per design point
        kp = kp.reshape(1, 1) if kp.ndim == 0 else kp.reshape(-1, 1)
    n_i, n_j, n_l = tile_counts(d1, d2, d3, r, c, kp)
    tiles = n_i * n_j * n_l                      # (P, G)

    # wave count per (workload, level) segment: waves of eff_pods concurrent
    # chains, floored by the longest RAW chain of the level; degraded pods
    # narrow the wave (survivors only)
    f = np.asarray(faulty_pods, dtype=np.int64)
    healthy = design.num_pods - f                # (P,) by broadcast
    if np.any(f < 0) or np.any(healthy < 1):
        raise ValueError("faulty_pods must satisfy 0 <= f < num_pods "
                         "at every design point")
    eff_pods = (healthy * design.icn_eff)[:, None]
    pod_slices = np.add.reduceat(tiles, packed.seg_starts, axis=1)
    crit = np.maximum.reduceat(n_j, packed.seg_starts, axis=1)
    level_slices = np.maximum(crit, pod_slices / eff_pods)   # (P, S)

    ws = packed.wl_seg_starts
    wg = packed.wl_gemm_starts
    total_slices = np.add.reduceat(level_slices, ws, axis=1)  # (P, W)
    total_tiles = np.add.reduceat(tiles, wg, axis=1)
    k_sum = np.add.reduceat(tiles * (d1 / n_i), wg, axis=1)
    total_macs = np.add.reduceat(packed.macs, wg)             # (W,)

    # slice service time: streaming + fill/drain + exposed interconnect
    k_bar = k_sum / total_tiles
    stream = np.maximum(k_bar, r)
    exposed = np.maximum(0.0, 2 * design.icn_stages[:, None] - stream)
    slice_cyc = stream + design.pipeline_latency[:, None] + exposed  # (P, W)

    total_cycles = total_slices * slice_cyc
    num_pe = (design.rows * design.cols * design.num_pods)[:, None]
    util = total_macs[None, :] / (num_pe * total_cycles)
    busy = np.minimum(1.0, total_tiles / (total_slices * design.num_pods[:, None]))

    # energy: same accounting as analyze_scalar, in one (P, G) pass
    e_per_b = E_SRAM_PJ_PER_BYTE + design.icn_energy_mw[:, None]
    e_pj = (
        packed.macs[None, :] * E_MAC_PJ
        + (d1 * d2 * ACT_BYTES + d2 * d3 * WEIGHT_BYTES) * e_per_b
        + d1 * d3 * PSUM_BYTES * (2 * n_j - 1) * e_per_b
    )
    energy = np.add.reduceat(e_pj, wg, axis=1) * 1e-12        # (P, W) joules
    t = total_cycles / design.clock_hz
    power = energy / t

    return BatchedAnalysis(
        names=packed.names,
        design=design,
        total_macs=total_macs,
        total_cycles=total_cycles,
        num_slices=total_slices.astype(np.int64),
        level_slices=level_slices,
        num_tile_ops=total_tiles,
        utilization=util,
        busy_pods=busy,
        cycles_per_tile=slice_cyc,
        effective_tops_at_tdp=design.peak_ops_at_tdp[:, None] * util / 1e12,
        peak_tops_at_tdp=design.peak_ops_at_tdp / 1e12,
        energy_joules=energy,
        avg_power_watts=power,
    )


def analyze(
    gemms: list[GemmSpec],
    accel: AcceleratorConfig,
    interconnect: str = "butterfly-2",
    k_part: int | None = None,
    name: str = "",
    faulty_pods=0,
) -> SimResult:
    """Closed-form wave model of the tiled schedule (see `analyze_scalar`
    for the math) — thin single-point wrapper over the batched engine."""
    if not gemms:
        return analyze_scalar(gemms, accel, interconnect, k_part, name,
                              faulty_pods=faulty_pods)
    packed = pack_workloads({name or "workload": gemms})
    design = DesignVector.from_accel(accel, interconnect)
    batch = analyze_batch(packed, design, k_part=k_part,
                          faulty_pods=_faulty_count(faulty_pods))
    return batch.result(0, 0, name=name)


def merge_workloads(*workloads: list[GemmSpec]) -> list[GemmSpec]:
    """Multi-tenancy (§6.1): co-schedule independent workloads. GEMM ids are
    re-based so streams stay dependency-disjoint and interleave freely.

    This is the primitive under repro.tenancy (TenantMix.merged wraps it;
    the batched planner evaluates whole grids of merged co-schedules, and
    benchmarks/multitenancy.py keeps this + analyze_scalar as the oracle)."""
    merged: list[GemmSpec] = []
    base = 0
    for wl in workloads:
        for g in wl:
            merged.append(GemmSpec(
                d1=g.d1, d2=g.d2, d3=g.d3,
                gemm_id=g.gemm_id + base,
                depends_on=tuple(d + base for d in g.depends_on),
                name=g.name,
            ))
        base += (max((g.gemm_id for g in wl), default=0) + 1)
    return merged
