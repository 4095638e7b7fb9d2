# Copy of src/repro/tenancy/planner.py (the port imports nothing of repro).
"""Multi-tenant co-schedule planner (SOSA §6.1, Fig 11).

Two co-scheduling policies over a (designs x tenant-mixes) grid:

  * time-multiplexed ("time-mux") — all pods are shared: the mix's merged
    co-schedule (mix.TenantMix.merged) runs as one workload, idle pod
    slices of one tenant's waves absorbing the other tenants' tiles. The
    whole grid — every mix's merged trace plus every tenant's solo
    baseline — is ONE `analyze_batch` call over `pack_mixes` +
    `solo_workloads`. A stream's latency is the drain time of its own
    deepest level inside the merged schedule (`BatchedAnalysis.
    level_slices` cumulated to the stream's depth).

  * space-shared ("space-share") — pods are partitioned: each stream gets
    a power-of-two pod share proportional to its MACs and runs alone on it
    (an isolated sub-accelerator, same array/fabric). All (design, mix,
    stream) partitions are evaluated in one `analyze_batch` over an
    expanded DesignVector.

Every plan reports per-tenant latency / SLO attainment, Jain fairness over
per-stream progress shares, effective TOPS @TDP, and the sequential
(back-to-back solo) baseline — `parallel_gain` is the paper's Fig-11
metric (1.44x for ResNet+BERT on 256 pods).

Validation: `plan_mix_scalar` is the pure-Python `merge_workloads` +
wave-model oracle (analyze_scalar's math, cumulated per level) the
batched path must match exactly, and the
time-mux makespan is checked against the slice-accurate `SliceScheduler`
(core/scheduler.py) on merged graphs inside the calibrated parity bands —
both in tests/test_tenancy.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.arrays import AcceleratorConfig
from ..core.dse import Design, build_accel, build_design_vector
from ..core.simulator import (_levels, _slice_cycles, analyze_batch,
                              icn_efficiency, pack_workloads)
from ..core.tiling import tile_counts
from .mix import TenantMix, solo_workloads, tenant_depths

TIME_MUX = "time-mux"
SPACE_SHARE = "space-share"


@dataclasses.dataclass(frozen=True)
class TenantReport:
    """One replica stream's outcome inside a co-schedule."""

    tenant: str
    stream: int                    # replica index within the mix
    latency_s: float               # completion time inside the co-schedule
    solo_latency_s: float          # alone on the full machine
    slo_latency_s: float | None
    pods: int                      # pods visible to this stream

    @property
    def slowdown(self) -> float:
        """Co-scheduled latency over solo latency (>= 1 under sharing)."""
        return self.latency_s / self.solo_latency_s if self.solo_latency_s \
            else float("inf")

    @property
    def slo_met(self) -> bool | None:
        if self.slo_latency_s is None:
            return None
        return self.latency_s <= self.slo_latency_s


@dataclasses.dataclass(frozen=True)
class TenancyPlan:
    """A (design, mix, policy) cell of the co-scheduling grid."""

    mix: str
    policy: str
    rows: int
    cols: int
    num_pods: int
    interconnect: str
    makespan_s: float
    utilization: float
    effective_tops_at_tdp: float
    sequential_effective_tops: float   # back-to-back solo baseline
    streams: tuple[TenantReport, ...]

    @property
    def parallel_gain(self) -> float:
        """Fig-11 headline: co-scheduled over sequential effective TOPS."""
        if self.sequential_effective_tops == 0:
            return float("inf")
        return self.effective_tops_at_tdp / self.sequential_effective_tops

    @property
    def slo_attainment(self) -> float:
        """Fraction of streams meeting their SLO (1.0 when none declared)."""
        declared = [s for s in self.streams if s.slo_latency_s is not None]
        if not declared:
            return 1.0
        return sum(1 for s in declared if s.slo_met) / len(declared)

    @property
    def fairness(self) -> float:
        """Jain's index over per-stream progress shares (solo/latency):
        1.0 when sharing slows every stream equally."""
        x = np.array([s.solo_latency_s / s.latency_s for s in self.streams])
        if not len(x) or not x.sum():
            return 0.0
        return float(x.sum() ** 2 / (len(x) * (x ** 2).sum()))


def partition_pods(num_pods: int, macs: np.ndarray) -> np.ndarray:
    """Power-of-two pod shares proportional to per-stream MACs.

    Every stream gets at least one pod; shares are floored to powers of two
    (pod groups stay butterfly-alignable) and the largest share is halved
    until the partition fits. Raises when there are more streams than pods
    (time-mux is the right policy there).
    """
    macs = np.asarray(macs, dtype=np.float64)
    if len(macs) > num_pods:
        raise ValueError(
            f"{len(macs)} streams > {num_pods} pods: space-sharing cannot "
            "give every stream a pod; use the time-mux policy")
    shares = np.maximum(1.0, macs / macs.sum() * num_pods)
    pods = 2 ** np.floor(np.log2(shares)).astype(np.int64)
    while pods.sum() > num_pods:
        i = int(np.argmax(pods))
        pods[i] //= 2
    return pods


# ---------------------------------------------------------------------------
# batched planner
# ---------------------------------------------------------------------------


def _stream_names(mix: TenantMix) -> list[tuple[str, int]]:
    return [(t.name, i) for t in mix.tenants for i in range(t.replicas)]


def _stream_slos(mix: TenantMix) -> list[float | None]:
    return [t.slo_latency_s for t in mix.tenants for _ in range(t.replicas)]


def plan_time_mux(
    mixes: list[TenantMix],
    designs: list[Design],
    tdp: float = 400.0,
) -> list[list[TenancyPlan]]:
    """The batched time-multiplexed planner: one `analyze_batch` call for
    the whole (designs x mixes) grid, merged co-schedules and solo
    baselines packed side by side. Returns plans indexed [design][mix]."""
    solos = solo_workloads(mixes)
    solo_names = sorted(solos)
    n_mix = len(mixes)
    # one packed suite: mixes first, then the distinct solo traces
    suite = {m.name: m.merged() for m in mixes}
    suite.update({f"solo/{n}": solos[n] for n in solo_names})
    packed = pack_workloads(suite)
    dv = build_design_vector(designs, tdp)
    batch = analyze_batch(packed, dv)

    solo_col = {n: n_mix + i for i, n in enumerate(solo_names)}
    clock = dv.clock_hz
    seg_starts = packed.wl_seg_starts
    # per-mix stream bookkeeping is design-invariant — hoist it
    mix_streams = [list(zip(_stream_names(mix), tenant_depths(mix),
                            _stream_slos(mix))) for mix in mixes]

    out: list[list[TenancyPlan]] = []
    for p in range(dv.num_points):
        row: list[TenancyPlan] = []
        pods = int(dv.num_pods[p])
        pe = int(dv.rows[p] * dv.cols[p])
        peak_tops = float(batch.peak_tops_at_tdp[p])
        for m, mix in enumerate(mixes):
            s0 = int(seg_starts[m])
            slice_cyc = float(batch.cycles_per_tile[p, m])
            lvl = batch.level_slices[p]
            reports = []
            for (tname, si), depth, slo in mix_streams[m]:
                lat_cyc = float(lvl[s0:s0 + depth].sum()) * slice_cyc
                solo_cyc = float(batch.total_cycles[p, solo_col[tname]])
                reports.append(TenantReport(
                    tenant=tname, stream=si,
                    latency_s=lat_cyc / clock,
                    solo_latency_s=solo_cyc / clock,
                    slo_latency_s=slo, pods=pods))
            seq_cycles = sum(
                float(batch.total_cycles[p, solo_col[t]])
                for (t, _), _, _ in mix_streams[m])
            total_macs = float(batch.total_macs[m])
            util_seq = total_macs / (pods * pe * seq_cycles) \
                if seq_cycles else 0.0
            row.append(TenancyPlan(
                mix=mix.name, policy=TIME_MUX,
                rows=int(dv.rows[p]), cols=int(dv.cols[p]), num_pods=pods,
                interconnect=designs[p][2],
                makespan_s=float(batch.total_cycles[p, m]) / clock,
                utilization=float(batch.utilization[p, m]),
                effective_tops_at_tdp=float(
                    batch.effective_tops_at_tdp[p, m]),
                sequential_effective_tops=peak_tops * util_seq,
                streams=tuple(reports)))
        out.append(row)
    return out


def plan_space_share(
    mixes: list[TenantMix],
    designs: list[Design],
    tdp: float = 400.0,
) -> list[list[TenancyPlan]]:
    """The batched space-shared planner: every (design, mix, stream)
    partition plus every full-machine solo baseline evaluated in one
    `analyze_batch` over an expanded DesignVector. Returns [design][mix]."""
    solos = solo_workloads(mixes)
    solo_names = sorted(solos)
    solo_col = {n: i for i, n in enumerate(solo_names)}
    packed = pack_workloads({n: solos[n] for n in solo_names})

    base = build_design_vector(designs, tdp)   # pod counts may be isopower
    # per-mix stream bookkeeping is design-invariant — hoist it
    mix_streams = [list(zip(_stream_names(mix), _stream_slos(mix)))
                   for mix in mixes]
    mix_macs = [np.array([t.macs / t.replicas
                          for t in mix.tenants
                          for _ in range(t.replicas)], dtype=np.float64)
                for mix in mixes]
    rows_ex: list[Design] = []
    cell: dict[tuple[int, int, int], int] = {}  # (p, m, stream) -> row
    parts: dict[tuple[int, int], np.ndarray] = {}
    for p, d in enumerate(designs):
        pods_full = int(base.num_pods[p])
        for m, mix in enumerate(mixes):
            pods_t = partition_pods(pods_full, mix_macs[m])
            parts[(p, m)] = pods_t
            for s, np_t in enumerate(pods_t):
                cell[(p, m, s)] = len(rows_ex)
                rows_ex.append((d[0], d[1], d[2], int(np_t)))
    full_row0 = len(rows_ex)
    rows_ex.extend((d[0], d[1], d[2], int(base.num_pods[p]))
                   for p, d in enumerate(designs))

    dv = build_design_vector(rows_ex, tdp)
    batch = analyze_batch(packed, dv)
    clock = dv.clock_hz

    out: list[list[TenancyPlan]] = []
    for p, d in enumerate(designs):
        row: list[TenancyPlan] = []
        pods_full = int(base.num_pods[p])
        pe = int(base.rows[p] * base.cols[p])
        fp = full_row0 + p
        peak_tops = float(batch.peak_tops_at_tdp[fp])
        for m, mix in enumerate(mixes):
            pods_t = parts[(p, m)]
            reports = []
            lat_cycles = []
            for s, ((tname, si), slo) in enumerate(mix_streams[m]):
                r_ = cell[(p, m, s)]
                w = solo_col[tname]
                lat = float(batch.total_cycles[r_, w])
                solo_cyc = float(batch.total_cycles[fp, w])
                lat_cycles.append(lat)
                reports.append(TenantReport(
                    tenant=tname, stream=si, latency_s=lat / clock,
                    solo_latency_s=solo_cyc / clock,
                    slo_latency_s=slo, pods=int(pods_t[s])))
            makespan = max(lat_cycles)
            total_macs = float(mix.total_macs)
            util = total_macs / (pods_full * pe * makespan)
            seq_cycles = sum(float(batch.total_cycles[fp, solo_col[t]])
                             for (t, _), _ in mix_streams[m])
            util_seq = total_macs / (pods_full * pe * seq_cycles)
            row.append(TenancyPlan(
                mix=mix.name, policy=SPACE_SHARE,
                rows=d[0], cols=d[1], num_pods=pods_full,
                interconnect=d[2],
                makespan_s=makespan / clock,
                utilization=util,
                effective_tops_at_tdp=peak_tops * util,
                sequential_effective_tops=peak_tops * util_seq,
                streams=tuple(reports)))
        out.append(row)
    return out


def plan_mixes(
    mixes: list[TenantMix],
    designs: list[Design],
    policy: str = TIME_MUX,
    tdp: float = 400.0,
) -> list[list[TenancyPlan]]:
    """Plan every (design, mix) cell under one policy; [design][mix]."""
    if policy == TIME_MUX:
        return plan_time_mux(mixes, designs, tdp)
    if policy == SPACE_SHARE:
        return plan_space_share(mixes, designs, tdp)
    raise ValueError(f"unknown policy {policy!r}")


# ---------------------------------------------------------------------------
# scalar oracle (pure-Python merge_workloads + analyze_scalar)
# ---------------------------------------------------------------------------


def _wave_levels(gemms, accel: AcceleratorConfig,
                 interconnect: str,
                 faulty_pods: int = 0) -> tuple[list[float], float]:
    """(per-level wave counts, service cycles per slice) of the analytical
    model — analyze_scalar's inner loop, exposed so the oracle can cumulate
    per-stream completion and un-truncated float totals (the batched path
    keeps cycles as floats; SimResult.total_cycles is int-truncated).

    faulty_pods shrinks the wave width only (survivor count); the fabric
    spec stays full-machine, so latency is monotone in masked pods."""
    arr = accel.array
    r, c = arr.rows, arr.cols
    eff_pods = (accel.num_pods - faulty_pods) * icn_efficiency(interconnect)

    level_slices: list[float] = []
    total_tiles = 0
    k_sum = 0.0
    for level in _levels(gemms):
        pod_slices = 0.0
        crit = 0.0
        for g in level:
            n_i, n_j, n_l = tile_counts(g.d1, g.d2, g.d3, r, c, None)
            pod_slices += n_i * n_j * n_l
            crit = max(crit, n_j)
            total_tiles += n_i * n_j * n_l
            k_sum += n_i * n_j * n_l * (g.d1 / n_i)
        level_slices.append(max(crit, pod_slices / eff_pods))
    k_bar = (k_sum / total_tiles) if total_tiles else r
    return level_slices, _slice_cycles(accel, interconnect, k_bar)


def _scalar_float_cycles(gemms, accel: AcceleratorConfig,
                         interconnect: str, faulty_pods: int = 0) -> float:
    """Un-truncated total cycles of the wave model (matches the batched
    engine's float total_cycles to rounding error)."""
    level_slices, slice_cyc = _wave_levels(gemms, accel, interconnect,
                                           faulty_pods=faulty_pods)
    return sum(level_slices) * slice_cyc


def predict_latency_s(gemms, design: Design, tdp: float = 400.0,
                      faulty_pods: int = 0) -> float:
    """Wave-model service latency (seconds) of one GEMM stream on one
    design point — the per-request *prediction hook* the serving admission
    controller uses (serve/admission.py). Same math as a TenantReport's
    `latency_s` for a solo stream: un-truncated float cycles of the
    analytical wave model over the stream's levels, divided by the design
    clock. The admission controller feeds it `tenancy.trace.request_gemms`
    streams, so `slo_attainment`'s met/missed accounting finally drives
    admit/shed decisions instead of only reporting them.

    ``faulty_pods`` prices the stream on the degraded array (that many
    pods masked out of the wave width, core/simulator `faulty_pods`
    semantics; the fabric spec and isopower normalization keep
    full-machine geometry): latency rises monotonically as capacity
    falls, so the slo-aware admission policy sheds load proportionally
    to the lost pods."""
    rows, cols, icn, pods = design
    if not 0 <= int(faulty_pods) < pods:
        raise ValueError(f"faulty_pods must be in [0, {pods}), "
                         f"got {faulty_pods}")
    accel = build_accel(rows, cols, icn, tdp, pods)
    return _scalar_float_cycles(list(gemms), accel, icn,
                                faulty_pods=int(faulty_pods)) / \
        accel.array.clock_hz


def plan_mix_scalar(
    mix: TenantMix,
    design: Design,
    tdp: float = 400.0,
) -> TenancyPlan:
    """Time-mux plan for one (design, mix) cell through the scalar path —
    the independent merge_workloads + wave-model oracle the batched
    planner is tested against. Every field derives from ONE per-level
    pass over the merged trace (plus one per solo baseline), so the plan
    is internally consistent by construction."""
    rows, cols, icn, pods = design
    accel = build_accel(rows, cols, icn, tdp, pods)
    clock = accel.array.clock_hz
    merged_gemms = mix.merged()
    level_slices, slice_cyc = _wave_levels(merged_gemms, accel, icn)
    makespan_cycles = sum(level_slices) * slice_cyc
    total_macs = sum(g.macs for g in merged_gemms)
    num_pe = accel.num_pods * accel.array.num_pe
    util = total_macs / (num_pe * makespan_cycles)

    solo_cycles = {t.name: _scalar_float_cycles(list(t.gemms), accel, icn)
                   for t in mix.tenants}
    reports = []
    for (tname, si), slo, depth in zip(_stream_names(mix),
                                       _stream_slos(mix),
                                       tenant_depths(mix)):
        lat = sum(level_slices[:depth]) * slice_cyc
        reports.append(TenantReport(
            tenant=tname, stream=si, latency_s=lat / clock,
            solo_latency_s=solo_cycles[tname] / clock,
            slo_latency_s=slo, pods=accel.num_pods))
    seq_cycles = sum(solo_cycles[t] for t, _ in _stream_names(mix))
    util_seq = total_macs / (num_pe * seq_cycles)
    return TenancyPlan(
        mix=mix.name, policy=TIME_MUX,
        rows=rows, cols=cols, num_pods=accel.num_pods, interconnect=icn,
        makespan_s=makespan_cycles / clock,
        utilization=util,
        effective_tops_at_tdp=accel.peak_ops_at_tdp * util / 1e12,
        sequential_effective_tops=accel.peak_ops_at_tdp * util_seq / 1e12,
        streams=tuple(reports))
