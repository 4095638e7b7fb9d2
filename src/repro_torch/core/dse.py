# Copy of src/repro/core/dse.py (the port imports nothing of repro).
"""Design-space exploration for array granularity (SOSA §3.1, Fig 5, Table 2).

Isopower sweep: for every candidate (rows, cols) the pod count is the
largest power of two under the 400 W TDP (arrays.max_pods_under_tdp), and
the score is effective throughput @ TDP — peak(isopower) x utilization —
averaged over the workload suite weighted equally per benchmark.

Batched engine
--------------
The sweep is evaluated by the batched analytical engine: the whole
(rows x cols x interconnect x workload) grid goes through ONE call of
`simulator.analyze_batch` over a `DesignGrid` (vectorized accelerator
construction, below) and a `PackedWorkloads` (flat per-GEMM arrays).

  * `evaluate_grid(workloads, designs)` — the core batched entry point:
    `designs` is a list of (rows, cols, interconnect, num_pods-or-None)
    tuples; returns one DsePoint per design, each averaged over the suite.
  * `sweep(...)` — the Fig-5 grid, built as a designs list and routed
    through `evaluate_grid`. `sweep_scalar(...)` keeps the original
    per-point Python loop for parity tests and speedup benchmarks
    (benchmarks/dse_map.py reports the ratio).
  * `evaluate_design(...)` / `table2_rows(...)` — thin wrappers over
    `evaluate_grid` (single point / the paper's six Table-2 points, which
    mix interconnects across points — the grid handles that).

The batched path is validated against the scalar path property-based in
tests/test_dse_batch.py, and the analytical model against the
slice-accurate scheduler in tests/test_simulator.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .arrays import (ACT_BYTES, CLOCK_HZ, E_MAC_PJ, E_SRAM_PJ_PER_BYTE,
                     OPS_PER_MAC, PSUM_BYTES, TDP_WATTS, WEIGHT_BYTES,
                     ArrayConfig, AcceleratorConfig, max_pods_under_tdp)
from .interconnect import icn_stage_mw_arrays
from .simulator import (DesignVector, PackedWorkloads, analyze_batch,
                        analyze_scalar, icn_efficiency, pack_workloads)
from .tiling import GemmSpec

# a design is (rows, cols, interconnect, num_pods or None for isopower)
Design = tuple[int, int, str, "int | None"]


@dataclasses.dataclass
class DsePoint:
    rows: int
    cols: int
    num_pods: int
    peak_tops_at_tdp: float
    utilization: float
    effective_tops_at_tdp: float
    effective_tops_per_watt: float


def build_accel(rows: int, cols: int, interconnect: str = "butterfly-2",
                tdp: float = 400.0, num_pods: int | None = None) -> AcceleratorConfig:
    arr = ArrayConfig(rows=rows, cols=cols)
    if num_pods is None:
        # first pass with the 256-port mW/B, then refine for actual count
        mw = _mw_per_byte(interconnect, 256)
        num_pods = max_pods_under_tdp(arr, mw, tdp)
    mw = _mw_per_byte(interconnect, max(2, num_pods))
    return AcceleratorConfig(array=arr, num_pods=num_pods,
                             icn_mw_per_byte=mw if num_pods > 1 else 0.0,
                             tdp_watts=tdp)


def _mw_per_byte(interconnect: str, ports: int) -> float:
    from .simulator import icn_spec_for
    return icn_spec_for(interconnect, ports).mw_per_byte


# ---------------------------------------------------------------------------
# vectorized accelerator construction (build_accel over a designs list)
# ---------------------------------------------------------------------------


def build_design_vector(designs: list[Design],
                        tdp: float = TDP_WATTS) -> DesignVector:
    """`build_accel` + the AcceleratorConfig power/throughput properties,
    vectorized over a designs list — matches the scalar constructors
    element-for-element (same pod-count selection, same isopower peak)."""
    rows = np.array([d[0] for d in designs], dtype=np.int64)
    cols = np.array([d[1] for d in designs], dtype=np.int64)
    icns = [d[2] for d in designs]
    pods_in = [d[3] for d in designs]

    # per-pod power: PEs + SRAM edge traffic (arrays.ArrayConfig properties:
    # acts in (r) + psums in/out (2x2c) + weight prefetch (c))
    edge_bytes = (rows * ACT_BYTES + cols * PSUM_BYTES * 2
                  + cols * WEIGHT_BYTES).astype(np.float64)
    pod_watts = (rows * cols * E_MAC_PJ + edge_bytes * E_SRAM_PJ_PER_BYTE) \
        * 1e-12 * CLOCK_HZ

    num_pods = np.zeros(len(designs), dtype=np.int64)
    icn_mw = np.zeros(len(designs), dtype=np.float64)      # for peak power
    energy_mw = np.zeros(len(designs), dtype=np.float64)   # for energy model
    stages = np.zeros(len(designs), dtype=np.int64)
    eff = np.zeros(len(designs), dtype=np.float64)

    icns_arr = np.array(icns)
    for name in set(icns):
        m = icns_arr == name
        # pod count: explicit, or the largest power of two under TDP using
        # the 256-port mW/B first pass (as build_accel does)
        _, mw0 = icn_stage_mw_arrays(name, np.full(int(m.sum()), 256))
        per_pod = pod_watts[m] + edge_bytes[m] * mw0 * 1e-3
        n = np.maximum(1, np.floor_divide(tdp, per_pod)).astype(np.int64)
        n = 2 ** (np.frexp(n.astype(np.float64))[1] - 1)   # power-of-two floor
        explicit = np.array([p is not None for p in pods_in])[m]
        given = np.array([p if p is not None else 1 for p in pods_in],
                         dtype=np.int64)[m]
        pods = np.where(explicit, given, n)
        num_pods[m] = pods

        ports = np.maximum(2, pods)
        st, mw = icn_stage_mw_arrays(name, ports)
        stages[m] = st
        energy_mw[m] = mw
        icn_mw[m] = np.where(pods > 1, mw, 0.0)            # monolithic: no icn
        eff[m] = icn_efficiency(name)

    peak_watts = pod_watts * num_pods + edge_bytes * num_pods * icn_mw * 1e-3
    peak_ops = rows * cols * OPS_PER_MAC * CLOCK_HZ * num_pods
    defaults = ArrayConfig()  # multicast/fan-in degrees (§4.1)
    pipeline = (-(-rows // defaults.multicast_u)
                + (-(-cols // defaults.fanin_v))).astype(np.int64)

    return DesignVector(
        rows=rows, cols=cols, num_pods=num_pods,
        pipeline_latency=pipeline,
        peak_ops_at_tdp=peak_ops * (tdp / peak_watts),
        icn_stages=stages, icn_energy_mw=energy_mw, icn_eff=eff,
        clock_hz=CLOCK_HZ,
    )


def evaluate_grid(
    workloads: dict[str, list[GemmSpec]] | PackedWorkloads,
    designs: list[Design],
    tdp: float = TDP_WATTS,
    k_part: int | np.ndarray | None = None,
) -> list[DsePoint]:
    """Batched DSE: every design x every workload in one analyze_batch call,
    reduced to one equal-weight DsePoint per design (Table-2 averaging)."""
    dv = build_design_vector(designs, tdp)
    if isinstance(workloads, PackedWorkloads):
        packed = workloads
        n_wl = packed.num_workloads
    else:
        # empty workloads contribute zero metrics but still count in the
        # equal-weight average, exactly like the scalar path
        nonempty = {name: wl for name, wl in workloads.items() if wl}
        n_wl = len(workloads)
        packed = pack_workloads(nonempty) if nonempty else None
    if packed is None:
        return [
            DsePoint(rows=int(dv.rows[p]), cols=int(dv.cols[p]),
                     num_pods=int(dv.num_pods[p]),
                     peak_tops_at_tdp=float(dv.peak_ops_at_tdp[p] / 1e12),
                     utilization=0.0, effective_tops_at_tdp=0.0,
                     effective_tops_per_watt=0.0)
            for p in range(dv.num_points)
        ]
    batch = analyze_batch(packed, dv, k_part=k_part)
    denom = max(1, n_wl)
    util = batch.utilization.sum(axis=1) / denom
    eff = batch.effective_tops_at_tdp.sum(axis=1) / denom
    tpw = batch.effective_tops_per_watt.sum(axis=1) / denom
    return [
        DsePoint(
            rows=int(dv.rows[p]), cols=int(dv.cols[p]),
            num_pods=int(dv.num_pods[p]),
            peak_tops_at_tdp=float(batch.peak_tops_at_tdp[p]),
            utilization=float(util[p]),
            effective_tops_at_tdp=float(eff[p]),
            effective_tops_per_watt=float(tpw[p]),
        )
        for p in range(dv.num_points)
    ]


# ---------------------------------------------------------------------------
# public sweep API (batched), with the scalar path kept for validation
# ---------------------------------------------------------------------------


def evaluate_design(
    rows: int, cols: int,
    workloads: dict[str, list[GemmSpec]],
    interconnect: str = "butterfly-2",
    tdp: float = 400.0,
    num_pods: int | None = None,
) -> DsePoint:
    """One design point — thin wrapper over the batched engine."""
    return evaluate_grid(workloads, [(rows, cols, interconnect, num_pods)],
                         tdp)[0]


def evaluate_design_scalar(
    rows: int, cols: int,
    workloads: dict[str, list[GemmSpec]],
    interconnect: str = "butterfly-2",
    tdp: float = 400.0,
    num_pods: int | None = None,
) -> DsePoint:
    """Original per-workload Python loop over `analyze_scalar`; the oracle
    the batched path is property-tested against (tests/test_dse_batch.py)."""
    accel = build_accel(rows, cols, interconnect, tdp, num_pods)
    # equal-weight average across benchmarks (Table 2 averages the ten
    # benchmarks; ops-weighting would let BERT-large dominate and shift
    # the optimum toward large arrays)
    n = 0
    eff_sum = 0.0
    util_sum = 0.0
    tpw_sum = 0.0
    for name, gemms in workloads.items():
        res = analyze_scalar(gemms, accel, interconnect, name=name)
        n += 1
        util_sum += res.utilization
        eff_sum += res.effective_tops_at_tdp
        tpw_sum += res.effective_tops_per_watt
    n = max(1, n)
    return DsePoint(
        rows=rows, cols=cols, num_pods=accel.num_pods,
        peak_tops_at_tdp=accel.peak_ops_at_tdp / 1e12,
        utilization=util_sum / n,
        effective_tops_at_tdp=eff_sum / n,
        effective_tops_per_watt=tpw_sum / n,
    )


_DEFAULT_ROWS = (8, 16, 20, 32, 48, 64, 66, 128, 256, 512)
_DEFAULT_COLS = (8, 16, 32, 64, 128, 256, 512)


def sweep(
    workloads: dict[str, list[GemmSpec]],
    row_candidates: tuple[int, ...] = _DEFAULT_ROWS,
    col_candidates: tuple[int, ...] = _DEFAULT_COLS,
    interconnect: str = "butterfly-2",
    tdp: float = 400.0,
) -> list[DsePoint]:
    """Fig-5 isopower grid through the batched engine (one call)."""
    designs: list[Design] = [(r, c, interconnect, None)
                             for r in row_candidates for c in col_candidates]
    return evaluate_grid(workloads, designs, tdp)


def sweep_scalar(
    workloads: dict[str, list[GemmSpec]],
    row_candidates: tuple[int, ...] = _DEFAULT_ROWS,
    col_candidates: tuple[int, ...] = _DEFAULT_COLS,
    interconnect: str = "butterfly-2",
    tdp: float = 400.0,
) -> list[DsePoint]:
    """The original double loop (one analyze_scalar per point x workload)."""
    out = []
    for r in row_candidates:
        for c in col_candidates:
            out.append(evaluate_design_scalar(r, c, workloads, interconnect,
                                              tdp))
    return out


def best_point(points: list[DsePoint]) -> DsePoint:
    return max(points, key=lambda p: p.effective_tops_at_tdp)


TABLE2_DESIGNS: tuple[tuple[int, int, int], ...] = (
    (512, 512, 1), (256, 256, 8), (128, 128, 32),
    (64, 64, 128), (16, 16, 512), (32, 32, 256),
)


def table2_rows(workloads: dict[str, list[GemmSpec]],
                tdp: float = 400.0) -> list[DsePoint]:
    """The paper's Table 2 design points (monolithic 512x512 ... 32x32),
    evaluated batched — the grid mixes interconnects across points
    (butterfly-2 pods vs a crossbar-fed monolithic)."""
    designs: list[Design] = [
        (r, c, "butterfly-2" if pods > 1 else "crossbar", pods)
        for (r, c, pods) in TABLE2_DESIGNS
    ]
    return evaluate_grid(workloads, designs, tdp)
