# Copy of src/repro/obs/drift.py (the port imports nothing of repro).
"""Model-vs-measured drift tracking for the serving engine.

The DSE planner (PR 1–2) chooses designs with the analytical wave model
(core.simulator.analyze / analyze_batch); the serving engine executes real
timelines. This module closes the loop per serving phase:

  * `drift_report` lowers the engine's recorded timeline (tenancy/trace.py
    bridge, filtered per phase) and evaluates it through BOTH model paths:
    the wave model (`analyze`, the *predicted* utilization/cycles every
    sweep is built on) and the slice-accurate scheduler (`simulate`, the
    *measured* ground truth with real bank/routing conflicts). The
    per-phase `drift` ratio (predicted/measured utilization) must stay
    inside the calibrated parity bands pinned in tests/test_simulator.py
    (the wave model is up to ~1.55x optimistic on attention-heavy traces)
    — if a future engine change (new fusion shape, new phase structure)
    pushes a serving phase outside the band, the drift row catches it.

  * `effective_tops_summary` is the paper's headline metric, live: the
    engine's measured token throughput (obs metrics counters) converted
    to useful-MAC throughput via the phase's recorded GEMM stream, scaled
    by the kernel autotuner's padded-MAC tile utilization
    (autoshard.tile_utilization gauges) — effective TOPS as SOSA defines
    it (throughput x utilization), directly comparable to the
    `effective_tops_at_tdp` the wave model predicts for the same trace.

Both record their rows as gauges into a metrics registry so the obs/
benchmark suite and live dashboards read one source.
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig
from ..core.dse import build_accel
from ..core.simulator import OPS_PER_MAC, analyze, simulate
from ..tenancy.trace import ServeTraceRecorder, trace_to_gemms
from .metrics import MetricsRegistry, registry as global_registry

# rows, cols, interconnect, pods — a paper-scale design point (Table 2's
# headline granularity) used when the caller doesn't pin one
DEFAULT_DESIGN = (32, 32, "butterfly-2", 64)

PHASES = ("prefill", "decode")


@dataclasses.dataclass(frozen=True)
class PhaseDrift:
    """Predicted (wave model) vs measured (slice-accurate scheduler)
    outcome of one serving phase's recorded GEMM timeline."""

    phase: str
    events: int                      # timeline events lowered
    gemms: int
    predicted_utilization: float     # analyze (wave model)
    measured_utilization: float      # simulate (slice-accurate)
    predicted_cycles: float
    measured_cycles: float
    predicted_effective_tops: float  # @TDP, the DSE ranking metric
    measured_effective_tops: float

    @property
    def drift(self) -> float:
        """Wave-model optimism: predicted / measured utilization. 1.0 =
        perfect agreement; the calibrated ceiling is ~1.55x on
        attention-heavy traces (tests/test_simulator.py)."""
        if not self.measured_utilization:
            return float("inf")
        return self.predicted_utilization / self.measured_utilization


def drift_report(recorder: ServeTraceRecorder, cfg: ArchConfig,
                 design: tuple = DEFAULT_DESIGN, tdp: float = 400.0,
                 max_events_per_phase: int | None = 32,
                 include_attention: bool = True,
                 metrics: MetricsRegistry | None = None
                 ) -> list[PhaseDrift]:
    """Per-phase predicted-vs-measured drift rows for a recorded serving
    run. Phases with no recorded events are skipped (e.g. a prefill-only
    trace). `max_events_per_phase` bounds the slice-accurate scheduler's
    cost on long decode timelines (the drift ratio is a per-phase shape
    property — a bounded prefix measures it)."""
    rows_, cols_, icn, pods = design
    accel = build_accel(rows_, cols_, icn, tdp, pods)
    out: list[PhaseDrift] = []
    for phase in PHASES:
        n_events = sum(1 for e in recorder.events if e[0] == phase)
        if not n_events:
            continue
        gemms = trace_to_gemms(recorder, cfg, kinds=(phase,),
                               include_attention=include_attention,
                               max_events=max_events_per_phase)
        a = analyze(gemms, accel, interconnect=icn)
        s = simulate(gemms, accel, interconnect=icn)
        row = PhaseDrift(
            phase=phase,
            events=min(n_events, max_events_per_phase or n_events),
            gemms=len(gemms),
            predicted_utilization=a.utilization,
            measured_utilization=s.utilization,
            predicted_cycles=float(a.total_cycles),
            measured_cycles=float(s.total_cycles),
            predicted_effective_tops=a.effective_tops_at_tdp,
            measured_effective_tops=s.effective_tops_at_tdp,
        )
        out.append(row)
        # explicit None check: an empty registry is falsy (__len__ == 0)
        # but still the caller's chosen sink
        reg = metrics if metrics is not None else global_registry()
        reg.gauge("obs.drift", phase=phase).set(row.drift)
        reg.gauge("obs.predicted_util", phase=phase).set(
            row.predicted_utilization)
        reg.gauge("obs.measured_util", phase=phase).set(
            row.measured_utilization)
    return out


def _mean_tile_util(reg: MetricsRegistry) -> float:
    """Mean of the kernel autotuner's per-shape padded-MAC utilization
    gauges (1.0 when no kernel shapes were autotuned — e.g. the reference
    einsum backend, whose GEMMs have no pod padding)."""
    gauges = reg.find("autotune.tile_util")
    vals = [g.value for g in gauges.values()]
    return sum(vals) / len(vals) if vals else 1.0


@dataclasses.dataclass(frozen=True)
class EffectiveTops:
    """The live effective-TOPS gauge for one serving phase."""

    phase: str
    tokens: int
    seconds: float
    tok_s: float
    macs_per_token: float          # from the recorded GEMM stream
    tile_utilization: float        # kernel padded-MAC utilization
    measured_tops: float           # useful-MAC throughput, 2 ops/MAC
    effective_tops: float          # measured_tops x tile utilization


def effective_tops_summary(recorder: ServeTraceRecorder, cfg: ArchConfig,
                           metrics: MetricsRegistry,
                           kernel_metrics: MetricsRegistry | None = None,
                           include_attention: bool = True
                           ) -> list[EffectiveTops]:
    """Effective TOPS per serving phase from live telemetry.

    Measured token throughput comes from the engine's obs counters
    (`serve.{prefill,decode}.tokens` / `.seconds` in `metrics`); the
    MACs behind each token come from the recorded GEMM timeline (so fused
    decode lanes and true context lengths are priced exactly); the tile
    utilization comes from the kernel autotuner's gauges (the process-
    global registry unless `kernel_metrics` is passed). Phases without
    recorded time are skipped. Results are recorded back into `metrics`
    as `obs.effective_tops{phase=...}` gauges.
    """
    kreg = kernel_metrics if kernel_metrics is not None else \
        global_registry()
    tile_util = _mean_tile_util(kreg)
    out: list[EffectiveTops] = []
    for phase in PHASES:
        tokens = recorder.phase_tokens(phase)
        seconds = metrics.value(f"serve.{phase}.seconds")
        if not tokens or not seconds:
            continue
        gemms = trace_to_gemms(recorder, cfg, kinds=(phase,),
                               include_attention=include_attention)
        macs = sum(g.macs for g in gemms)
        macs_per_token = macs / tokens
        measured_tops = macs / seconds * OPS_PER_MAC / 1e12
        row = EffectiveTops(
            phase=phase, tokens=tokens, seconds=seconds,
            tok_s=tokens / seconds,
            macs_per_token=macs_per_token,
            tile_utilization=tile_util,
            measured_tops=measured_tops,
            effective_tops=measured_tops * tile_util,
        )
        out.append(row)
        metrics.gauge("obs.effective_tops", phase=phase).set(
            row.effective_tops)
        metrics.gauge("obs.tile_util").set(tile_util)
    return out
