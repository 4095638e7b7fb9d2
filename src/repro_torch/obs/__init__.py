# Copy of src/repro/obs/__init__.py (the port imports nothing of repro).
"""Serving observability layer: metrics registry, Perfetto trace export,
and model-vs-measured drift tracking.

The paper's headline metric is *effective* throughput/Watt — throughput
adjusted for array utilization — so observability is a first-class
subsystem here, not an afterthought:

  * `obs.metrics`  — labeled counters/gauges/histograms (zero deps), the
    registry `ServeEngine(metrics=...)` and the kernel autotuner report
    into; snapshot/export API.
  * `obs.export`   — spans -> Chrome trace-event / Perfetto JSON, so an
    engine run opens in a trace viewer.
  * `obs.drift`    — per-phase predicted-vs-measured drift rows (wave
    model vs slice-accurate scheduler on the engine's recorded timeline)
    and the live effective-TOPS gauge (measured tokens/s x tile
    utilization).

Every future perf PR is measured against the `obs/` benchmark suite
(benchmarks/obs.py) these build.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      registry)
from .export import Span, to_chrome_trace, write_chrome_trace  # noqa: F401

# obs.drift pulls in the tenancy bridge (which itself imports obs.export),
# so its names resolve lazily — importing repro.tenancy.trace first must
# not re-enter a half-initialized obs.drift.
_DRIFT_NAMES = ("DEFAULT_DESIGN", "EffectiveTops", "PhaseDrift",
                "drift_report", "effective_tops_summary")


def __getattr__(name):
    if name in _DRIFT_NAMES:
        from . import drift
        return getattr(drift, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
