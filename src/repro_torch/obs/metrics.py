# Copy of src/repro/obs/metrics.py (the port imports nothing of repro).
"""Lightweight serving-telemetry metrics registry (zero deps, dict-backed).

The paper's headline metric is *effective* throughput/Watt — throughput
adjusted for array utilization (SOSA §6) — so the serving stack needs live
counters/gauges/histograms it can combine with the kernel layer's
padded-MAC utilization (parallel.autoshard) into an effective-TOPS gauge
(obs/drift.py). Three metric kinds, each a labeled series:

  * Counter   — monotonically increasing float (tokens served, cache hits,
                accumulated wall-clock seconds).
  * Gauge     — last-written value (queue depth, slot occupancy, tok/s).
  * Histogram — raw observations with percentile snapshots (per-token
                wait, decode chunk lengths).

A series is identified by ``(name, labels)``; ``registry.counter("x",
path="bucketed")`` get-or-creates it. ``snapshot()`` returns a plain dict
(JSON-serializable) keyed by the rendered series name ``x{path=bucketed}``
— greppable the same way benchmark ``derived`` fields are.

Design constraint (gated in tests/test_serving.py): recording must be
pure host-side Python — a metric write never touches a device array, so
metrics-on changes no jit cache entries and adds no host syncs.

``registry()`` returns the process-global default registry the kernel
layer records into; subsystems that want isolation (one ``ServeEngine``
per tenant) construct their own ``MetricsRegistry``.
"""

from __future__ import annotations

import dataclasses
import json
import math


def _render(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


def percentile(values: list[float], q: float) -> float:
    """Linear-interpolation percentile (numpy-compatible), q in [0, 100]."""
    if not values:
        return float("nan")
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return float(xs[lo])
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n


@dataclasses.dataclass
class Gauge:
    value: float = 0.0
    _written: bool = False

    def set(self, v: float) -> None:
        self.value = float(v)
        self._written = True


class Histogram:
    """Raw-observation histogram with a bounded buffer.

    Keeps up to ``max_samples`` observations (beyond that, every other
    retained sample is dropped and the stride doubles — a deterministic
    decimation that preserves the spread without unbounded memory); count
    and sum stay exact.
    """

    def __init__(self, max_samples: int = 8192):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: list[float] = []
        self._max_samples = max_samples
        self._stride = 1
        self._skip = 0

    def record(self, v: float, n: int = 1) -> None:
        """Record observation ``v`` (``n`` identical observations at once —
        e.g. a decode chunk charging every delivered token the chunk's
        wall time)."""
        v = float(v)
        self.count += n
        self.total += v * n
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for _ in range(n):
            if self._skip > 0:
                self._skip -= 1
                continue
            self._samples.append(v)
            self._skip = self._stride - 1
            if len(self._samples) >= self._max_samples:
                self._samples = self._samples[::2]
                self._stride *= 2

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        return percentile(self._samples, q)

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Dict-backed labeled-series store; see module docstring."""

    def __init__(self):
        self._series: dict[tuple[str, str, tuple], object] = {}

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, tuple(sorted((k, str(v)) for k, v in
                                        labels.items())))
        metric = self._series.get(key)
        if metric is None:
            metric = self._series[key] = factory()
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels, Histogram)

    def value(self, name: str, **labels) -> float | None:
        """Current value of a counter/gauge series, or None if the series
        was never written (histograms: use ``find``)."""
        key_labels = tuple(sorted((k, str(v)) for k, v in labels.items()))
        for (kind, n, lbl), metric in self._series.items():
            if n == name and lbl == key_labels and kind in ("counter",
                                                            "gauge"):
                return metric.value
        return None

    def find(self, name: str) -> dict[str, object]:
        """All series of ``name`` (any labels), keyed by rendered name."""
        return {_render(n, lbl): m for (kind, n, lbl), m in
                self._series.items() if n == name}

    def clear(self) -> None:
        self._series.clear()

    def __len__(self) -> int:
        return len(self._series)

    def snapshot(self) -> dict:
        """JSON-serializable state: {counters: {...}, gauges: {...},
        histograms: {series: summary}}."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, labels), metric in sorted(self._series.items()):
            key = _render(name, labels)
            if kind == "counter":
                out["counters"][key] = metric.value
            elif kind == "gauge":
                out["gauges"][key] = metric.value
            else:
                out["histograms"][key] = metric.summary()
        return out

    def dumps(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)


_GLOBAL = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global default registry (kernel-layer autotune metrics
    land here; serving engines may pass their own)."""
    return _GLOBAL
