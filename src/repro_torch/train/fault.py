# Copy of src/repro/train/fault.py (the port imports nothing of repro).
"""Fault tolerance & elasticity manager (1000+-node posture).

What runs where:
  * checkpoint/restart  — checkpoint.py (atomic commit, newest-COMMITTED
    restore); the train loop (launch/train.py) saves every N steps and
    resumes from the newest checkpoint, with the data stream keyed by step
    so no batch is skipped or repeated.
  * failure detection   — `Heartbeat`: hosts stamp a monotonically
    increasing step; a host silent for `timeout_steps` is declared dead.
    (On a real fleet this is the TPU runtime's health service; the object
    boundary is identical.)
  * elastic re-mesh     — `ElasticMesh.next_mesh()`: on failure, fall back
    to the largest power-of-two slice of surviving hosts and rebuild the
    (pod, data, model) mesh; TP degree is preserved (model-parallel groups
    must stay intact — a dead host kills its whole TP group), DP shrinks.
    Global batch is preserved by raising grad-accum microbatches — the same
    math, fewer chips (and the SOSA tiling argument says utilization holds
    as long as #tiles >= #pods, which shrinking pods only helps).
  * straggler mitigation — `StragglerPolicy`: per-step duration EWMA; a
    host slower than `slow_factor` x median for `patience` steps is evicted
    like a failure (re-mesh without it). This mirrors the SOSA scheduler's
    slice re-assignment: work is slice-shaped and owner-agnostic, so
    eviction costs one checkpoint restore, not a cold start.

`Ewma` is the shared smoothing primitive: StragglerPolicy tracks one per
host, and the serving chaos harness (serve/chaos.py) reuses it for
slow-decode-chunk detection — same strike/patience discipline, one
implementation.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional


@dataclasses.dataclass
class Ewma:
    """Exponentially weighted moving average with a first-sample seed.

    ``observe`` folds a sample in and returns the updated average; before
    any sample, ``value`` is None (callers treat the stream as unwarmed
    rather than biased toward 0).
    """

    alpha: float = 0.3
    value: Optional[float] = None

    def observe(self, sample: float) -> float:
        self.value = float(sample) if self.value is None else \
            (1.0 - self.alpha) * self.value + self.alpha * float(sample)
        return self.value


@dataclasses.dataclass
class Heartbeat:
    num_hosts: int
    timeout_steps: int = 3
    _last_step: dict = dataclasses.field(default_factory=dict)

    def beat(self, host: int, step: int) -> None:
        self._last_step[host] = step

    def dead_hosts(self, current_step: int) -> list[int]:
        return [h for h in range(self.num_hosts)
                if current_step - self._last_step.get(h, -1)
                > self.timeout_steps]


@dataclasses.dataclass
class StragglerPolicy:
    slow_factor: float = 2.0
    patience: int = 3
    _ewma: dict = dataclasses.field(default_factory=dict)
    _strikes: dict = dataclasses.field(default_factory=dict)

    def observe(self, host: int, step_seconds: float) -> None:
        self._ewma.setdefault(host, Ewma(alpha=0.3)).observe(step_seconds)

    def stragglers(self) -> list[int]:
        if len(self._ewma) < 2:
            return []
        vals = sorted(e.value for e in self._ewma.values())
        med = vals[len(vals) // 2]
        out = []
        for h, e in self._ewma.items():
            if e.value > self.slow_factor * med:
                self._strikes[h] = self._strikes.get(h, 0) + 1
                if self._strikes[h] >= self.patience:
                    out.append(h)
            else:
                self._strikes[h] = 0
        return out


@dataclasses.dataclass
class ElasticMesh:
    """Tracks healthy hosts; yields the mesh shape to rebuild with."""
    total_hosts: int
    tp_degree: int                      # model-parallel ways (kept intact)
    hosts_per_pod: int
    healthy: Optional[set] = None

    def __post_init__(self):
        if self.healthy is None:
            self.healthy = set(range(self.total_hosts))

    def fail(self, host: int) -> None:
        self.healthy.discard(host)

    def next_mesh(self) -> dict:
        """Largest power-of-two surviving slice, TP preserved."""
        n = len(self.healthy)
        usable = 2 ** int(math.floor(math.log2(max(1, n))))
        # chips = hosts (abstracted 1:1 here); DP ways shrink, TP fixed
        dp = max(1, usable // self.tp_degree)
        pods = max(1, dp // max(1, self.hosts_per_pod // self.tp_degree))
        return {"pod": min(pods, 2), "data": dp // min(pods, 2),
                "model": self.tp_degree}

    def microbatch_scale(self, original_dp: int) -> int:
        """Grad-accum factor to keep the global batch constant."""
        new_dp = self.next_mesh()["pod"] * self.next_mesh()["data"]
        return max(1, original_dp // new_dp)
