# Copy of src/repro/serve/chaos.py (the port imports nothing of repro).
"""Deterministic fault injection for the serving hot loop.

Robustness claims ("sheds load, honors deadlines, never wedges or leaks
slots") are only testable if failure is reproducible. This module injects
a *seeded* failure schedule into the engines' device-call boundary:

  * **Transient device errors** — a call site drawn faulty raises
    `TransientDeviceError` for `transient_tries` consecutive attempts,
    then succeeds; the engine retries with exponential backoff
    (`ServeEngine(max_retries=...)`). Retries exhausted escalates to
    `PermanentFault` and the engine finalizes the affected requests as
    ``rejected`` (reason ``device-fault``) without leaking their slots.
  * **Slow chunks / prefills** — a call drawn slow stalls for
    `slow_factor x` the nominal service time before running. Paired with
    the EWMA slow-chunk detector below (train/fault.py's `Ewma`, the
    StragglerPolicy discipline at chunk granularity), the engine halves
    its next decode chunk when flagged, so deadline checks tighten
    exactly when the device degrades.
  * **Virtual time** — all injection acts on the engine's injectable
    clock. With `VirtualClock`, time only advances when the harness says
    so (`service_seconds` per device call, `slow_factor` on slow draws,
    backoff on retries), making deadline expiry, EWMA detection, and
    backoff schedules exactly reproducible on any box.

The schedule is a pure function of ``(seed, kind, call_index)`` — two runs
with the same config see byte-identical fault sequences regardless of
timing, retries, or host load.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from ..train.fault import Ewma


class TransientDeviceError(RuntimeError):
    """An injected, retryable device failure (the XLA 'transient
    RESOURCE_EXHAUSTED / preempted' class of errors)."""


class PermanentFault(RuntimeError):
    """Retries exhausted on one device call; the engine shelves the
    affected requests and keeps serving everyone else."""


class SilentCorruption(RuntimeError):
    """The PodGuard detected corruption it could not repair in-graph
    (multi-element hit under abft, or any detection under the
    detect-only probe mode). Retryable like TransientDeviceError —
    recompute usually clears a transient flip — but retries exhausted
    finalize the affected requests as ``rejected`` with terminal reason
    ``sdc-uncorrectable`` instead of escalating to PermanentFault."""


class NumericalFault(RuntimeError):
    """Non-finite logits (NaN/Inf) surfaced in one or more lanes. Not
    retryable: the forward pass is deterministic, so recompute returns
    the same poison — the engine rejects exactly the affected lanes
    (terminal reason ``non-finite-logits``) and keeps serving the rest.
    ``lanes`` lists the offending slot indices."""

    def __init__(self, lanes, where: str = "decode"):
        self.lanes = list(lanes)
        self.where = where
        super().__init__(
            f"non-finite logits in {where} lane(s) {self.lanes}")


def check_lanes_finite(bad_lanes, where: str = "decode") -> None:
    """Raise NumericalFault listing every flagged lane; no-op when all
    lanes are finite. ``bad_lanes`` is an iterable of (lane, flagged)
    pairs or a mapping lane -> flagged."""
    if hasattr(bad_lanes, "items"):
        bad_lanes = bad_lanes.items()
    flagged = [lane for lane, bad in bad_lanes if bad]
    if flagged:
        raise NumericalFault(flagged, where)


class VirtualClock:
    """Deterministic manual clock: callable like time.perf_counter, and
    sleeps advance it instead of blocking."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def sleep(self, dt: float) -> None:
        self.advance(dt)


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded failure schedule knobs. Probabilities are per device call,
    drawn independently per (seed, kind, call_index)."""

    seed: int = 0
    p_fault: float = 0.0           # transient-error probability per call
    p_slow: float = 0.0            # slow-call probability per call
    slow_factor: float = 4.0       # stall = (slow_factor-1) x service time
    transient_tries: int = 1       # consecutive failures per faulty site
    service_seconds: float = 0.0   # nominal virtual seconds per call
                                   # (advanced on the engine clock; 0 = off)
    p_sdc: float = 0.0             # silent-corruption probability per call
                                   # (requires a guard-enabled engine)
    sdc_elems: int = 1             # corrupted elements per hit (2+ defeats
                                   # single-corruption ABFT -> uncorrectable)
    sdc_magnitude: float = 1e4     # additive corruption magnitude
    sdc_target: int = 0            # which guarded GEMM (trace index) is hit


@dataclasses.dataclass
class SlowChunkDetector:
    """StragglerPolicy's EWMA discipline on the decode-chunk stream: a
    chunk slower per token than `slow_factor x` the EWMA baseline earns a
    strike; `patience` consecutive strikes flags the device as degraded
    (the engine reacts by halving the next chunk). One Ewma, one stream —
    the serving-side sibling of train.fault.StragglerPolicy."""

    slow_factor: float = 2.0
    patience: int = 2
    ewma: Ewma = dataclasses.field(default_factory=lambda: Ewma(alpha=0.3))
    strikes: int = 0
    flagged_chunks: int = 0

    def observe(self, seconds_per_token: float) -> bool:
        """Fold one chunk's per-token seconds in; True when the slow
        streak has exhausted patience (the mitigation trigger)."""
        baseline = self.ewma.value
        slow = baseline is not None and \
            seconds_per_token > self.slow_factor * baseline
        if slow:
            self.strikes += 1
            # a slow sample does NOT pollute the baseline: the EWMA tracks
            # healthy service time, the thing slowness is measured against
        else:
            self.strikes = 0
            self.ewma.observe(seconds_per_token)
        if slow and self.strikes >= self.patience:
            self.flagged_chunks += 1
            return True
        return False


class FaultInjector:
    """The seeded schedule, evaluated at the engine's device-call
    boundary. The engine calls `before(kind)` inside its retry loop:
    it may stall the clock (slow draw / nominal service time) and may
    raise TransientDeviceError (fault draw, for the site's first
    `transient_tries` attempts)."""

    def __init__(self, config: ChaosConfig, clock=None):
        self.config = config
        self.clock = clock
        self._calls: dict[str, int] = {}       # kind -> next call index
        self._pending_tries: dict[tuple[str, int], int] = {}
        self._sdc_calls: dict[str, int] = {}   # kind -> next SDC site index
        self._pending_sdc: dict[tuple[str, int], list] = {}
        self.injected = {"faults": 0, "slow": 0, "calls": 0, "sdc": 0}

    def _draw(self, kind: str, index: int) -> random.Random:
        # seed with a STRING: random.Random hashes str/bytes stably
        # (sha512-based), while tuples go through hash(), which is
        # randomized per process for the embedded str — the schedule must
        # be byte-identical across runs and boxes
        return random.Random(f"{self.config.seed}:{kind}:{index}")

    def _stall(self, seconds: float) -> None:
        if seconds > 0 and self.clock is not None and \
                hasattr(self.clock, "sleep"):
            self.clock.sleep(seconds)

    def before(self, kind: str) -> None:
        """One attempt of one device call of `kind` ("prefill"/"decode").
        A new call site is drawn once; its verdict is replayed across the
        engine's retry attempts so `transient_tries` failures are
        consecutive, then the site heals."""
        site = (kind, self._calls.get(kind, 0))
        tries = self._pending_tries.get(site)
        if tries is None:                      # first attempt: draw fate
            rng = self._draw(kind, site[1])
            faulty = rng.random() < self.config.p_fault
            slow = rng.random() < self.config.p_slow
            tries = self.config.transient_tries if faulty else 0
            self._pending_tries[site] = tries
            self._stall(self.config.service_seconds *
                        (self.config.slow_factor if slow else 1.0))
            self.injected["calls"] += 1
            if slow:
                self.injected["slow"] += 1
        if tries > 0:
            self._pending_tries[site] = tries - 1
            self.injected["faults"] += 1
            raise TransientDeviceError(
                f"injected transient fault ({kind} call {site[1]}, "
                f"{tries - 1} more before heal)")
        # attempt succeeds: the site is consumed
        del self._pending_tries[site]
        self._calls[kind] = site[1] + 1

    def sdc_plan(self, kind: str) -> Optional[tuple[int, int, int]]:
        """One attempt's silent-corruption verdict: an int plan
        ``(target_gemm, draw_seed, n_elems)`` for the guarded GEMM path
        (guard.inject_sdc), or None for a clean attempt.

        Sites mirror the transient discipline: a site drawn corrupt
        replays the SAME plan (same draw_seed) for ``transient_tries``
        consecutive attempts — so the engine's recompute-and-retry sees
        a persistent flip until the site heals — then the next attempt
        runs clean and consumes the site. Unlike `before`, corruption is
        discovered AFTER the call succeeds, so the site is keyed by its
        own per-kind counter that only advances on a clean attempt."""
        if self.config.p_sdc <= 0.0:
            return None
        idx = self._sdc_calls.get(kind, 0)
        site = (kind, idx)
        st = self._pending_sdc.get(site)
        if st is None:                         # first attempt: draw fate
            rng = self._draw(f"sdc-{kind}", idx)
            hit = rng.random() < self.config.p_sdc
            st = [self.config.transient_tries if hit else 0,
                  rng.randrange(1 << 31)]
            self._pending_sdc[site] = st
        if st[0] > 0:
            st[0] -= 1
            self.injected["sdc"] += 1
            return (self.config.sdc_target, st[1], self.config.sdc_elems)
        # clean attempt: the site heals and is consumed
        del self._pending_sdc[site]
        self._sdc_calls[kind] = idx + 1
        return None
