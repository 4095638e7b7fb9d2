# Copy of src/repro/serve/admission.py (the port imports nothing of repro).
"""SLO-aware admission control and overload protection for serving.

The engines (serve/engine.py, serve/reference.py) admit FIFO whenever a
slot frees; at offered load beyond array capacity that policy melts down:
queues grow without bound, every request misses its deadline, and the
effective throughput the paper headlines (§6: throughput x utilization)
collapses even though the GEMMs stay busy. This module makes admission a
policy object threaded through both engines:

  * **Terminal states** — every submitted request ends in exactly ONE of
    ``done`` / ``rejected`` / ``expired`` (`Request.state`); malformed
    requests never enter the queue at all (`InvalidRequest` at submit,
    naming the offending field), and an engine that runs out of steps with
    work still pending raises `ServeStalled` naming the stuck requests
    instead of returning silently.

  * **Policies** — `fifo` (the seed behavior, bit-identical when no
    deadlines/bounds are set), `edf` (earliest-deadline-first ordering +
    deadline expiry), and `slo-aware` (EDF ordering plus *predictive*
    shedding and overload degradation). The slo-aware policy prices each
    request with the tenancy wave model: `tenancy.trace.request_gemms`
    lowers (prompt_len, new_tokens) to the GEMM stream the engine would
    run, `tenancy.planner.predict_latency_s` turns it into model-space
    service seconds, and an online EWMA calibration (measured wall seconds
    per model second, `train.fault.Ewma`) maps the prediction to this
    box's wall clock. A request whose calibrated prediction cannot meet
    its deadline is shed *before* it burns prefill cycles — the same
    met/missed accounting `TenancyPlan.slo_attainment` reports, now
    choosing.

  * **Backpressure** — `max_queue` bounds the queue; a full queue sheds
    per policy (fifo/edf reject the arrival; slo-aware prefers shedding a
    queued request already predicted to miss). Under sustained overload
    (queue deeper than `overload_queue_per_slot x slots`) the slo-aware
    policy shrinks admitted decode budgets (graceful degradation: shorter
    completions for everyone beats no completions for the tail).

Deadline checks run at the engines' existing sync points (the per-chunk
host sync in ServeEngine — zero new syncs, the PR 7 discipline; per-token
in the reference oracle). All controller state is host-side Python.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional

from ..tenancy.planner import predict_latency_s
from ..tenancy.trace import request_gemms
from ..train.fault import Ewma

# terminal + lifecycle states (Request.state)
NEW = "new"
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
EXPIRED = "expired"
TERMINAL_STATES = (DONE, REJECTED, EXPIRED)

# policies
FIFO = "fifo"
EDF = "edf"
SLO_AWARE = "slo-aware"
POLICIES = (FIFO, EDF, SLO_AWARE)

# rows, cols, interconnect, pods — the paper-scale default design point
# the wave-model prediction prices requests on (obs.drift.DEFAULT_DESIGN)
DEFAULT_DESIGN = (32, 32, "butterfly-2", 64)


class InvalidRequest(ValueError):
    """A request that must never reach the hot loop; `.field` names the
    offending Request attribute."""

    def __init__(self, field: str, message: str):
        super().__init__(f"invalid request: {message} (field: {field})")
        self.field = field


class ServeStalled(RuntimeError):
    """run_to_completion exhausted max_steps with work still pending —
    the engine is wedged (or max_steps was too small). Carries the stuck
    request ids and their states."""

    def __init__(self, pending: dict[int, str], max_steps: int):
        self.pending = dict(pending)
        self.max_steps = max_steps
        detail = ", ".join(f"rid {r}: {s}" for r, s in
                           sorted(self.pending.items()))
        super().__init__(
            f"serving stalled: {len(pending)} request(s) still pending "
            f"after max_steps={max_steps} ({detail})")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Policy knobs; the defaults reproduce the seed engine exactly."""

    policy: str = FIFO
    max_queue: Optional[int] = None        # bounded queue; None = unbounded
    design: tuple = DEFAULT_DESIGN         # wave-model pricing point
    tdp: float = 400.0
    overload_queue_per_slot: float = 2.0   # queue > f*slots => overloaded
    degrade_budget_frac: float = 0.5       # slo-aware budget shrink factor
    calibration_alpha: float = 0.4         # EWMA for wall/model seconds
    faulty_pods: int = 0                   # pods masked out of the design
    #                                        point: predictions price on
    #                                        the degraded array, so the
    #                                        slo-aware policy sheds load
    #                                        proportionally to lost
    #                                        capacity

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {self.policy!r}; "
                f"choose from {POLICIES}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if not 0 <= self.faulty_pods < self.design[3]:
            raise ValueError(
                f"faulty_pods must be in [0, {self.design[3]}) for design "
                f"{self.design}, got {self.faulty_pods}")


class WaveLatencyPredictor:
    """Per-request service-time prediction from the tenancy wave model.

    `model_seconds(prompt_len, new_tokens)` is the analytical latency of
    the request's own GEMM stream (tenancy.trace.request_gemms lowered at
    decode lanes=1 — the conservative solo estimate) on the configured
    design point. Results are memoized on (pow2 prompt bucket, exact
    token budget) in a bounded LRU: prompt bucketing alone bounds one key
    axis, but a long-lived server seeing varied budgets would grow the
    other without limit (the unbounded-cache bugfix). `cache_cap` entries
    (~4096 * a few dozen bytes) is the hard ceiling; eviction is
    least-recently-used, so steady traffic mixes never thrash.
    """

    def __init__(self, cfg, design: tuple = DEFAULT_DESIGN,
                 tdp: float = 400.0, faulty_pods: int = 0,
                 cache_cap: int = 4096):
        self.cfg = cfg
        self.design = design
        self.tdp = tdp
        self.faulty_pods = int(faulty_pods)
        self.cache_cap = max(1, int(cache_cap))
        self._cache: OrderedDict[tuple[int, int], float] = OrderedDict()

    @staticmethod
    def _bucket(n: int) -> int:
        return 1 << max(0, int(n) - 1).bit_length()

    def model_seconds(self, prompt_len: int, new_tokens: int) -> float:
        key = (self._bucket(prompt_len), int(new_tokens))
        hit = self._cache.get(key)
        if hit is None:
            gemms = request_gemms(self.cfg, key[0], key[1])
            hit = self._cache[key] = predict_latency_s(
                gemms, self.design, self.tdp,
                faulty_pods=self.faulty_pods)
            if len(self._cache) > self.cache_cap:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        return hit


class AdmissionController:
    """Host-side admission/overload policy shared by both engines.

    The engine owns the queue list and the slots; the controller owns the
    *decisions*: validation, enqueue/shed on submit, queue ordering,
    deadline expiry, predictive shedding, and budget degradation. It also
    keeps the live SLO ledger (`slo_attainment`) and the wall-clock
    calibration EWMA the slo-aware policy predicts with.
    """

    def __init__(self, config: AdmissionConfig, slots: int, max_len: int,
                 predictor: Optional[WaveLatencyPredictor] = None,
                 metrics=None, clock: Callable[[], float] = None):
        self.config = config
        self.slots = slots
        self.max_len = max_len
        self.predictor = predictor
        self.metrics = metrics
        self._calibration = Ewma(alpha=config.calibration_alpha)
        # live ledger (always on — host ints, no metrics required)
        self.counts = {"submitted": 0, "admitted": 0, "done": 0,
                       "rejected": 0, "expired": 0, "degraded": 0}
        self._slo_met = 0
        self._slo_declared = 0
        self._seq = 0                       # submit order for stable sorts
        self.pool = None                    # serve/paging.PagePool, opt-in

    # -- paged-KV hooks --------------------------------------------------
    def attach_pool(self, pool) -> None:
        """Paged serving: free PAGES, not free slots, become the gating
        resource. The controller then (a) rejects at submit any request
        whose worst-case page count exceeds the whole pool (it could never
        run — terminal reason ``pages-exhausted``), and (b) under the
        slo-aware policy sheds queued requests whose predicted wait for a
        reservation pushes them past their deadline (``shed-page-
        exhaustion``). The engine still does the actual reserve/release at
        its chunk sync."""
        self.pool = pool

    def _worst_pages(self, req) -> int:
        budget = min(req.max_new_tokens - 1,
                     max(0, self.max_len - len(req.prompt)))
        return self.pool.worst_pages(len(req.prompt), budget)

    def _predicted_page_miss(self, req, now: float) -> bool:
        if self.pool is None or req._deadline is None:
            return False
        short = self.pool.reserved_pages + self._worst_pages(req) \
            - self.pool.n_pages
        if short <= 0:
            return False                    # reservable right now
        wait = self.pool.estimated_wait_s(short)
        if wait is None:
            return False                    # no free-rate sample yet
        service = self.predicted_wall_seconds(
            len(req.prompt), req.max_new_tokens) or 0.0
        return now + wait + service > req._deadline

    # -- validation (satellite: typed errors at submit) -----------------
    def validate(self, req) -> None:
        if len(req.prompt) == 0:
            raise InvalidRequest("prompt", "empty prompt")
        if len(req.prompt) > self.max_len:
            raise InvalidRequest(
                "prompt", f"prompt length {len(req.prompt)} exceeds "
                          f"max_len {self.max_len}")
        if req.max_new_tokens <= 0:
            raise InvalidRequest(
                "max_new_tokens",
                f"token budget must be > 0, got {req.max_new_tokens}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise InvalidRequest(
                "deadline_s", f"deadline must be > 0 seconds from submit, "
                              f"got {req.deadline_s}")

    # -- terminal transitions -------------------------------------------
    def _finalize(self, req, state: str, reason: str,
                  met: bool = False) -> None:
        req.state = state
        req.reason = reason
        self.counts[state] += 1
        if req.deadline_s is not None:
            self._slo_declared += 1
            self._slo_met += int(met)
        if self.metrics is not None and state in (REJECTED, EXPIRED):
            self.metrics.counter(f"serve.admission.{state}",
                                 reason=reason).inc()

    def reject(self, req, reason: str) -> None:
        self._finalize(req, REJECTED, reason)

    def expire(self, req, reason: str) -> None:
        self._finalize(req, EXPIRED, reason)

    def finish(self, req, now: Optional[float] = None) -> None:
        """Completion. A request that finished after its deadline is still
        `done` (the tokens exist) but counts as an SLO miss."""
        req.done = True
        met = req._deadline is None or (now is not None
                                        and now <= req._deadline)
        self._finalize(req, DONE, "", met=met)

    @property
    def slo_attainment(self) -> float:
        """Fraction of finished deadline-carrying requests that completed
        (TenancyPlan.slo_attainment semantics, measured live: a request
        that was shed or expired missed its SLO by definition)."""
        if not self._slo_declared:
            return 1.0
        return self._slo_met / self._slo_declared

    # -- calibration (model seconds -> this box's wall clock) -----------
    def observe_service(self, model_seconds: float,
                        wall_seconds: float) -> None:
        if model_seconds > 0 and wall_seconds > 0:
            self._calibration.observe(wall_seconds / model_seconds)

    def predicted_wall_seconds(self, prompt_len: int,
                               new_tokens: int) -> Optional[float]:
        """Calibrated wall-clock service prediction; None until both a
        predictor and at least one calibration sample exist (the policy
        admits optimistically while unwarmed)."""
        if self.predictor is None or self._calibration.value is None:
            return None
        return self._calibration.value * self.predictor.model_seconds(
            prompt_len, new_tokens)

    # -- submit-time decision -------------------------------------------
    def on_submit(self, queue: list, req, now: float) -> bool:
        """Validate, stamp, and enqueue-or-shed. Returns True when the
        request should be appended to the queue (the engine owns the
        append); on False the request has already been finalized."""
        self.validate(req)
        self.counts["submitted"] += 1
        self._seq += 1
        req._seq = self._seq
        req._submit_t = now
        req._deadline = None if req.deadline_s is None \
            else now + req.deadline_s
        req.state = QUEUED
        if self.pool is not None and self._worst_pages(req) > \
                self.pool.n_pages:
            # larger than the entire page pool: no amount of waiting lets
            # this request reserve, so fail it loudly at the door
            self.reject(req, "pages-exhausted")
            return False
        if self.config.max_queue is None or \
                len(queue) < self.config.max_queue:
            return True
        # queue full: shed. slo-aware prefers evicting a queued request
        # already predicted to miss its deadline (it would be shed at the
        # next sweep anyway); fifo/edf apply plain arrival backpressure.
        if self.config.policy == SLO_AWARE:
            victim = next((q for q in queue
                           if self._predicted_miss(q, now)), None)
            if victim is not None:
                queue.remove(victim)
                self.reject(victim, "shed-predicted-miss")
                return True
        self.reject(req, "queue-full")
        return False

    def _predicted_miss(self, req, now: float) -> bool:
        if req._deadline is None:
            return False
        pred = self.predicted_wall_seconds(
            len(req.prompt), req.max_new_tokens)
        return pred is not None and now + pred > req._deadline

    # -- per-quantum queue sweep ----------------------------------------
    def sweep(self, queue: list, now: float) -> None:
        """Expire/shed and reorder the queue in place — called once per
        scheduling quantum before admission (pure host work)."""
        keep = []
        for req in queue:
            if req._deadline is not None and now >= req._deadline:
                self.expire(req, "queued-past-deadline")
            elif self.config.policy == SLO_AWARE and \
                    self._predicted_miss(req, now):
                self.reject(req, "shed-predicted-miss")
            elif self.config.policy == SLO_AWARE and \
                    self._predicted_page_miss(req, now):
                self.reject(req, "shed-page-exhaustion")
            else:
                keep.append(req)
        queue[:] = keep
        if self.config.policy == FIFO:
            return
        # edf/slo-aware: earliest deadline first, then priority (lower =
        # more urgent), then arrival order; no-deadline requests last
        queue.sort(key=lambda r: (
            r._deadline if r._deadline is not None else float("inf"),
            r.priority, r._seq))

    # -- admission-time hooks -------------------------------------------
    def overloaded(self, queue_len: int) -> bool:
        return queue_len > self.config.overload_queue_per_slot * self.slots

    def clamp_budget(self, req, base_budget: int, queue_len: int) -> int:
        """Graceful degradation: under overload the slo-aware policy
        shrinks the decode budget of newly admitted requests (the
        `_clamped_budget` shrink of the issue) so slots recycle faster."""
        if self.config.policy != SLO_AWARE or base_budget <= 1 or \
                not self.overloaded(queue_len):
            return base_budget
        shrunk = max(1, int(base_budget * self.config.degrade_budget_frac))
        if shrunk < base_budget:
            self.counts["degraded"] += 1
            if self.metrics is not None:
                self.metrics.counter("serve.admission.degraded").inc()
        return shrunk

    def note_admitted(self, req, now: float) -> None:
        req.state = RUNNING
        req._admit_t = now
        self.counts["admitted"] += 1
        if self.metrics is not None:
            self.metrics.histogram("serve.queue_wait_us").record(
                (now - req._submit_t) * 1e6)

    # -- chunk-boundary deadline enforcement ----------------------------
    def expired_lanes(self, active: list, now: float) -> list[int]:
        """Slots whose running request's deadline has passed — checked at
        the engines' existing sync points, never mid-chunk."""
        return [i for i, r in enumerate(active)
                if r is not None and r._deadline is not None
                and now >= r._deadline]
