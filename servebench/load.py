"""The load loop: submit each planned request when it is due, call
`engine.step()`, stamp every token with the host clock at the return of
the step after which it arrived, and keep the window.

The window opens at a step boundary `ramp_s` seconds after the load
starts and closes at the first step boundary `seconds` after it opens, so
it holds whole steps. A token belongs to the window when its stamp lies
in (open, close]. Past the close the loop goes on as before, arrivals
included, until `settled(served)` holds or `settle_s` has passed, so that
the check finds the answers that were due (late, not wrong). Each step's
work is kept for the per-layer readers: the true prompt lengths
prefilled, the live lanes of each decode step and the contexts they
attended over; each request notes the engine lane that served it.
"""

from __future__ import annotations

import dataclasses
import time

from .traffic import Planned


@dataclasses.dataclass
class Served:
    plan: Planned
    req: object                 # the engine's Request
    due: float                  # host clock at which it was due
    stamps: list = dataclasses.field(default_factory=list)  # per token
    lane: int | None = None     # the engine slot it was seen running in

    @property
    def first(self):
        return self.stamps[0] if self.stamps else None


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    prefills: list              # prompt lengths whose first token came here
    live: list                  # live lanes at each decode step of the chunk
    dec_ctx: int                # sum of contexts of the decode tokens


@dataclasses.dataclass
class Load:
    served: list
    steps: list
    t_load: float
    t_open: float
    t_close: float
    paused_s: float = 0.0       # host time inside the window spent on the
    #                             profiler's own start and stop
    trace_window: tuple | None = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open < t <= self.t_close


def drive(engine, plans: list, make_request, *, ramp_s: float,
          seconds: float, tracer=None, trace_s: float = 0.0,
          settled=None, settle_s: float = 0.0) -> Load:
    """Run the open loop. `make_request(i, plan)` builds the engine's
    Request. With a `tracer` (start()/stop()), the first `trace_s`
    seconds of the window are traced, whole steps. After the close the
    loop runs on until `settled(served)` or for `settle_s` seconds."""
    annotate = getattr(tracer, "annotate", None)
    served: list[Served] = []
    inflight: list[Served] = []
    steps: list[Step] = []
    t_load = time.perf_counter()
    nxt = 0
    t_open = t_close = None
    tr = None                      # (t0, t1) of the traced steps
    paused = 0.0
    while True:
        now = time.perf_counter()
        while nxt < len(plans) and t_load + plans[nxt].due_s <= now:
            p = plans[nxt]
            s = Served(p, make_request(nxt, p), t_load + p.due_s)
            engine.submit(s.req)
            served.append(s)
            inflight.append(s)
            nxt += 1
        if t_open is None and now - t_load >= ramp_s:
            if tracer is not None:
                tracer.start()
                tr = (time.perf_counter(), None)
            t_open = now = time.perf_counter()
        if t_open is not None:
            if tr is not None and tr[1] is None and \
                    (now - tr[0] >= trace_s or now - t_open >= seconds):
                tr = (tr[0], now)
                tracer.stop()
                paused += time.perf_counter() - now
                now = time.perf_counter()
            if t_close is None and now - t_open >= seconds:
                t_close = now
            if t_close is not None and (
                    settled is None or settled(served)
                    or now - t_close >= settle_s):
                break
        if not engine.queue and not any(r is not None for r in engine.active):
            due = t_load + plans[nxt].due_s if nxt < len(plans) else now
            time.sleep(max(0.0, min(due - now, 0.05)))
            continue
        t0 = time.perf_counter()
        if annotate is not None:
            with annotate("servebench.step"):
                engine.step()
        else:
            engine.step()
        t1 = time.perf_counter()
        steps.append(_stamp(inflight, t0, t1))
        _note_lanes(inflight, engine.active)
        inflight = [s for s in inflight if not s.req.finished]
    return Load(served, steps, t_load, t_open, t_close, paused, tr)


def _note_lanes(inflight: list, active: list) -> None:
    """Each running request's slot in the engine, as first seen."""
    by_req = {id(s.req): s for s in inflight if s.lane is None}
    for lane, r in enumerate(active):
        s = by_req.get(id(r)) if r is not None else None
        if s is not None:
            s.lane = lane


def _stamp(inflight: list, t0: float, t1: float) -> Step:
    """Stamp the tokens that arrived in the step [t0, t1] and note its
    work: a request's first token comes from its prefill and each later
    one from a decode step whose input sat at position P + i - 1 and
    attended over P + i keys (P the prompt length, i the token's index)."""
    prefills, counts, ctx = [], [], 0
    for s in inflight:
        have, now = len(s.stamps), len(s.req.out)
        if now == have:
            continue
        s.stamps.extend([t1] * (now - have))
        P = len(s.plan.prompt)
        start = have
        if have == 0:
            prefills.append(P)
            start = 1
        counts.append(now - start)
        ctx += sum(P + i for i in range(start, now))
    live = [sum(1 for c in counts if c > k) for k in range(max(counts,
                                                               default=0))]
    return Step(t0, t1, prefills, live, ctx)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    args: dict


class SpanRecorder:
    """The engine's `tracer`: keeps its spans (one per device call) on the
    host clock. The engine stamps a span on its own clock; the recorder
    takes the host clock at the call, which follows the span's end at
    once, and places the span by its duration."""

    def __init__(self):
        self.spans: list[Span] = []

    def on_span(self, name, ts, dur, cat="", **args):
        t1 = time.perf_counter()
        self.spans.append(Span(name, t1 - dur, t1, args))

    def on_prefill(self, rid, prompt_len, t=None):
        pass

    def on_decode(self, lanes, contexts, t=None):
        pass
