# Copy of src/repro/obs/export.py (the port imports nothing of repro).
"""Chrome trace-event / Perfetto JSON export of a serving timeline.

`ServeEngine` (serve/engine.py) emits one `Span` per device call — a
prefill launch or a fused decode chunk — into the duck-typed tracer
(`tenancy.ServeTraceRecorder.on_span`). `to_chrome_trace` lowers the
recorded spans to the Chrome trace-event JSON format (the `traceEvents`
array of "X" complete events), which both `chrome://tracing` and Perfetto
(ui.perfetto.dev) open directly, so an engine run can be inspected on a
real timeline: bucketed prefill launches, decode chunk cadence, lane
occupancy and emitted-token counts per chunk in the event args.

Spans carry host wall-clock (perf_counter) timestamps relative to the
engine's construction; timestamps are re-based to the earliest span so
traces start at t=0. Each span category ("prefill", "decode", ...) gets
its own track (tid) — the engine is single-threaded and step-locked, so
tracks encode phase, not concurrency.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed engine phase: a device call the host waited on."""

    name: str
    ts: float                  # start, seconds (engine-relative wall clock)
    dur: float                 # duration, seconds
    cat: str = "serve"         # track: "prefill" | "decode" | ...
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur


def to_chrome_trace(spans: Iterable[Span], process_name: str = "sosa-serve",
                    pid: int = 1) -> dict:
    """Spans -> Chrome trace-event JSON document (Perfetto-loadable).

    Returns the standard object form: {"traceEvents": [...],
    "displayTimeUnit": "ms"}; every span becomes a complete ("X") event
    with microsecond ts/dur, plus process/thread metadata events naming
    the tracks.
    """
    spans = list(spans)
    cats = sorted({s.cat for s in spans})
    tids = {c: i + 1 for i, c in enumerate(cats)}
    t0 = min((s.ts for s in spans), default=0.0)
    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for cat, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": cat}})
    for s in spans:
        events.append({
            "name": s.name,
            "cat": s.cat,
            "ph": "X",
            "ts": (s.ts - t0) * 1e6,
            "dur": s.dur * 1e6,
            "pid": pid,
            "tid": tids[s.cat],
            "args": dict(s.args),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Span],
                       process_name: str = "sosa-serve") -> int:
    """Write spans as a Chrome trace-event JSON file; returns the number
    of span events written (excluding metadata events)."""
    spans = list(spans)
    doc = to_chrome_trace(spans, process_name=process_name)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return len(spans)
