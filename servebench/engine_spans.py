"""The program's own spans in a traced run: a recorder that asks the serve
engine for detail (`repro_torch/serve/engine.py`'s docstring), the readers
of the three metrics that read them, and a command that runs a cell traced
with them and says where its time went by the engine's names.

    python3 -m servebench.engine_spans --workload granite-8b.chat \
        --seed 7 --seconds 50 [--profile 0]

from the root of a checkout, on the card. The command runs the cell as
`run.py --trace 1` does (`run.build`, `run.serve`), with `DetailRecorder`
in the place of `load.SpanRecorder`, and prints one JSON object: the
cell's per-layer metrics, the three below, the breakdown and the engine's
account of the window. It makes no correctness check. `--profile 0`
runs the window without torch.profiler: the spans alone, and end-to-end
metrics that an untraced run's can be held against (the profiler's stop
takes seconds of host time inside a traced window, and the arrivals held
back meanwhile queue behind it).

`load.SpanRecorder`, the recorder of the harness's own traced runs, does
not ask for detail, so their result lines hold none of these three.

* queue_wait_ms: the mean over the `serve.queue` spans that end inside
  the window of their duration, a request's submit to the start of the
  prefill that serves it. In a traced run the profiler's start and stop
  hold arrivals back, and the queue reads their backlog too.
* decode_attention_ms: the window's decode chunks' `attention_ms` (decode
  attention's device time, timed inside the graph) over their steps.
* engine_idle_share: percent of the traced window in which no device
  operation runs while the host is inside one of the engine's profiler
  ranges: idle that the engine's host work causes, not the load loop's
  wait for arrivals.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
from unittest import mock

import numpy as np

from . import load as ld
from . import readers, spec
from . import trace as tr

ENGINE_RANGES = ("serve.", "prefill/", "decode/")


class DetailRecorder(ld.SpanRecorder):
    """`load.SpanRecorder` that asks the engine for its detail spans."""
    detail = True


# -- readers -------------------------------------------------------------

def queue_wait_ms(ctx: readers.Context):
    ld_ = ctx.load
    waits = [s.t1 - s.t0 for s in ctx.spans if s.name == "serve.queue"
             and ld_.t_open < s.t1 <= ld_.t_close]
    return 1e3 * float(np.mean(waits)) if waits else None


def decode_attention_ms(ctx: readers.Context):
    spans = [s for s in ctx.window_spans("decode/")
             if "attention_ms" in s.args]
    steps = sum(s.args["steps"] for s in spans)
    if not steps:
        return None
    return sum(s.args["attention_ms"] for s in spans) / steps


def engine_ranges(host: list) -> list:
    """The engine's profiler ranges among a trace's host events."""
    return [o for o in host if o.cat == "user_annotation"
            and o.name.startswith(ENGINE_RANGES)]


def engine_idle_us(dev: list, host: list) -> list:
    """The intervals inside an engine range in which no device op runs."""
    eng = tr.union((o.ts, o.ts + o.dur) for o in engine_ranges(host))
    busy = tr.union((o.ts, o.ts + o.dur) for o in dev)
    out, j = [], 0
    for a, b in eng:
        t = a
        while j < len(busy) and busy[j][1] <= t:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            if busy[k][0] > t:
                out.append((t, busy[k][0]))
            t = max(t, busy[k][1])
            k += 1
        if t < b:
            out.append((t, b))
    return out


def engine_idle_share(ctx: readers.Context):
    if ctx.traced is None or not engine_ranges(ctx.host):
        return None
    idle = sum(b - a for a, b in engine_idle_us(ctx.dev, ctx.host))
    return 100.0 * idle / 1e6 / ctx.traced_s


READERS = {"queue_wait_ms.chat": queue_wait_ms,
           "decode_attention_ms.decode": decode_attention_ms,
           "engine_idle_share.chat": engine_idle_share}


# -- the engine's account of a run ---------------------------------------

def idle_by_range(dev: list, host: list) -> dict:
    """Seconds of engine-caused idle by the innermost engine range over it
    and the device call around it (`serve.launch in decode/chunk8`), each
    gap cut where an engine range starts or ends."""
    ranges = engine_ranges(host)
    calls = [o for o in ranges if not o.name.startswith("serve.")]
    edges = sorted({t for o in ranges for t in (o.ts, o.ts + o.dur)})
    gaps = []
    for a, b in engine_idle_us(dev, host):
        cuts = edges[bisect.bisect_right(edges, a):
                     bisect.bisect_left(edges, b)]
        gaps += list(zip([a] + cuts, cuts + [b]))
    mids = [(a + b) / 2 for a, b in gaps]
    out: dict[str, float] = {}
    for (a, b), inner, call in zip(gaps, tr.host_at(ranges, mids),
                                   tr.host_at(calls, mids)):
        key = inner if inner == call or call == "(no host event)" \
            else f"{inner} in {call}"
        out[key] = out.get(key, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _stats(values: list) -> dict | None:
    if not values:
        return None
    v = np.asarray(values, dtype=np.float64)
    return {"n": len(values), "mean": float(v.mean()),
            "p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95))}


def ttft_parts(ctx: readers.Context) -> dict:
    """For every request whose first token came in the window, in ms: the
    load loop's lateness (due to submit), the queue wait, the prefill call
    and the hold from the prefill's end to the return of the step that
    delivered the token (the decode chunk that follows it)."""
    queue = {s.args["rid"]: s for s in ctx.spans if s.name == "serve.queue"}
    prefill = {r: s for s in ctx.spans if s.name.startswith("prefill/")
               for r in s.args["rids"]}
    parts: dict[str, list] = {"late": [], "queue": [], "prefill": [],
                              "hold": [], "ttft": []}
    for i, s in enumerate(ctx.load.served):
        if s.first is None or not ctx.load.in_window(s.first) \
                or i not in queue or i not in prefill:
            continue
        q, p = queue[i], prefill[i]
        parts["late"].append(1e3 * (q.t0 - s.due))
        parts["queue"].append(1e3 * (q.t1 - q.t0))
        parts["prefill"].append(1e3 * (p.t1 - p.t0))
        parts["hold"].append(1e3 * (s.first - p.t1))
        parts["ttft"].append(1e3 * (s.first - s.due))
    return {k: _stats(v) for k, v in parts.items()}


def account(ctx: readers.Context) -> dict:
    """The window by the engine's spans: seconds under each span name,
    captures inside it, the TTFT's parts and, traced, the engine-caused
    idle by range."""
    ld_ = ctx.load
    inside = [s for s in ctx.spans if ld_.t_open <= s.t0
              and s.t1 <= ld_.t_close]
    by_name: dict[str, float] = {}
    for s in inside:
        key = s.name.split("/")[0] if not s.name.startswith("serve.capture") \
            else s.name
        by_name[key] = by_name.get(key, 0.0) + (s.t1 - s.t0)
    out = {"window_s": ld_.window_s, "span_s": by_name,
           "captures": sorted(s.name for s in inside
                              if s.name.startswith("serve.capture/")),
           "ttft_ms": ttft_parts(ctx)}
    if ctx.traced is not None:
        out["engine_idle_s"] = idle_by_range(ctx.dev, ctx.host)
    return out


class Unprofiled:
    """`trace.Profiler`'s place in a run without the profiler: the load
    loop starts and stops it, and it records nothing."""
    prof = None

    def __init__(self, path, device):
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def annotate(self, name: str):
        return contextlib.nullcontext()


def traced_run(cell: spec.Cell, *, seed: int, seconds: float, device,
               t_start: float | None = None,
               profile: bool = True) -> tuple[dict, readers.Context]:
    """`run.serve` traced, with DetailRecorder as the engine's tracer (and
    without the profiler unless `profile`): its result and the readers'
    context."""
    from . import run
    kept: list = []

    class Kept(readers.Context):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            kept.append(self)

    with contextlib.ExitStack() as patches:
        patches.enter_context(mock.patch.object(ld, "SpanRecorder",
                                                DetailRecorder))
        patches.enter_context(mock.patch.object(readers, "Context", Kept))
        if not profile:
            patches.enter_context(mock.patch.object(tr, "Profiler",
                                                    Unprofiled))
        model, params = run.build(cell.config, seed, device)
        out = run.serve(cell, model, params, seed=seed, seconds=seconds,
                        trace=True, device=device,
                        t_start=run.T_START if t_start is None else t_start)
    return out, kept[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("servebench: engine_spans needs a CUDA device",
              file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    out, ctx = traced_run(cell, seed=args.seed, seconds=args.seconds,
                          device="cuda", profile=bool(args.profile))
    result = {"workload": cell.name, "seed": args.seed,
              "profile": args.profile,
              "device": torch.cuda.get_device_name(0),
              "end_to_end": out["end_to_end"],
              "per_layer": out["per_layer"],
              "engine_spans": {k: f(ctx) for k, f in READERS.items()},
              "account": account(ctx),
              "busy_s": out.get("busy_s"), "window_s": out.get("window_s"),
              "breakdown": out.get("breakdown")}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
