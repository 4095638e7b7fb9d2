"""Run one cell of the serving benchmark and print its result line.

    python3 servebench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout that holds `src/` (the program, `repro_torch`)
beside this folder. The program runs on its normal path, as
`repro_torch.launch.serve` builds it: `Model(cfg, attention_impl="pallas",
ssd_impl="pallas", use_pallas=True)` on the card and a `ServeEngine`; the
load loop calls `engine.submit` and `engine.step` and nothing else.

A run: weights drawn on the card from the seed; the engine; a warm-up
that meets every prefill shape of the mix and the decode chunk lengths 1,
2, 4 and 8, twice; the open loop of the mix, whose window opens `ramp_s`
after the load starts and lasts `--seconds`, and which runs on past the
close until every lane that served a request has finished one (at most
SETTLE_S); the
peak memory; then the engine is freed and the correctness check runs
(check.py). With
`--trace 1` the first TRACE_S seconds of the window run under
torch.profiler and the line carries the cell's per-layer metrics, else its
end-to-end metrics. The last line of standard output is one JSON object;
the numbers compared are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
    sys.path.pop(0)             # servebench's modules are not top-level
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from servebench import check, load as ld, readers, spec  # noqa: E402
from servebench import trace as tr, traffic, weights  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 5.0
SETTLE_S = 60.0     # past the close, the longest wait for every busy
#                     lane to have finished a request for the check


def arch_config(cfg: dict):
    """The program's ArchConfig of a configuration file."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    moe = None
    if cfg.get("moe"):
        m = cfg["moe"]
        moe = MoEConfig(num_experts=m["num_experts"], top_k=m["top_k"],
                        d_ff_expert=m["d_ff_expert"],
                        capacity_factor=m["capacity_factor"])
    return ArchConfig(
        name=cfg["name"], family=cfg["family"], n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_kv_heads"], d_ff=cfg["d_ff"], vocab=cfg["vocab"],
        head_dim=cfg["head_dim"], activation=cfg["activation"],
        norm=cfg["norm"], rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_embeddings"], moe=moe, dtype=cfg["dtype"])


def build(cfg: dict, seed: int, device):
    """The program's model on its normal path and the run's weights."""
    from repro_torch.models.model import Model
    model = Model(arch_config(cfg), attention_impl="pallas",
                  ssd_impl="pallas", use_pallas=True, device=device)
    return model, weights.make(model.shapes(device="meta"), seed, device)


def _warm(engine, mix: dict, vocab: int, seed: int) -> None:
    """Every prefill shape of the mix and the chunk lengths 8, 4, 2, 1
    (a budget of 15 decode steps), twice: the first captures, the second
    replays."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng([seed, 3])
    n = 2 * mix["serving"]["decode_chunk"]
    for _ in range(2):
        for i, P in enumerate(traffic.warmup_prompt_lengths(mix)):
            engine.submit(Request(rid=-1 - i, max_new_tokens=n,
                                  prompt=rng.integers(0, vocab, P)))
        engine.run_to_completion()


def log(phase: str, since: float) -> float:
    """One line on standard error: how long a phase of the run took."""
    now = time.perf_counter()
    print(f"servebench: {phase} {now - since:.3f} s", file=sys.stderr)
    return now


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, interpolated linearly."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(lo: ld.Load, t_start: float) -> dict:
    win = [t for s in lo.served for t in s.stamps if lo.in_window(t)]
    ttft = [1e3 * (s.first - s.due) for s in lo.served
            if s.first is not None and lo.in_window(s.first)]
    tpot = [1e3 * (s.stamps[-1] - s.first) / (len(s.stamps) - 1)
            for s in lo.served if s.req.state == "done"
            and len(s.stamps) > 1 and lo.in_window(s.stamps[-1])]
    out = {"output_tokens_per_s": len(win) / lo.window_s,
           "setup_s": lo.t_open - t_start}
    if ttft:
        out["ttft_p95_ms"] = percentile(ttft, 95)
    if tpot:
        out["tpot_p95_ms"] = percentile(tpot, 95)
    return out


def serve(cell: spec.Cell, model, params, *, seed: int, seconds: float,
          trace: bool, device, t_start: float = T_START) -> dict:
    """Warm up, run the window and read its metrics; the engine is freed
    before this returns."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, mix = cell.config, cell.mix
    rec = ld.SpanRecorder() if trace else None
    engine = ServeEngine(model, params, slots=mix["serving"]["slots"],
                         max_len=mix["serving"]["max_len"],
                         decode_chunk=mix["serving"]["decode_chunk"],
                         tracer=rec)
    t = time.perf_counter()
    _warm(engine, mix, cfg["vocab"], seed)
    _sync(device)
    t = log("warm-up", t)
    if rec is not None:
        rec.spans.clear()
    plans = traffic.plan(mix, seed, cfg["vocab"], seconds)
    prof = tr.Profiler(BUILD / "servebench" / f"{cell.name}.trace.json",
                       device) if trace else None
    lo = ld.drive(engine, plans,
                  lambda i, p: Request(rid=i, prompt=p.prompt,
                                       max_new_tokens=p.max_new),
                  ramp_s=mix["ramp_s"], seconds=seconds, tracer=prof,
                  trace_s=TRACE_S, settled=check.settled,
                  settle_s=SETTLE_S)
    _sync(device)
    t = log("load and window", t)
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    out = {"load": lo, "memory_peak_bytes": int(peak),
           "end_to_end": end_to_end(lo, t_start)}
    if trace:
        ctx = readers.Context(cfg, mix, lo, rec.spans,
                              {i: len(p.prompt) for i, p in enumerate(plans)})
        if prof.prof is not None:
            path = prof.export()
            ctx.dev, ctx.host = tr.read(path)
            path.unlink()
        out["per_layer"] = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                out["per_layer"][m["name"]] = v
        if ctx.dev:
            a, b = lo.trace_window
            out["busy_s"] = tr.busy_us(ctx.dev) / 1e6
            out["window_s"] = b - a
            out["breakdown"] = tr.breakdown(ctx.dev, ctx.host)
        log("trace read", t)
    del engine, rec
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
        device, control: bool = False, t_start: float = T_START) -> dict:
    """One run of the cell: its result line as a dict, `checked` last.
    `control` judges the float8 reference's choices in the program's
    place (the check's control; never on the benchmark's own runs)."""
    t = time.perf_counter()
    model, params = build(cell.config, seed, device)
    _sync(device)
    t = log("weights", t)
    out = serve(cell, model, params, seed=seed, seconds=seconds,
                trace=trace, device=device, t_start=t_start)
    lo = out["load"]
    picked = check.sample(lo.served, cell.mix, seed)
    t = time.perf_counter()
    got = check.gaps(params, cell.config, picked, device, control=control)
    log("check", t)
    failed = sum(s.req.state in ("rejected", "expired") for s in lo.served)
    checked = {k: {"value": got[k], "limit": v["limit"]}
               for k, v in cell.limits.items()}
    checked["failed_requests"] = {"value": failed, "limit": 0}
    checked["sampled_tokens"] = {"value": got["tokens"], "limit": 1}
    busy = len(check.lanes_seen(lo.served))
    checked["sampled_lanes"] = {"value": got["lanes"], "limit": busy}
    correct = (got["tokens"] >= 1 and failed == 0 and got["lanes"] == busy
               and all(got[k] <= v["limit"] for k, v in cell.limits.items()))
    wanted = cell.per_layer if trace else cell.end_to_end
    values = out["per_layer"] if trace else out["end_to_end"]
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if m["name"] in values}
    dev = {"platform": "gpu", "count": cell.chips,
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": len(lo.served),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and "busy_s" in out:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["window_s"]
        result["breakdown"] = out["breakdown"]
    result["checked"] = checked
    return result


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"servebench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(cell, seed=args.seed, seconds=args.seconds,
                 trace=bool(args.trace), device="cuda")
    bad = forbidden_modules()
    if bad:
        print(f"servebench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
