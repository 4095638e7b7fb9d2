"""Serving driver: batched requests through the continuous-batching engine
(the port of repro/launch/serve.py). Runs on the card; `--device cpu` is
the only way to ask for the CPU, and without a card it raises.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --reduced --requests 6 --slots 3 --max-new 12 \
        --metrics --trace-out build/serve_trace.json

`--metrics` prints the engine's telemetry snapshot (obs.metrics) after the
run; `--trace-out PATH` writes the run as Chrome trace-event JSON, one
span per device call: open it in ui.perfetto.dev or chrome://tracing.

Overload and failure knobs (serve/admission.py, serve/chaos.py):
`--policy {fifo,edf,slo-aware}` selects the admission policy, `--deadline
SECONDS` stamps every generated request with that deadline, `--max-queue N`
bounds the queue (over-budget submissions are shed with
`Request.state == "rejected"`), and `--chaos-*` arm the seeded fault
injector so the retry and shedding machinery shows from the command line.

`--arch` takes any arch, and the launcher passes no frames and no
image embeddings, as the reference's does not: an encoder-decoder arch
(whisper-small) and the vision-language arch (llama-3.2-vision-90b) fail
at their first prefill with a KeyError that names them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.models.model import Model
from repro_torch.serve.admission import AdmissionConfig, POLICIES
from repro_torch.serve.chaos import ChaosConfig
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--metrics", action="store_true",
                    help="print the obs.metrics snapshot after the run")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="write the run as Perfetto/Chrome trace JSON")
    ap.add_argument("--policy", choices=POLICIES, default="fifo",
                    help="admission policy (serve/admission.py)")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-request deadline in seconds from submit")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bounded queue: shed submissions beyond N queued")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="arm the fault injector with this seed")
    ap.add_argument("--chaos-fault-p", type=float, default=0.1,
                    help="per-call transient-fault probability")
    ap.add_argument("--chaos-slow-p", type=float, default=0.1,
                    help="per-call slow-chunk probability")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one). `cpu` runs the plain versions")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    # every projection, the MLP and the head on the pod GEMM, prefill
    # attention on the flash kernel and the SSM chunk scan on the SSD kernel
    # (their plain versions on the CPU)
    model = Model(cfg, attention_impl="pallas", ssd_impl="pallas",
                  use_pallas=True, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    device_name = (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "CPU")
    metrics = tracer = None
    if args.metrics:
        from repro_torch.obs.metrics import MetricsRegistry
        metrics = MetricsRegistry()
    if args.trace_out:
        from repro_torch.tenancy.trace import ServeTraceRecorder
        tracer = ServeTraceRecorder()
    chaos = None
    if args.chaos_seed is not None:
        chaos = ChaosConfig(seed=args.chaos_seed,
                            p_fault=args.chaos_fault_p,
                            p_slow=args.chaos_slow_p)
    engine = ServeEngine(model, params, slots=args.slots,
                         max_len=args.max_len, metrics=metrics,
                         tracer=tracer, chaos=chaos,
                         admission=AdmissionConfig(
                             policy=args.policy, max_queue=args.max_queue))

    rng = np.random.default_rng(0)
    t0 = time.time()
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 24),
                              dtype=np.int32)
        r = Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                    deadline_s=args.deadline)
        reqs.append(r)
        engine.submit(r)
    steps = 0
    while engine.queue or any(engine.active):
        engine.step()
        steps += 1
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in reqs)
    for r in reqs:
        tail = "" if r.state == "done" else \
            f"  [{r.state}{': ' + r.reason if r.reason else ''}]"
        print(f"req {r.rid}: prompt_len={len(r.prompt)} -> {r.out}{tail}")
    print(f"{args.requests} requests, {total_new} tokens, {steps} engine "
          f"steps, {dt:.1f}s ({1000 * dt / max(1, total_new):.0f} ms/tok "
          f"on {device_name})")
    c = engine.admission.counts
    if c["rejected"] or c["expired"] or args.deadline is not None:
        print(f"admission[{args.policy}]: {c}; "
              f"slo_attainment={engine.admission.slo_attainment:.2f}")
    if metrics is not None:
        print("metrics snapshot:")
        print(metrics.dumps(indent=1))
    if tracer is not None:
        from repro_torch.obs.export import write_chrome_trace
        n = write_chrome_trace(args.trace_out, tracer.spans)
        print(f"wrote {n} spans to {args.trace_out} "
              f"(open in ui.perfetto.dev)")


if __name__ == "__main__":
    main()
