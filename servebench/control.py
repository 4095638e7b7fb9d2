"""The readings behind a cell's correctness limit, on the chip: for each
seed, the program's widest logit gap and the control's (the reference in
float8 in the program's place), from one window at the cell's own load.

    python3 servebench/control.py --workload granite-8b.reasoning \
        --seeds 11,12,13 --seconds 45 [--out chiprun_out/control.jsonl]

One process serves every seed: the weights are drawn again in place and
a new engine is built for each. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from servebench.run import build, serve  # noqa: E402  (sets the caches)
from servebench import check, spec, weights  # noqa: E402
import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    model, params = build(cell.config, seeds[0], "cuda")
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            weights.refill(params, seed)
            t0 = time.perf_counter()
            out = serve(cell, model, params, seed=seed,
                        seconds=args.seconds, trace=False, device="cuda",
                        t_start=t0)
            picked = check.sample(out["load"].served, cell.mix, seed)
            t1 = time.perf_counter()
            prog = check.gaps(params, cell.config, picked, "cuda")
            t2 = time.perf_counter()
            ctrl = check.gaps(params, cell.config, picked, "cuda",
                              control=True)
            line = {"workload": cell.name, "seed": seed,
                    "program": prog["max_logit_gap"],
                    "control": ctrl["max_logit_gap"],
                    "program_mean": prog["mean_logit_gap"],
                    "control_mean": ctrl["mean_logit_gap"],
                    "tokens": prog["tokens"], "requests": len(picked),
                    "lanes": prog["lanes"],
                    "reference_s": t2 - t1,
                    "end_to_end": out["end_to_end"]}
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
