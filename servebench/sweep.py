"""Find a mix's knee once, on the chip: the cell's traffic at each offered
rate in turn, and for each the rate of completions, the queue left at the
window's close and the time-to-first-token tail.

    python3 servebench/sweep.py --workload granite-8b.chat \
        --rates 3,4,5,6,7 --seconds 30 --seed 1

The knee is the highest offered rate whose completions keep up with it
and whose queue does not grow; a cell below the knee offers about four
fifths of it. One process serves every rate, a new engine each. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from servebench.run import build, percentile, serve  # noqa: E402
from servebench import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    model, params = build(cell.config, args.seed, "cuda")
    for rate in [float(r) for r in args.rates.split(",")]:
        c = copy.copy(cell)
        c.mix = copy.deepcopy(cell.mix)
        c.mix["arrival"]["rate_per_s"] = rate
        out = serve(c, model, params, seed=args.seed, seconds=args.seconds,
                    trace=False, device="cuda", t_start=time.perf_counter())
        lo = out["load"]
        done = [s for s in lo.served if s.req.state == "done"
                and lo.in_window(s.stamps[-1])]
        due = [s for s in lo.served if lo.t_open < s.due <= lo.t_close]
        waiting = [s for s in lo.served if not s.stamps]
        ttft = [1e3 * (s.first - s.due) for s in lo.served
                if s.first is not None and lo.in_window(s.first)]
        print(json.dumps({
            "rate": rate, "window_s": lo.window_s,
            "arrived_per_s": len(due) / lo.window_s,
            "completed_per_s": len(done) / lo.window_s,
            "waiting_at_close": len(waiting),
            "ttft_p50_ms": percentile(ttft, 50) if ttft else None,
            "ttft_p95_ms": percentile(ttft, 95) if ttft else None,
            "end_to_end": out["end_to_end"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
