"""The paper's design-space exploration (Fig 5 / Table 2) on the PyTorch
port's copy of core/ (counterpart of examples/explore_design_space.py),
and an ASCII effective-throughput/W heatmap.

The sweep runs through the batched analytical engine (core.dse.sweep ->
simulator.analyze_batch): the whole (rows x cols x workload) grid is one
NumPy evaluation. Pass --scalar to use the original per-point loop and see
the wall-time difference.

    PYTHONPATH=src python examples/torch_explore_design_space.py [--scalar]
"""

import sys
import time

from repro_torch.core.dse import best_point, sweep, sweep_scalar, table2_rows
from repro_torch.core.workloads import full_suite

suite = full_suite(batch=1)
use_scalar = "--scalar" in sys.argv[1:]

print("=== Table 2 (effective throughput @ 400 W) ===")
print(f"{'design':>10} {'pods':>5} {'peak':>6} {'util':>6} {'effective':>9}")
for p in table2_rows(suite):
    print(f"{p.rows:>4}x{p.cols:<5} {p.num_pods:>5} "
          f"{p.peak_tops_at_tdp:>6.0f} {p.utilization:>6.3f} "
          f"{p.effective_tops_at_tdp:>9.1f}")

rows = (8, 16, 32, 64, 128, 256)
cols = (8, 16, 32, 64, 128, 256)
t0 = time.time()
pts = (sweep_scalar if use_scalar else sweep)(suite, rows, cols)
dt = time.time() - t0
best = best_point(pts)
engine = "scalar loop" if use_scalar else "batched engine"
print(f"\n=== Fig 5c heatmap (mixed suite), best {best.rows}x{best.cols} "
      f"@ {best.effective_tops_at_tdp:.0f} TOPS "
      f"[{len(pts)} points in {dt * 1e3:.0f} ms, {engine}] ===")
grid = {(p.rows, p.cols): p.effective_tops_at_tdp for p in pts}
mx = max(grid.values())
shades = " .:-=+*#%@"
print("      " + "".join(f"{c:>6}" for c in cols) + "   (cols)")
for r in rows:
    cells = "".join(
        f"{shades[min(9, int(10 * grid[(r, c)] / mx))] * 5:>6}"
        for c in cols)
    print(f"{r:>5} {cells}")
print("(rows)   darker = higher effective TOPS/W")
