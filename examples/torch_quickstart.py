"""Quickstart of the PyTorch port: the SOSA pipeline end to end on one
GEMM (counterpart of examples/quickstart.py).

    PYTHONPATH=src python examples/torch_quickstart.py

1. Build the paper's accelerator (256 pods of 32x32, Butterfly-2, 400 W).
2. Tile a GEMM with the r x r partition, schedule it across pods under the
   bank + butterfly routing constraints, and *numerically execute* the
   schedule (int8 in, int32 psums) against numpy.
3. Report the paper's headline metric (effective TOPS @ 400 W) for the
   workload, and the mainloop the port's pod GEMM picks on the H100 for a
   4096 x 4096 x 11008 GEMM (a pure function of the shape: no card
   needed).
"""

import numpy as np
import torch

from repro_torch.core import ArrayConfig, analyze, sosa
from repro_torch.core.executor import run_gemm_on_sosa
from repro_torch.core.workloads import bert
from repro_torch.kernels.systolic_gemm.systolic_gemm import gemm_plan

# 1. the paper's design point
accel = sosa(rows=32, cols=32)
print(f"SOSA: {accel.num_pods} pods of "
      f"{accel.array.rows}x{accel.array.cols}, "
      f"peak {accel.peak_ops / 1e12:.0f} TOPS @ {accel.peak_watts:.0f} W "
      f"({accel.peak_ops_at_tdp / 1e12:.0f} TOPS isopower@400W)")

# 2. tile + schedule + execute one GEMM
rng = np.random.default_rng(0)
x = rng.integers(-100, 100, (100, 768), dtype=np.int8)   # BERT-ish layer
w = rng.integers(-100, 100, (768, 768), dtype=np.int8)
out, sched, graph = run_gemm_on_sosa(x, w, ArrayConfig(32, 32), num_pods=64)
ref = x.astype(np.int32) @ w.astype(np.int32)
assert np.array_equal(out, ref), "schedule executed wrong math!"
print(f"GEMM 100x768x768 -> {len(graph)} tile ops over "
      f"{sched.num_slices} slices on 64 pods "
      f"(busy {100 * sched.pods_busy_fraction():.0f}%), numerics exact.")

# 3. the paper's metric on a real workload
res = analyze(bert("base", seq=100), accel)
print(f"BERT-base @ seq 100: utilization {100 * res.utilization:.1f}%, "
      f"effective {res.effective_tops_at_tdp:.0f} TOPS @ 400 W")

# the same granularity trade-off on the H100: the pod GEMM's plan for a
# [4096, 11008] x [11008, 4096] product in bf16
plan = gemm_plan("nn", 4096, 4096, 11008, torch.bfloat16, True)
print(f"H100 pod GEMM: a 4096x4096x11008 bf16 GEMM -> mainloop="
      f"{plan.mainloop} splits={plan.splits} block_n={plan.block_n}")
