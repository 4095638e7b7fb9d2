"""Batched serving on the PyTorch port with continuous batching and the
full telemetry stack on (counterpart of examples/serve_lm.py): the
metrics snapshot prints after the run and the timeline lands as a
Perfetto-loadable Chrome trace. Runs on the card; `--device cpu` runs the
kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import json
import os
import subprocess
import sys
import tempfile

device = sys.argv[sys.argv.index("--device") + 1] \
    if "--device" in sys.argv else None
trace_path = os.path.join(tempfile.mkdtemp(prefix="sosa-serve-"),
                          "serve_trace.json")
cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b",
       "--reduced", "--requests", "6", "--slots", "3", "--max-new", "10",
       "--max-len", "96", "--metrics", "--trace-out", trace_path]
if device is not None:
    cmd += ["--device", device]
p = subprocess.run(cmd)
assert p.returncode == 0
with open(trace_path) as f:
    doc = json.load(f)
spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
assert spans, "serving run exported no spans"
print(f"trace: {len(spans)} spans at {trace_path} "
      f"(drag into ui.perfetto.dev)")
print("batched serving example: OK")
