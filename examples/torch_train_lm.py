"""End-to-end training on the PyTorch port with checkpoint/restart
(counterpart of examples/train_lm.py). Runs on the card; `--device cpu`
trains on the CPU.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]

Trains a reduced llama-family model on the deterministic synthetic stream,
simulates a mid-run failure, then resumes from the newest committed
checkpoint (train/checkpoint.py + train/fault.py). Thin wrapper over
repro_torch.launch.train (the real driver).
"""

import shutil
import subprocess
import sys
import tempfile

device = sys.argv[sys.argv.index("--device") + 1] \
    if "--device" in sys.argv else None
ckpt = tempfile.mkdtemp(prefix="sosa-train-ckpt-")
base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
        "granite-8b", "--reduced", "--steps", "30", "--batch", "8", "--seq",
        "64", "--ckpt-dir", ckpt, "--ckpt-every", "10"]
if device is not None:
    base += ["--device", device]
try:
    print("=== phase 1: train until a simulated failure at step 15 ===")
    p = subprocess.run(base + ["--kill-at", "15"])
    assert p.returncode == 42, "expected the simulated failure exit code"

    print("=== phase 2: resume from the newest committed checkpoint ===")
    p = subprocess.run(base + ["--resume"])
    assert p.returncode == 0
    print("resume-after-failure path: OK")
finally:
    shutil.rmtree(ckpt, ignore_errors=True)
