"""The port's examples (examples/torch_*.py) on the CPU: the design-space
and tenancy walkthroughs print what the reference's examples print, line
for line (a wall time masked), the quickstart too but for its last line,
which maps the 4096 x 4096 x 11008 GEMM to the pod GEMM's plan on the
H100; serving and training run their launchers with --device cpu."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.systolic_gemm.systolic_gemm import gemm_plan

ROOT = Path(__file__).resolve().parents[1]
_WALL = re.compile(r"in \d+ ms")


def _run(name: str, *args: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return [_WALL.sub("in # ms", ln) for ln in proc.stdout.splitlines()]


@pytest.mark.parametrize("name", ["explore_design_space.py",
                                  "tenancy_mix.py"])
def test_port_example_prints_the_reference_lines(name):
    assert _run("torch_" + name) == _run(name)


def test_quickstart_equals_the_reference_but_its_mapping_line():
    port, ref = _run("torch_quickstart.py"), _run("quickstart.py")
    assert port[:-1] == ref[:-1]
    assert ref[-1].startswith("TPU mapping")
    plan = gemm_plan("nn", 4096, 4096, 11008, torch.bfloat16, True)
    assert port[-1] == ("H100 pod GEMM: a 4096x4096x11008 bf16 GEMM -> "
                        f"mainloop={plan.mainloop} splits={plan.splits} "
                        f"block_n={plan.block_n}")
    assert not any("TPU" in ln for ln in port)


def test_serve_example_on_cpu():
    out = _run("torch_serve_lm.py", "--device", "cpu")
    assert out[-1] == "batched serving example: OK"
    assert any(ln.startswith("trace: ") for ln in out)


def test_train_example_on_cpu():
    out = _run("torch_train_lm.py", "--device", "cpu")
    assert out[-1] == "resume-after-failure path: OK"
    assert "simulated failure at step 15 (restart with --resume)" in out


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_explore_design_space.py",
                                  "torch_tenancy_mix.py", "torch_serve_lm.py",
                                  "torch_train_lm.py"])
def test_port_example_imports_only_the_port(name):
    text = (ROOT / "examples" / name).read_text()
    imports = re.findall(r"^\s*(?:from|import) (\S+)", text, re.M)
    assert not any(m.split(".")[0] in ("repro", "jax") for m in imports)
    assert not re.search(r"-m\", \"repro\.", text)
