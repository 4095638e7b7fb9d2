"""The port's dry-run FLOP count beside XLA's for one cell's calibration
traces (1 and 2 layers at full width), per device on (data 2, model 4):

    PYTHONPATH=src python scripts/dryrun_flops_vs_xla.py [ARCH] [SHAPE]

The port side traces on fake tensors over 8 fake ranks
(repro_torch.launch.dryrun); the reference side compiles in a
subprocess over 8 forced host devices (repro.launch.dryrun, its mesh
built with Auto axes) and reads cost_analysis()["flops"]. XLA counts a
scan body once, also the chunked attention's scan over KV blocks inside
an unrolled layer, so the two are recorded side by side, not held equal.
Defaults: granite-8b prefill_32k.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.launch import dryrun as d
arch, shape = sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
c1, c2, _ = d.calibration_cfgs(get_arch(arch))
out = []
for c in (c1, c2):
    cost = d._compile_cell(arch, shape, mesh, cfg_override=c, unroll=True,
                           microbatches=1).cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    out.append(float(cost["flops"]))
print(json.dumps(out))
"""


def port_flops(arch: str, shape: str) -> list[float]:
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    c1, c2, _ = dryrun.calibration_cfgs(get_arch(arch))
    with dryrun.fake_world(8):
        mesh = make_host_mesh(model=4, device="cpu")
        return [float(dryrun._trace_cell(arch, shape, mesh, device="cpu",
                                         cfg_override=c, microbatches=1)
                      ["counter"].flops) for c in (c1, c2)]


def main() -> None:
    arch = sys.argv[1] if len(sys.argv) > 1 else "granite-8b"
    shape = sys.argv[2] if len(sys.argv) > 2 else "prefill_32k"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, arch, shape],
                          env=env, capture_output=True, text=True,
                          check=True)
    xla = json.loads(proc.stdout.strip().splitlines()[-1])
    port = port_flops(arch, shape)
    for name, (a, b) in (("port", port), ("xla", xla)):
        print(f"{name:5s} {arch} {shape} (data 2, model 4): 1 layer {a:.4g}, "
              f"2 layers {b:.4g}, a layer {b - a:.4g} FLOPs a device")


if __name__ == "__main__":
    main()
