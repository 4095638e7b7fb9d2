"""The JAX side of tests/test_torch_dryrun.py, run as one subprocess over
8 forced host devices:

    python tests/_dryrun_world.py OUT.json

It writes what the reference's dry-run (repro/launch/dryrun.py) gives for
every arch and shape: input_specs, calibration_cfgs, _microbatches,
kv_replication on both production mesh shapes, and the per-device
argument bytes of XLA's memory_analysis() for three reduced granite-8b
cells on a (data 2, model 4) mesh. The reference module sets XLA_FLAGS to
512 devices when it is imported; the backend is initialised on 8 first,
so that setting finds it running and changes nothing. The mesh is built
with Auto axes: jax.make_mesh's default axis types are Explicit in this
jax, and the reference's with_sharding_constraint refuses those.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

N = 8
REDUCED_CELLS = ("train_4k", "decode_32k", "prefill_32k")
PRODUCTION_MODEL = {"pod_16x16": {"data": 16, "model": 16},
                    "multipod_2x16x16": {"pod": 2, "data": 16, "model": 16}}


class ShapeOnlyMesh:
    """kv_replication reads mesh.shape alone."""

    def __init__(self, shape: dict):
        self.shape = shape


def main(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
    import jax
    assert len(jax.devices()) == N, jax.devices()
    from jax.sharding import AxisType

    from repro.configs import (SHAPES, get_arch, list_archs, reduced)
    from repro.launch import dryrun as d

    out: dict = {"input_specs": {}, "calibration": {}, "microbatches": {},
                 "kv_replication": {}, "argument_bytes": {}}
    for arch in list_archs():
        for shape in SHAPES:
            specs = d.input_specs(arch, shape)
            out["input_specs"][f"{arch}/{shape}"] = {
                k: [list(v.shape), str(v.dtype)] for k, v in specs.items()}
            out["microbatches"][f"{arch}/{shape}"] = d._microbatches(
                arch, shape)
        c1, c2, extra = d.calibration_cfgs(get_arch(arch))
        out["calibration"][arch] = [dataclasses.asdict(c1),
                                    dataclasses.asdict(c2), extra]
        for mesh_name, shape in PRODUCTION_MODEL.items():
            out["kv_replication"][f"{arch}/{mesh_name}"] = d.kv_replication(
                get_arch(arch), ShapeOnlyMesh(shape))

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg = reduced(get_arch("granite-8b"))
    for shape in REDUCED_CELLS:
        compiled = d._compile_cell("granite-8b", shape, mesh,
                                   cfg_override=cfg, unroll=True,
                                   microbatches=1)
        out["argument_bytes"][shape] = int(
            compiled.memory_analysis().argument_size_in_bytes)
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


if __name__ == "__main__":
    main(sys.argv[1])
