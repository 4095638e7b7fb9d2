"""Production mesh construction on torch.distributed (counterpart of
repro/launch/mesh.py).

Functions, not module constants, so importing this module touches no
process group. A mesh needs an initialised default process group (each
rank calls torch.distributed.init_process_group with its address, world
size and rank; nothing on a machine names a cluster).

Mesh axes:
  pod   - inter-pod axis: only data-parallel gradient sums cross it
          (train/grad_sync.py; int8-compressible, parallel/compression.py)
  data  - intra-pod data parallel / ZeRO-1 axis
  model - tensor / expert parallel axis
"""

from __future__ import annotations

from ..runtime import resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device) -> str:
    """'cuda' or 'cpu' after the port's device rule (None is the card).
    A group on the card must be NCCL: gloo there would move every
    collective through the host. A fake group (the dry-run's, which moves
    nothing) may model either."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "(backend, init_method, world_size, rank) on every rank first")
    if dev.type == "cuda" and dist.get_backend() not in ("nccl", "fake"):
        raise RuntimeError(
            f"a mesh on the card needs the nccl backend, not "
            f"{dist.get_backend()!r}")
    return dev.type


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(data 16, model 16) on 256 ranks, or (pod 2, data 16, model 16) on
    512 with multi_pod. device None means the card (raises without one);
    the CPU tests pass "cpu"."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    device_type = _device_type(device)
    import torch.distributed as dist
    need = 1
    for s in shape:
        need *= s
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh "
            f"{dict(zip(names, shape))} needs a world of {need} ranks, not "
            f"{dist.get_world_size()}")
    return _mesh(shape, names, device_type)


def make_host_mesh(model: int = 1, device=None):
    """Whatever the world holds (tests, examples, one card): (data, model)
    with `model` clamped to [1, world size] and data = world // model.
    device None means the card (raises without one)."""
    device_type = _device_type(device)
    import torch.distributed as dist
    n = dist.get_world_size()
    model = max(1, min(model, n))
    return _mesh((n // model, model), ("data", "model"), device_type)


def mesh_shape_dict(mesh) -> dict:
    """{axis name: size} in mesh order, for a DeviceMesh or any object
    whose `.shape` already maps names to sizes (the reference's
    mesh.shape)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)
