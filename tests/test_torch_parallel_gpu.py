"""Parallelism on the card (tests marked gpu; they skip without one).

A one-rank NCCL process group (tcp://127.0.0.1 on a free port) and
make_host_mesh(model=1) on it: reduced yi-6b's gradients from grads_fn on
plain parameters and on the same storage wrapped as DTensors
(parallel/sharding.py::sharded_step) bit-equal, then through
make_grad_sync(mesh, "data", impl) for every reducer: psum, butterfly,
butterfly2 and ring return them bit-equal at one rank, compressed's
reduced + new_error is the input within one f32 ulp. This file imports no
JAX: the multi-rank schedules are held against the JAX package on 8 gloo
ranks in tests/test_torch_parallel.py.
"""

import dataclasses
import math
import socket

import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.parallel.compression import compressed_psum
from repro_torch.parallel.sharding import (batch_sharding, make_constrain,
                                           placements, pspec_for_axes,
                                           sharded_step)
from repro_torch.train.grad_sync import IMPLS, make_grad_sync, pending
from repro_torch.train.train_step import TrainConfig, grads_fn
from repro_torch.train.tree import tree_leaves, tree_map


@pytest.fixture
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_host_mesh(model=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_one_rank_nccl_step_and_reducers(nccl_mesh):
    from torch.distributed.tensor import DTensor
    mesh = nccl_mesh
    assert mesh.device_type == "cuda"
    cfg = dataclasses.replace(reduced(get_arch("yi-6b")), n_layers=2)
    model = Model(cfg, remat=True)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 64), generator=g, device="cuda")
    batch = {"tokens": toks, "labels": torch.cat(
        [toks[:, 1:], torch.full_like(toks[:, :1], -1)], dim=1)}
    dparams = tree_map(lambda p, s: DTensor.from_local(
        p, mesh, placements(pspec_for_axes(s.axes, s.shape, mesh), mesh),
        shape=p.shape, stride=p.stride()), params, model.schema())
    dbatch = {k: DTensor.from_local(v, mesh, batch_sharding(mesh, v.ndim))
              for k, v in batch.items()}
    loss, grads = grads_fn(model, TrainConfig())(params, batch)
    dmodel = Model(cfg, remat=True, constrain=make_constrain(mesh, cfg.vocab))
    dloss, dgrads = sharded_step(grads_fn(dmodel, TrainConfig()))(dparams,
                                                                  dbatch)
    assert torch.equal(loss, dloss.full_tensor())
    for a, b in zip(tree_leaves(grads), tree_leaves(dgrads)):
        assert torch.equal(a, b.full_tensor())
    for impl in IMPLS:
        red, err = make_grad_sync(mesh, "data", impl)(dgrads)
        for a, b in zip(tree_leaves(red), tree_leaves(dgrads)):
            assert not pending(a, "data")
            if impl != "compressed":
                assert torch.equal(a.to_local(), b.to_local()), impl
        assert (err is not None) == (impl == "compressed")
    flat = torch.cat([b.to_local().reshape(-1).float()
                      for b in tree_leaves(dgrads) if pending(b, "data")])
    red, err = compressed_psum(flat, mesh.get_group("data"))
    ulp = torch.nextafter(flat.abs(), torch.full_like(flat, math.inf)) - \
        flat.abs()
    assert float(((red + err - flat).abs() / ulp).max()) <= 1.0
