"""Training step (counterpart of repro/train/train_step.py): bf16 compute,
per-layer remat inside the model (Model(remat=True)), microbatch gradient
accumulation, AdamW.

Gradients come from torch.autograd.grad over the parameter leaves, which
are detached aliases of the caller's tensors (nothing is copied). A model
that routes anything through a Hopper kernel (use_pallas, the flash or
SSD kernel) is refused: the kernels have no backward, and the reference
cannot differentiate its Pallas kernels either.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..models.attention import is_dtensor
from ..models.model import Model
from .optimizer import AdamWConfig, AdamWState, adamw_update
from .tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    # remat is per-layer inside the model (Model(remat=True)); this flag
    # adds a checkpoint of each whole microbatch forward (rarely needed)
    remat: bool = False
    optimizer: AdamWConfig = AdamWConfig()


def loss_fn(model: Model, params, batch):
    return model.loss(params, batch)


def _refuse_kernels(model: Model) -> None:
    on = [name for name, flag in (
        ("use_pallas=True", model.use_pallas),
        ("attention_impl='pallas'", model.impl == "pallas"),
        ("ssd_impl='pallas'", model.ssd_impl == "pallas")) if flag]
    if on:
        raise ValueError(
            f"training takes a model without kernels, not one built with "
            f"{', '.join(on)}: the Hopper kernels have no backward, and the "
            f"reference does not differentiate its Pallas kernels either "
            f"(jax.grad through pallas_call raises). Build "
            f"Model(cfg, remat=True) as the launcher does")


def _split_micro(batch: dict, n: int) -> list[dict]:
    """The batch cut into n microbatches along its leading axis, in order.
    A DTensor batch (the sharded step's, its rows over the data axes) is
    cut on each rank: microbatch i takes the i-th part of every rank's
    rows, so no row moves between ranks (the reference's reshape of a
    sharded axis would move them; DTensor cannot unflatten it). The
    microbatches then group other rows than the reference's, and sum to
    the same batch."""
    def split(x):
        b = x.shape[0]
        assert b % n == 0, f"batch {b} not divisible by {n} microbatches"
        if is_dtensor(x):
            return _split_local(x, n)
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _split_local(x, n: int) -> list:
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    b = local.shape[0]
    assert b % n == 0, f"local batch {b} not divisible by {n} microbatches"
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    return [DTensor.from_local(part, x.device_mesh, x.placements,
                               run_check=False, shape=torch.Size(shape),
                               stride=part.stride())
            for part in local.reshape(n, b // n, *local.shape[1:])]


def _scalar_like(x: float, t: torch.Tensor) -> torch.Tensor:
    # JAX casts a weakly typed Python scalar to the array's dtype first
    return torch.full((), x, dtype=t.dtype, device=t.device)


def grads_fn(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns f(params, batch) -> (loss, grads) with microbatching. With
    microbatches > 1 the leading batch axis splits into n microbatches in
    order; the gradients sum from zeros in the params' dtype and the loss
    in f32, and both are multiplied by 1/n, as the reference's scan does."""
    _refuse_kernels(model)
    base = functools.partial(loss_fn, model)
    if tcfg.remat:
        base = functools.partial(checkpoint, base, use_reentrant=False,
                                 preserve_rng_state=False)

    def vg(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = base(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), tree_unflatten(params, list(grads))

    if tcfg.microbatches == 1:
        return vg

    def accum(params, batch):
        n = tcfg.microbatches
        leaf = tree_leaves(params)[0]
        loss_acc = torch.zeros((), dtype=torch.float32, device=leaf.device)
        g_acc = tree_map(torch.zeros_like, params)
        for mb in _split_micro(batch, n):
            loss, g = vg(params, mb)
            g_acc = tree_map(torch.add, g_acc, g)
            loss_acc = loss_acc + loss
        inv = 1.0 / n
        return loss_acc * inv, tree_map(
            lambda g: g * _scalar_like(inv, g), g_acc)

    return accum


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    {loss, grad_norm, lr} as 0-d tensors on the device."""
    gf = grads_fn(model, tcfg)

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = gf(params, batch)
        params, opt_state, om = adamw_update(tcfg.optimizer, opt_state, grads)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_eval_step(model: Model) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch)
    return eval_step
