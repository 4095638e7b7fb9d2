"""AdamW with f32 master weights and moments (counterpart of
repro/train/optimizer.py).

State: a step counter, f32 master parameters and the m/v moments in
`moment_dtype`, each a tree of the params' structure (the port's nested
dicts of tensors). Pure functions: `adamw_update` returns new trees and
leaves its inputs as they were. The arithmetic is the reference's, op for
op in f32: the global norm from per-leaf f32 sums of squares, the clip
scale, the step and bias corrections, the update with decoupled weight
decay on the master, and the new params the master cast to bf16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    master: Any          # f32 params
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # bf16 moments halve the optimizer's memory at a small noise cost; the
    # master stays f32
    moment_dtype: str = "float32"


def _moment_dtype(cfg: AdamWConfig | None) -> torch.dtype:
    return torch.float32 if cfg is None or cfg.moment_dtype == "float32" \
        else torch.bfloat16


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to 10% of the peak, in f32."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * prog))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def init_adamw(params, cfg: AdamWConfig | None = None) -> AdamWState:
    """Step 0, the params as f32 master and zero moments, on the params'
    device."""
    mdt = _moment_dtype(cfg)
    leaf = tree_leaves(params)[0]
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda: tree_map(
        lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                      master, zeros(), zeros())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of each leaf's f32 sum of squares."""
    sums = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, state: AdamWState, grads,
                 compute_dtype=torch.bfloat16):
    """One step. grads may be bf16; moments and master update in f32.
    Returns (new params in compute_dtype, new state, metrics
    {grad_norm, lr})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    mdt = _moment_dtype(cfg)

    def upd(p32, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mh = m32 / b1c
        vh = v32 / b2c
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p32)
        return p32, m32.to(mdt), v32.to(mdt)

    out = [upd(*xs) for xs in zip(tree_leaves(state.master),
                                   tree_leaves(grads), tree_leaves(state.m),
                                   tree_leaves(state.v))]
    master = tree_unflatten(state.master, [o[0] for o in out])
    m = tree_unflatten(state.m, [o[1] for o in out])
    v = tree_unflatten(state.v, [o[2] for o in out])
    params = tree_map(lambda p: p.to(compute_dtype), master)
    return params, AdamWState(step, master, m, v), {
        "grad_norm": gnorm, "lr": lr}
