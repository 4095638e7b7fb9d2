"""The weights of a run, made on the device from the seed.

One flat buffer per dtype is filled by one `normal_` call of a generator
on the device, then cut into the leaves of the program's parameter tree
(`Model.shapes()`), each scaled by its role: a projection by one over
the square root of its contraction width, the token table by one, a norm's
scale by 1 + 0.05 N(0, 1) and its bias by 0.05 N(0, 1). The program and
the reference read the same tensors.
"""

from __future__ import annotations

import math

import torch

ALIGN = 128            # elements: every leaf starts 256-byte aligned


def _leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _fan_in(name: str, shape: tuple) -> int:
    if name in ("q", "k", "v"):                 # [.., d, heads, head_dim]
        return shape[-3]
    if name == "o":                             # [.., heads, head_dim, d]
        return shape[-3] * shape[-2]
    return shape[-2]                            # [.., in, out]


def _fill(leaf: torch.Tensor, name: str) -> None:
    if name == "scale":
        leaf.mul_(0.05).add_(1.0)
    elif name == "bias":
        leaf.mul_(0.05)
    elif name != "tok":
        leaf.mul_(1.0 / math.sqrt(_fan_in(name, tuple(leaf.shape))))


def make(shapes: dict, seed: int, device) -> dict:
    """A tree shaped like `shapes` (leaves of any device: only shape and
    dtype are read), drawn from `seed` on `device`."""
    leaves = list(_leaves(shapes))
    offsets, totals = [], {}
    for _, t in leaves:
        off = totals.get(t.dtype, 0)
        offsets.append(off)
        totals[t.dtype] = off + -(-t.numel() // ALIGN) * ALIGN
    bufs = {dtype: torch.empty(totals[dtype], dtype=dtype, device=device)
            for dtype in totals}
    out: dict = {}
    for (path, t), off in zip(leaves, offsets):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = bufs[t.dtype][off:off + t.numel()].view(t.shape)
    refill(out, seed)
    return out


def refill(tree: dict, seed: int) -> None:
    """Draw a tree that `make` built again, in place, from `seed`: the
    same tensors as `make(shapes, seed, ...)` would give."""
    leaves = list(_leaves(tree))
    bases = {}
    for _, t in leaves:
        bases.setdefault(t.dtype, t._base)
    gen = torch.Generator(device=leaves[0][1].device)
    gen.manual_seed(seed % (1 << 63))
    for dtype in sorted(bases, key=str):
        bases[dtype].normal_(generator=gen)
    for path, t in leaves:
        _fill(t, path[-1])
