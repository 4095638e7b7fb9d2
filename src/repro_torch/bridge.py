"""Convert the JAX reference's parameters into the port's.

The reference draws its weights from jax.random (threefry), which torch
cannot replay, so parity tests take the reference's own parameter tree,
turned into numpy arrays by the caller, and convert it name for name.
bf16 leaves arrive as ml_dtypes `bfloat16`; reading their bits as uint16
and viewing them as torch.bfloat16 is bit-exact.

The reference keeps a one-layer segment unstacked (no leading layer axis)
where the port stacks every segment; `model_params_from_jax` adds that
axis, segment by segment (hymba's global-attention segments are one layer
each; so is deepseek-v2's dense0, and its moe at reduced()). An
encoder-decoder arch's `encoder` subtree is not a segment: both packages
stack its blocks [n_encoder_layers, ...] at any depth, so it passes as
it is. Nor does a vision-language arch's one segment of groups gain an
axis: both packages stack its `plain` blocks [groups, inner, ...] and its
`cross` blocks [groups, ...] at any depth, one group included.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree, device="cpu"):
    """Nested dicts of numpy arrays (a reference param tree after
    np.asarray on each leaf) -> the same dicts of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def model_params_from_jax(model, tree, device=None):
    """params_from_jax for `model` (a repro_torch Model), on the model's
    own device unless `device` names another: every leaf of a one-layer
    segment gains the leading layer axis the port's schema has, but a
    vlm's segment of groups, which the reference stacks at every depth.
    Equal to params_from_jax where every segment has more than one
    layer."""
    out = params_from_jax(tree, model.device if device is None else device)
    for seg in model.segs:
        if seg.n == 1 and seg.kind != "vlm":
            out[seg.name] = _stack_one(out[seg.name])
    return out


def _stack_one(tree):
    if isinstance(tree, dict):
        return {k: _stack_one(v) for k, v in tree.items()}
    return tree[None]
