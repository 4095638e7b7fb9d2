"""Mixture-of-Experts (counterpart of repro/models/moe.py): top-k
token-choice routing with per-group expert capacity (GShard style).

Tokens are cut into groups of about `group_size`; each expert takes at
most `cap` (token, k) assignments per group, in flat token-major order,
and the rest drop to the residual path. Dispatch is either the GShard
one-hot einsums (the oracle) or an argsort/scatter (`sort`), which gives
the same (expert, slot) assignment by indexing.

Serving hot path (`apply_moe(..., use_pallas=True)`): the sort dispatch
and the grouped pod GEMM, every expert one group of a single launch per
projection (up, gate with the activation in its epilogue, down), and the
shared experts on `pod_dense`. Every rounding point of the reference is
kept: the expert outputs round to the activation dtype, and the K outputs
of a token combine in it. The router stays a full f32 einsum (never
TF32): a flipped top-k moves a token to another expert.

Capacity couples the tokens of a group: at decode the group is the whole
decode batch, so which of a lane's assignments survive depends on the
other lanes' tokens, dead lanes included. That is the reference's
semantics, kept as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, MoEConfig
from ..kernels.systolic_gemm.ops import grouped_gemm
from ..runtime import no_tf32
from .attention import einsum
from .layers import ParamSpec, activation_fn, pod_dense


def moe_schema(cfg: ArchConfig, layers: int | None = None) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    sch = {
        "router": ParamSpec(lead + (d, e), la + ("embed", None),
                            dtype=torch.float32),
        "up": ParamSpec(lead + (e, d, f), la + ("experts", "embed",
                                                 "expert_ff")),
        "gate": ParamSpec(lead + (e, d, f), la + ("experts", "embed",
                                                   "expert_ff")),
        "down": ParamSpec(lead + (e, f, d), la + ("experts", "expert_ff",
                                                   "embed")),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        sch["shared_up"] = ParamSpec(lead + (d, fs), la + ("embed", "ff"))
        sch["shared_gate"] = ParamSpec(lead + (d, fs), la + ("embed", "ff"))
        sch["shared_down"] = ParamSpec(lead + (fs, d), la + ("ff", "embed"))
    return sch


def _group_shape(n_tokens: int, group_size: int) -> tuple[int, int]:
    """(groups, tokens_per_group) with groups * tpg == n_tokens."""
    g = max(1, n_tokens // group_size)
    while n_tokens % g:
        g -= 1
    return g, n_tokens // g


def _capacity(tokens_per_group: int, m: MoEConfig) -> int:
    cap = int(tokens_per_group * m.top_k / m.num_experts * m.capacity_factor)
    return max(1, min(tokens_per_group, cap))


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (as
    jax.lax.top_k; torch.topk does not say how it breaks ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, xt, m: MoEConfig, use_sort: bool | None = None):
    """Shared router: (gate_vals, expert_idx, pos, keep, cap), each [G, n,
    K] but cap. Capacity priority is flat (token-major) order in the group,
    the same for both position computations. `use_sort` overrides the
    config's (the pallas hot path never builds the one-hot cumsum).

      onehot - cumsum over a [G, n*K, E] one-hot;
      sort   - stable argsort of expert ids minus each id's first
               occurrence: no E-sized tensor, same positions.
    """
    G, n, _ = xt.shape
    E, K = m.num_experts, m.top_k
    rdt = torch.float32 if m.router_dtype == "float32" else torch.bfloat16
    with no_tf32():
        logits = einsum("gnd,de->gne", xt.to(rdt), p["router"].to(rdt))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, K)                  # [G, n, K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)                # renormalize
    cap = _capacity(n, m)

    if use_sort is None:
        use_sort = m.dispatch in ("sort", "hybrid")
    if use_sort:
        nK = n * K
        flat_e = expert_idx.reshape(G, nK)
        order = torch.argsort(flat_e, dim=1, stable=True)     # [G, nK]
        sorted_e = torch.gather(flat_e, 1, order)
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos_sorted = torch.arange(nK, device=xt.device)[None, :] - first
        # scatter the positions back to (token, k) order
        pos = torch.zeros_like(pos_sorted).scatter_(1, order, pos_sorted)
        pos = pos.reshape(G, n, K)
    else:
        onehot = F.one_hot(expert_idx, E)                     # [G,n,K,E]
        flat = onehot.reshape(G, n * K, E)
        pos = ((torch.cumsum(flat, dim=1).reshape(onehot.shape) - onehot)
               * onehot).sum(-1)                              # [G, n, K]
    keep = pos < cap
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return gate_vals, expert_idx, pos, keep, cap


def _experts(p, xe, act, constrain=None):
    """xe [G,E,C,D] -> ye [G,E,C,D]: the expert FFNs as einsums (the
    oracle), in the operands' promoted dtype. `constrain` sees xe and ye
    as "moe_dispatched", as in the reference (the expert-parallel
    boundary)."""
    if constrain is not None:
        xe = constrain(xe, "moe_dispatched")
    dt = torch.promote_types(xe.dtype, p["up"].dtype)
    xe = xe.to(dt)
    h = einsum("gecd,edf->gecf", xe, p["up"].to(dt))
    g = act(einsum("gecd,edf->gecf", xe, p["gate"].to(dt)))
    ye = einsum("gecf,efd->gecd", h * g, p["down"].to(dt))
    if constrain is not None:
        ye = constrain(ye, "moe_dispatched")
    return ye


def _experts_grouped(p, xe, activation: str, constrain=None):
    """xe [G,E,C,D] -> ye [G,E,C,D] on the grouped pod GEMM: experts are
    the kernel's groups and each expert's G*C capacity rows its M axis, so
    the E (G*C x D x F) GEMMs of a projection run as ONE launch, the gate
    activation in the fused epilogue. Every output rounds to the promoted
    dtype, as in the reference. `constrain` as in _experts."""
    G, E, C, D = xe.shape
    if constrain is not None:
        xe = constrain(xe, "moe_dispatched")
    dt = torch.promote_types(xe.dtype, p["up"].dtype)
    xg = xe.transpose(0, 1).reshape(E, G * C, D).to(dt)
    h = grouped_gemm(xg, p["up"].to(dt), out_dtype=dt)
    g = grouped_gemm(xg, p["gate"].to(dt), activation=activation,
                     out_dtype=dt)
    ye = grouped_gemm(h * g, p["down"].to(dt), out_dtype=dt)
    ye = ye.reshape(E, G, C, D).transpose(0, 1)
    if constrain is not None:
        ye = constrain(ye, "moe_dispatched")
    return ye


def apply_moe(p: dict, x, cfg: ArchConfig, use_pallas: bool = False,
              constrain=None):
    """x: [B, S, D] -> [B, S, D].

    Grouped top-k routing with per-group capacity; over-capacity
    assignments drop. Without use_pallas the config's dispatch runs:
    "onehot" and "hybrid" the GShard einsums (with one-hot or argsort
    positions), "sort" the scatter dispatch with einsum experts. use_pallas
    forces the scatter dispatch with the experts on the grouped pod GEMM
    and the shared experts on `pod_dense`. `constrain` (the Model's hook)
    sees the dispatched [G, E, C, D] tensors (_experts)."""
    m = cfg.moe
    act = activation_fn(cfg.activation)
    B, S, D = x.shape
    G, n = _group_shape(B * S, m.group_size)
    xt = x.reshape(G, n, D)
    gate_vals, expert_idx, pos, keep, cap = _route(
        p, xt, m, use_sort=True if use_pallas else None)

    if use_pallas or m.dispatch == "sort":
        out = _dispatch_sort(p, xt, gate_vals, expert_idx, pos, keep, cap,
                             cfg, act, use_pallas=use_pallas,
                             constrain=constrain)
    else:
        expert_oh = F.one_hot(expert_idx, m.num_experts).to(x.dtype)
        slot_oh = F.one_hot(torch.where(keep, pos, cap),
                            cap + 1).to(x.dtype)[..., :cap]   # [G,n,K,C]
        dispatch = einsum("gnke,gnkc->gnec", expert_oh, slot_oh)
        combine = einsum("gnke,gnkc,gnk->gnec", expert_oh, slot_oh,
                         gate_vals.to(x.dtype))
        xe = einsum("gnec,gnd->gecd", dispatch, xt)           # [G,E,C,D]
        ye = _experts(p, xe, act, constrain)
        out = einsum("gnec,gecd->gnd", combine.to(ye.dtype), ye)

    if m.num_shared_experts:
        if use_pallas:
            h = pod_dense(xt, p["shared_up"])
            g = pod_dense(xt, p["shared_gate"], activation=cfg.activation)
            out = out + pod_dense(h * g, p["shared_down"])
        else:
            h = einsum("gnd,df->gnf", xt, p["shared_up"])
            g = act(einsum("gnd,df->gnf", xt, p["shared_gate"]))
            out = out + einsum("gnf,fd->gnd", h * g, p["shared_down"])
    return out.reshape(B, S, D).to(x.dtype)


def _dispatch_sort(p, xt, gate_vals, expert_idx, pos, keep, cap, cfg, act,
                   use_pallas: bool = False, constrain=None):
    """Scatter dispatch: the one-hot path's (expert, slot) assignment built
    by indexing. Kept assignments land in row expert * cap + pos of a
    per-group buffer, dropped ones in a dump row E * cap that is sliced
    off; they gather back from min(slot, E * cap - 1) times a zero
    weight."""
    m = cfg.moe
    G, n, D = xt.shape
    K, E = m.top_k, m.num_experts
    nK = n * K
    flat_e = expert_idx.reshape(G, nK)
    flat_keep = keep.reshape(G, nK)
    slot = torch.where(flat_keep, flat_e * cap + pos.reshape(G, nK),
                       E * cap)                               # [G, nK]
    tok = torch.arange(n, device=xt.device).repeat_interleave(K)
    buf = torch.zeros((G, E * cap + 1, D), dtype=xt.dtype, device=xt.device)
    buf.scatter_(1, slot[..., None].expand(G, nK, D), xt[:, tok])
    xe = buf[:, :E * cap].reshape(G, E, cap, D)

    if use_pallas:
        ye = _experts_grouped(p, xe, cfg.activation, constrain)
    else:
        ye = _experts(p, xe, act, constrain)

    ye_flat = ye.reshape(G, E * cap, D)
    back = torch.gather(ye_flat, 1, torch.clamp_max(slot, E * cap - 1)
                        [..., None].expand(G, nK, D))
    w = (gate_vals.reshape(G, nK) * flat_keep).to(xt.dtype)
    return (back * w[..., None]).reshape(G, n, K, D).sum(dim=2)


def load_balance_loss(logits, expert_idx, num_experts: int):
    """Auxiliary load-balancing loss (Switch eq. 4), as the reference's:
    E * sum(density * density_proxy), density the share of tokens whose
    first choice is each expert and density_proxy the mean router
    probability, both over axis 0, in f32. Nothing calls it in the
    training loss, as nothing does in the reference."""
    probs = torch.softmax(logits.float(), dim=-1)
    density = torch.mean(
        F.one_hot(expert_idx[..., 0].long(), num_experts).float(), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    return num_experts * torch.sum(density * density_proxy)
