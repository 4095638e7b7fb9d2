"""The MoE family (dbrx-132b): the dense family's attention, with a
mixture of experts in place of the MLP.

The router is a float32 product of the normed hidden state with its
[d, E] weight; softmax over the E experts; each token takes its top_k
(ties to the lower index), their probabilities renormalised to sum to
one; the output is the weighted sum of those experts' SiLU-gated MLPs.
The configuration's capacity lets every expert take every token of its
group (capacity_factor = num_experts / top_k), so no assignment drops.
"""

from __future__ import annotations

import torch

from .common import forward_rows as _forward_rows, glu


def ffn(p: dict, h, cfg: dict, prec):
    m, moe = cfg["moe"], p["moe"]
    if m["capacity_factor"] * m["top_k"] < m["num_experts"]:
        raise ValueError("the reference is dropless: capacity_factor must "
                         "be at least num_experts / top_k")
    probs = torch.softmax(h @ moe["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :m["top_k"]]
    gates = gates / gates.sum(-1, keepdim=True)
    experts = idx[:, :m["top_k"]]
    out = torch.zeros_like(h)
    for e in range(m["num_experts"]):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = glu(h[tok], moe["up"][e], moe["gate"][e], moe["down"][e], prec)
        out.index_add_(0, tok, gates[tok, slot, None] * y)
    return out


def forward_rows(weights, cfg, tokens, rows, prec):
    return _forward_rows(weights, cfg, tokens, rows, prec, ffn)
