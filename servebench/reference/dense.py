"""The dense family (granite-8b): pre-norm GQA attention with rotary
embedding and a SiLU-gated MLP in every layer; see common.py."""

from __future__ import annotations

from .common import forward_rows as _forward_rows, glu


def ffn(p: dict, h, cfg: dict, prec):
    m = p["mlp"]
    return glu(h, m["up"], m["gate"], m["down"], prec)


def forward_rows(weights, cfg, tokens, rows, prec):
    return _forward_rows(weights, cfg, tokens, rows, prec, ffn)
