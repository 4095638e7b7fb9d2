"""The layers both references share, in float32 with TF32 off.

Precision objects decide what a matrix product sees: `F32` the weights
cast to float32 as they are; `FP8` (the control) every weight tensor and
every activation that enters a product rounded to float8 e4m3 with one
scale per tensor (amax / 448), then multiplied in float32.

Equations (the configuration's): pre-norm residual blocks; RMSNorm or
LayerNorm with the file's epsilon; rotary embedding on q and k by halves
(`rotate_half`), frequencies theta^(-2i/head_dim); causal attention with
grouped K/V heads, softmax scale head_dim^-1/2; a SiLU-gated MLP
(silu(x W_gate) * (x W_up)) W_down; logits from the final norm times the
unembedding.
"""

from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


class F32:
    name = "f32"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        return t.float()

    def x(self, t: torch.Tensor) -> torch.Tensor:
        return t


class FP8(F32):
    name = "fp8"

    @staticmethod
    def _round(t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        scale = t.abs().amax().clamp_min(1e-12) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def w(self, t):
        return self._round(t)

    def x(self, t):
        return self._round(t)


@contextlib.contextmanager
def exact_f32():
    """Full float32 products on the card (no TF32) inside the block."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def linear(x, w, prec):
    """x [T, K] times w [K, ...] flattened to [K, N]."""
    return prec.x(x) @ prec.w(w).reshape(w.shape[0], -1)


def norm(x, p: dict, cfg: dict):
    eps = cfg["norm_eps"]
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * p["scale"].float()


def rope(x, pos, theta: float):
    """x [T, H, hd] rotated by halves at positions pos [T]."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = (pos.double()[:, None] * inv[None, :]).float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def causal_attention(q, k, v, block: int = 512):
    """q [T, H, hd], k and v [T, KV, hd]: each query attends to the keys at
    or before its position, query heads grouped over the K/V heads."""
    T, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)       # [H, T, hd]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(T, device=q.device)
    for a in range(0, T, block):
        b = min(T, a + block)
        s = q[a:b].transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(hd)
        mask = keys[None, :] > torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        out[a:b] = (torch.softmax(s, dim=-1) @ v).transpose(0, 1)
    return out


def attention(p: dict, h, cfg: dict, pos, prec):
    T = h.shape[0]
    hd = cfg["head_dim"]
    q = linear(h, p["q"], prec).view(T, cfg["n_heads"], hd)
    k = linear(h, p["k"], prec).view(T, cfg["n_kv_heads"], hd)
    v = linear(h, p["v"], prec).view(T, cfg["n_kv_heads"], hd)
    q = rope(q, pos, cfg["rope_theta"])
    k = rope(k, pos, cfg["rope_theta"])
    o = causal_attention(prec.x(q), prec.x(k), prec.x(v))
    return linear(o.reshape(T, -1), p["o"].reshape(-1, p["o"].shape[-1]),
                  prec)


def glu(x, up, gate, down, prec):
    """(silu(x gate) * (x up)) down."""
    g = linear(x, gate, prec)
    return linear(torch.nn.functional.silu(g) * linear(x, up, prec), down,
                  prec)


def layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked weight tree, as views."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def forward_rows(weights: dict, cfg: dict, tokens, rows, prec, ffn,
                 block: int = 256):
    """Logits [len(rows), vocab] at positions `rows` of one sequence of
    token ids, float32, layer by layer. `ffn(p, h, cfg, prec)` is the
    family's feed-forward."""
    with exact_f32():
        (seg,) = [k for k in weights if k not in ("embed", "ln_f")]
        stack = weights[seg]
        x = weights["embed"]["tok"][tokens].float()
        pos = torch.arange(tokens.shape[0], device=x.device)
        for i in range(cfg["n_layers"]):
            p = layer(stack, i)
            x = x + attention(p["attn"], norm(x, p["ln_attn"], cfg), cfg,
                              pos, prec)
            x = x + ffn(p, norm(x, p["ln_mlp"], cfg), cfg, prec)
        h = norm(x[rows], weights["ln_f"], cfg)
        return torch.cat([linear(h[a:a + block], weights["embed"]["unembed"],
                                 prec) for a in range(0, h.shape[0], block)])
