"""Attention forward passes and the dense KV cache (counterpart of
repro/models/attention.py).

Shapes: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] with Hq = G * Hkv (GQA).
Masks come from position comparisons, with the finite NEG_INF = -1e30 of
the reference; q is scaled in its own dtype before QK^T, scores are f32,
and probabilities are cast to q's dtype before PV. These are jnp functions
in the reference, so they are torch ops here (no kernel).
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEG_INF = -1e30


def _scale_q(q, scale: float):
    # the reference multiplies by a weakly typed scalar, which JAX casts to
    # q's dtype first; a 0-d tensor of q's dtype rounds the same way
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _gqa_scores(q, k):
    """q [B,Sq,Hkv,G,D] x k [B,Skv,Hkv,D] -> [B,Hkv,G,Sq,Skv]."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q, k)


def _gqa_out(p, v):
    """p [B,Hkv,G,Sq,Skv] x v [B,Skv,Hkv,D] -> [B,Sq,Hkv,G,D]."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def _mask_ok(q_pos, k_pos, causal: bool, window: int | None):
    """[Sq, Skv] bool: which (query, key) pairs may attend."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return ok


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0,
                      kv_block: int = 1024, softmax_scale: float | None = None,
                      kv_valid_len=None):
    """Online-softmax attention over KV blocks (forward only). A short last
    block stands in for the reference's zero padding, whose keys are masked
    and add exact zeros."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qg = _scale_q(q, scale).reshape(B, Sq, Hkv, G, D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    acc = torch.zeros((B, Hkv, G, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, kv_block):
        kblk = k[:, start:start + kv_block]
        vblk = v[:, start:start + kv_block]
        k_pos = start + torch.arange(kblk.shape[1], device=q.device)
        s = _gqa_scores(qg, kblk).float()                   # [B,Hkv,G,Sq,kb]
        ok = _mask_ok(q_pos, k_pos, causal, window)
        if kv_valid_len is not None:
            ok = ok & (k_pos[None, :] < kv_valid_len)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _gqa_out(
            p.to(q.dtype), vblk).permute(0, 2, 3, 1, 4).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]        # [B,Hkv,G,Sq,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv).to(q.dtype)


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    softmax_scale=None, kv_valid_len=None):
    """Reference implementation (materializes [Sq, Skv] scores)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qg = _scale_q(q, scale).reshape(B, Sq, Hkv, G, D)
    s = _gqa_scores(qg, k).float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    ok = _mask_ok(q_pos, k_pos, causal, window)
    if kv_valid_len is not None:
        ok = ok & (k_pos[None, :] < kv_valid_len)
    bias = torch.where(ok, 0.0, NEG_INF)
    p = torch.softmax(s + bias, dim=-1).to(q.dtype)
    out = _gqa_out(p, v)                                    # [B,Sq,Hkv,G,Dv]
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Dense KV cache, updated in place. `k`/`v`: [(L,) B, S_max, H, D]
    (leading layer axis when stacked); `length`: [(L,) B] filled positions
    per lane, so lanes of mixed length share one cache."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def zeros(batch, max_len, n_kv, head_dim, dtype=torch.bfloat16,
              layers: int | None = None, device=None):
        shape = (batch, max_len, n_kv, head_dim)
        lshape: tuple[int, ...] = (batch,)
        if layers:
            shape = (layers,) + shape
            lshape = (layers, batch)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(lshape, dtype=torch.int64, device=device))

    def layer(self, i: int) -> "KVCache":
        """Layer i of a stacked cache, as views: writes land in the stack."""
        return KVCache(self.k[i], self.v[i], self.length[i])

    def append(self, k_new, v_new) -> None:
        """Write [B, s, H, D] at each lane's position `length`, in place,
        and advance `length` by s. As the reference's dynamic_update_slice
        does, a start past the end is clamped to S_max - s: a freed lane
        that keeps decoding inertly past max_len overwrites its last slot
        instead of writing out of bounds."""
        B, s = k_new.shape[0], k_new.shape[1]
        start = torch.clamp(self.length, 0, self.k.shape[1] - s)     # [B]
        rows = torch.arange(B, device=k_new.device)[:, None]
        cols = start[:, None] + torch.arange(s, device=k_new.device)[None, :]
        self.k[rows, cols] = k_new
        self.v[rows, cols] = v_new
        self.length += s


def decode_attention(q, cache_k, cache_v, k_pos, q_pos, *,
                     softmax_scale=None, window: int | None = None):
    """Single-token decode against a cache. q [B,1,Hq,D]; cache [B,S,Hkv,D];
    k_pos [S] or [B,S] absolute positions (-1 = invalid slot); q_pos a
    scalar or [B] (per-lane positions)."""
    B, _, Hq, D = q.shape
    Hkv = cache_k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qg = _scale_q(q, scale).reshape(B, 1, Hkv, G, D)
    s = _gqa_scores(qg, cache_k).float()                    # [B,Hkv,G,1,S]
    k_pos = torch.as_tensor(k_pos, device=q.device)
    k_pos = torch.atleast_2d(k_pos).expand(B, cache_k.shape[1])
    q_pos = torch.as_tensor(q_pos, device=q.device).expand(B)[:, None]
    ok = (k_pos >= 0) & (k_pos <= q_pos)
    if window is not None:
        ok &= (q_pos - k_pos) < window
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = _gqa_out(p, cache_v)                              # [B,1,Hkv,G,Dv]
    return out.reshape(B, 1, Hq, cache_v.shape[-1]).to(q.dtype)
