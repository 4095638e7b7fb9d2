"""Plain PyTorch versions of flash attention (counterpart of
repro/kernels/flash_attention/ref.py).

* `flash_attention_ref`: the reference's `naive_attention`, which
  materializes the [Sq, Skv] scores, plus the kv_len tail mask. The CPU path
  of ops.py runs it, and the card compares the kernel against it.
* `flash_attention_tiled_ref`: the Pallas kernel's own arithmetic
  (`_flash_kernel`), block by block. The card holds the Hopper kernel to it
  at about one bf16 ulp, which the naive version's bf16 scores cannot
  resolve. Only chip_smoke.py and the tests call it.
"""

from __future__ import annotations

import math

import torch

from ...models.attention import NEG_INF, naive_attention
from ...runtime import no_tf32


def flash_attention_ref(q, k, v, *, causal=True, window=None,
                        softmax_scale=None, kv_len=None):
    return naive_attention(q, k, v, causal=causal, window=window,
                           softmax_scale=softmax_scale, kv_valid_len=kv_len)


def flash_attention_tiled_ref(q, k, v, *, causal=True, window=None,
                              softmax_scale=None, kv_len=None,
                              block_k: int = 64,
                              score_dtype: torch.dtype = torch.float32):
    """q scaled in its own dtype, f32 scores, an online softmax over
    block_k-key blocks (running max m, denominator l and accumulator in
    f32), p = exp(s - m) cast unnormalised to v's dtype before PV,
    acc / max(l, 1e-30) cast to q's dtype. Every block is visited; one
    that a row may not see adds nothing, as in the Pallas kernel. With the
    Hopper kernel's key tile as block_k it rounds p where the kernel does.
    score_dtype=torch.float64 sums each score exactly enough to round it to
    f32 once: the same arithmetic with the f32 sums in another order, which
    is all that separates two right kernels."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    kv_len = Skv if kv_len is None else kv_len
    qs = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).float()
    qs = qs.reshape(B, Sq, Hkv, G, D)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, v.shape[-1]), device=q.device)
    with no_tf32():
        for k0 in range(0, Skv, block_k):
            kb = k[:, k0:k0 + block_k].float()
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs.to(score_dtype),
                             kb.to(score_dtype)).float()
            ok = k_pos < kv_len
            if causal:
                ok = ok & (k_pos <= q_pos)
            if window is not None:
                ok = ok & (q_pos - k_pos < window)
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                v[:, k0:k0 + block_k].float())
            m = m_new
    out = acc / torch.clamp_min(l, 1e-30)                   # [B,Hkv,G,Sq,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, -1).to(q.dtype)
