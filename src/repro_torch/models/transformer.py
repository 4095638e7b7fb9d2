"""Model assembly for the dense, SSM, MoE and hybrid families (counterpart
of repro/models/transformer.py).

A model is a list of segments; a segment is a homogeneous stack of layers
whose parameters carry a leading `layers` axis. The reference scans the
stack with lax.scan; here a Python loop walks it (model.py). Ported so
far: the dense family (GQA attention with a dense or paged KV cache and
the (gated) MLP), the SSM family (one Mamba-2 mixer per layer,
models/ssm.py), the MoE family with GQA attention (dbrx; the MoE FFN of
models/moe.py after a first `first_dense_layers` dense layers) and the
hybrid family (hymba: attention and a Mamba-2 mixer side by side in every
layer, sliding-window ring caches except in the global-attention layers,
which split the stack into segments). MLA attention (deepseek-v2) and the
other families raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from .attention import (KVCache, PagedKVCache, RingKVCache, attention,
                        decode_attention)
from .layers import (ParamSpec, apply_mlp, apply_norm, apply_rope,
                     mlp_schema, norm_schema, pod_dense)
from .moe import apply_moe, moe_schema
from .ssm import apply_ssm, ssm_schema


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str                  # dense | ssm | moe | hybrid (ported so far)
    n: int                     # number of layers
    window: int | None = None  # sliding window of the attention (hybrid)


def segments(cfg: ArchConfig) -> list[Segment]:
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention (deepseek-v2) is not ported yet; "
            f"repro_torch serves MoE models with GQA attention (dbrx)")
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        segs = [Segment("dense0", "dense", fd)] if fd else []
        return segs + [Segment("moe", "moe", cfg.n_layers - fd)]
    if cfg.family == "hybrid":
        # the global-attention layers split the sliding-window stack
        segs, prev = [], 0
        for gi, g in enumerate(sorted(cfg.global_attn_layers)):
            if g > prev:
                segs.append(Segment(f"swa{gi}", "hybrid", g - prev,
                                    window=cfg.sliding_window))
            segs.append(Segment(f"glob{gi}", "hybrid", 1))
            prev = g + 1
        if prev < cfg.n_layers:
            segs.append(Segment("swa_tail", "hybrid", cfg.n_layers - prev,
                                window=cfg.sliding_window))
        return segs
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; repro_torch serves "
            f"the dense, ssm, moe and hybrid families")
    return [Segment("layers", cfg.family, cfg.n_layers)]


def attn_schema(cfg: ArchConfig, layers: int | None) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    lead = (layers,) if layers else ()
    return {
        "q": ParamSpec(lead + (d, cfg.n_heads, hd)),
        "k": ParamSpec(lead + (d, cfg.n_kv_heads, hd)),
        "v": ParamSpec(lead + (d, cfg.n_kv_heads, hd)),
        "o": ParamSpec(lead + (cfg.n_heads, hd, d)),
    }


def apply_gqa(p, x, cfg: ArchConfig, *, positions, window: int | None = None,
              impl: str = "chunked",
              cache: KVCache | PagedKVCache | RingKVCache | None = None,
              use_pallas: bool = False, true_lens=None):
    """Causal GQA attention. Prefill when x has S > 1 (filling a dense or
    ring `cache` if given); decode when S == 1 and a cache is given. The
    cache is updated in place. `impl` picks the prefill attention
    ("chunked", or "pallas": the flash-attention kernel); decode attention
    is torch ops (the reference has no decode kernel). use_pallas runs the
    q/k/v/o projections on the pod GEMM. true_lens [B]: per-lane valid
    lengths of a right-padded (bucketed) prefill; a ring cache then takes
    each lane's last-window real tokens, not the padded tail."""
    if use_pallas:
        q = pod_dense(x, p["q"])
        k = pod_dense(x, p["k"])
        v = pod_dense(x, p["v"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["q"])
        k = torch.einsum("bsd,dhk->bshk", x, p["k"])
        v = torch.einsum("bsd,dhk->bshk", x, p["v"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and x.shape[1] == 1:            # decode
        q_pos = positions[..., 0]                        # scalar or [B]
        if isinstance(cache, RingKVCache):
            cache.append_token(k, v)
            ck, cv, k_pos = cache.k, cache.v, cache.positions()
        elif isinstance(cache, PagedKVCache):
            # append into the mapped page, then gather the lane's pages
            # back into a position-ordered view: the dense path's contract
            cache.append(k, v)
            ck, cv, k_pos = cache.flat_view()
        else:
            cache.append(k, v)
            ck, cv = cache.k, cache.v
            ar = torch.arange(ck.shape[1], device=x.device)
            k_pos = torch.where(ar[None, :] < cache.length[:, None],
                                ar[None, :], -1)         # [B, S]
        out = decode_attention(q, ck, cv, k_pos, q_pos, window=window)
    else:                                                # prefill
        if isinstance(cache, PagedKVCache):
            raise TypeError(
                "PagedKVCache cannot be prefilled in place; prefill "
                "through a dense transient cache and scatter_prefill "
                "into the pool (the serve engine does)")
        if isinstance(cache, RingKVCache):
            cache.fill_prefill(k, v, true_lens)
        elif cache is not None:
            cache.append(k, v)
        out = attention(q, k, v, impl=impl, causal=True, window=window)
    B, S = x.shape[0], x.shape[1]
    out = out.reshape(B, S, cfg.n_heads, -1)
    if use_pallas:
        o_w = p["o"].reshape(-1, p["o"].shape[-1])       # [(H hd), d]
        return pod_dense(out.reshape(B, S, -1), o_w)
    return torch.einsum("bshk,hkd->bsd", out, p["o"])


def block_schema(cfg: ArchConfig, kind: str, layers: int | None) -> dict:
    if kind == "ssm":
        return {"ln_ssm": _norms(cfg, cfg.d_model, layers),
                "ssm": ssm_schema(cfg, layers)}
    if kind not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    sch = {"ln_attn": _norms(cfg, cfg.d_model, layers),
           "attn": attn_schema(cfg, layers),
           "ln_mlp": _norms(cfg, cfg.d_model, layers)}
    if kind == "moe":
        sch["moe"] = moe_schema(cfg, layers)
    else:
        sch["mlp"] = mlp_schema(cfg.d_model, cfg.d_ff, cfg.activation,
                                layers)
    if kind == "hybrid":
        sch["ln_ssm"] = _norms(cfg, cfg.d_model, layers)
        sch["ssm"] = ssm_schema(cfg, layers)
    return sch


def _norms(cfg: ArchConfig, d: int, layers: int | None) -> dict:
    base = norm_schema(d, cfg.norm)
    if layers:
        return {k: ParamSpec((layers,) + v.shape, init=v.init, dtype=v.dtype)
                for k, v in base.items()}
    return base


def apply_block(p, x, cfg: ArchConfig, kind: str, *, positions,
                window: int | None = None, impl: str = "chunked",
                ssd_impl: str = "jnp", cache: dict | None = None,
                use_pallas: bool = False, true_lens=None):
    """One layer, residual. dense: pre-norm GQA attention and pre-norm
    MLP, `cache` {"attn": KVCache | PagedKVCache} or None. moe: the same
    with the MoE FFN (models/moe.py) in place of the MLP (GQA attention:
    `segments` refuses MLA). ssm: a pre-norm Mamba-2 mixer, `cache`
    {"ssm": SSMCache} or None. hybrid: attention (over `window`, or
    global) and the Mamba-2 mixer both read the same x, each through its
    own norm, and add in as x + (a + s) / 2 before the pre-norm MLP;
    `cache` {"attn": RingKVCache | KVCache | PagedKVCache, "ssm":
    SSMCache} or None. The SSM's projections stay einsums under
    use_pallas, as in the reference. `true_lens`: the per-lane lengths of
    a right-padded prefill. Caches update in place."""
    if kind == "ssm":
        h = apply_norm(p["ln_ssm"], x, cfg.norm)
        return x + apply_ssm(p["ssm"], h, cfg,
                             cache=cache["ssm"] if cache else None,
                             impl=ssd_impl, true_lens=true_lens)
    if kind not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = apply_norm(p["ln_attn"], x, cfg.norm)
    a = apply_gqa(p["attn"], h, cfg, positions=positions, window=window,
                  impl=impl, cache=cache["attn"] if cache else None,
                  use_pallas=use_pallas, true_lens=true_lens)
    if kind == "hybrid":
        s = apply_ssm(p["ssm"], apply_norm(p["ln_ssm"], x, cfg.norm), cfg,
                      cache=cache["ssm"] if cache else None, impl=ssd_impl,
                      true_lens=true_lens)
        x = x + 0.5 * (a + s)
    else:
        x = x + a
    h = apply_norm(p["ln_mlp"], x, cfg.norm)
    if kind == "moe":
        return x + apply_moe(p["moe"], h, cfg, use_pallas=use_pallas)
    return x + apply_mlp(p["mlp"], h, cfg.activation, use_pallas=use_pallas)
