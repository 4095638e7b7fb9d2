"""Model assembly for the dense, SSM, MoE, hybrid, encoder-decoder and
vision-language families (counterpart of repro/models/transformer.py).

A model is a list of segments; a segment is a homogeneous stack of layers
whose parameters carry a leading `layers` axis. The reference scans the
stack with lax.scan; here a Python loop walks it (model.py). Ported so
far: the dense family (GQA attention with a dense or paged KV cache and
the (gated) MLP), the SSM family (one Mamba-2 mixer per layer,
models/ssm.py), the MoE family (the MoE FFN of models/moe.py after a
first `first_dense_layers` dense layers) with GQA attention (dbrx) or
multi-head latent attention (deepseek-v2: a latent cache, decode in the
weight-absorbed form), the hybrid family (hymba: attention and a
Mamba-2 mixer side by side in every layer, sliding-window ring caches
except in the global-attention layers, which split the stack into
segments) and the encoder-decoder family (whisper: `encoder` blocks,
non-causal self-attention over the input frames, which model.py runs
before the decoder; `crossdec` blocks, causal self-attention, then
cross-attention to the encoder output, whose per-layer K/V a prefill
writes into the cache and a decode step reads back) and the
vision-language family (llama-3.2-vision: one segment of groups, each
`cross_attn_every - 1` dense blocks and then a `cross_layer` block,
which has no self-attention: a pre-norm cross attention of the tokens
over the image tokens, then the pre-norm MLP; model.py walks the
groups).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ArchConfig
from ..obs.spans import region
from .attention import (NEG_INF, KVCache, PagedKVCache, RingKVCache,
                        attention, chunked_attention, decode_attention,
                        einsum, is_dtensor, lane_shards, seq_gathered)
from .layers import (ParamSpec, apply_mlp, apply_norm, apply_rope,
                     mlp_schema, norm_schema, pod_dense, rmsnorm)
from .moe import apply_moe, moe_schema
from .ssm import apply_ssm, ssm_schema


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str                  # dense | ssm | moe | hybrid | crossdec | vlm
    n: int                     # number of layers (of groups for vlm)
    window: int | None = None  # sliding window of the attention (hybrid)


def segments(cfg: ArchConfig) -> list[Segment]:
    if cfg.family == "vlm":
        # one segment of groups: cross_attn_every - 1 dense blocks, then a
        # cross_layer block (model.py::Model._run_vlm_segment)
        if cfg.n_layers % cfg.cross_attn_every:
            raise ValueError(
                f"a vlm's n_layers ({cfg.n_layers}) must be a multiple of "
                f"cross_attn_every ({cfg.cross_attn_every}): it runs in "
                f"whole groups")
        return [Segment("blocks", "vlm", cfg.n_layers // cfg.cross_attn_every)]
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
    if cfg.encoder_decoder:
        # the decoder; the encoder's blocks are a subtree of their own
        # (model.py::Model.schema), run once per prefill
        return [Segment("dec", "crossdec", cfg.n_layers)]
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; repro_torch serves "
            f"the dense, ssm, moe, hybrid, encoder-decoder and "
            f"vision-language families")
    return [Segment("layers", cfg.family, cfg.n_layers)]


def attn_schema(cfg: ArchConfig, layers: int | None) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    if cfg.mla:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "q_a": ParamSpec(lead + (d, m.q_lora_rank), la + ("embed", None)),
            "q_a_norm": ParamSpec(lead + (m.q_lora_rank,), la + (None,),
                                  init="ones"),
            "q_b": ParamSpec(lead + (m.q_lora_rank, cfg.n_heads, qk_dim),
                             la + (None, "heads", None)),
            "kv_a": ParamSpec(lead + (d, m.kv_lora_rank
                                      + m.qk_rope_head_dim),
                              la + ("embed", None)),
            "kv_a_norm": ParamSpec(lead + (m.kv_lora_rank,), la + (None,),
                                   init="ones"),
            "kv_b": ParamSpec(lead + (m.kv_lora_rank, cfg.n_heads,
                                      m.qk_nope_head_dim + m.v_head_dim),
                              la + (None, "heads", None)),
            "o": ParamSpec(lead + (cfg.n_heads, m.v_head_dim, d),
                           la + ("heads", None, "embed")),
        }
    return {
        "q": ParamSpec(lead + (d, cfg.n_heads, hd),
                       la + ("embed", "heads", None)),
        "k": ParamSpec(lead + (d, cfg.n_kv_heads, hd),
                       la + ("embed", "kv_heads", None)),
        "v": ParamSpec(lead + (d, cfg.n_kv_heads, hd),
                       la + ("embed", "kv_heads", None)),
        "o": ParamSpec(lead + (cfg.n_heads, hd, d),
                       la + ("heads", None, "embed")),
    }


def apply_gqa(p, x, cfg: ArchConfig, *, positions, causal: bool = True,
              window: int | None = None, impl: str = "chunked",
              cache: KVCache | PagedKVCache | RingKVCache | None = None,
              use_pallas: bool = False, true_lens=None, kv_rep: int = 1,
              kv_block: int = 1024):
    """GQA self-attention, causal unless `causal=False` (the encoder's).
    Prefill when x has S > 1 (filling a dense or ring `cache` if given);
    decode when S == 1 and a cache is given. The cache is updated in
    place. `impl` picks the prefill attention ("chunked", or "pallas":
    the flash-attention kernel); decode attention is torch ops (the
    reference has no decode kernel). use_pallas runs the q/k/v/o
    projections on the pod GEMM. true_lens [B]: per-lane valid lengths of
    a right-padded (bucketed) prefill; a ring cache then takes each
    lane's last-window real tokens, not the padded tail. kv_rep > 1
    repeats each K/V head kv_rep times after rope (the reference's virtual
    KV replication: a cache of n_kv_heads * kv_rep heads divides a wider
    model axis); kv_block is the chunked prefill's KV block."""
    if use_pallas:
        q = pod_dense(x, p["q"])
        k = pod_dense(x, p["k"])
        v = pod_dense(x, p["v"])
    else:
        q = einsum("bsd,dhk->bshk", x, p["q"])
        k = einsum("bsd,dhk->bshk", x, p["k"])
        v = einsum("bsd,dhk->bshk", x, p["v"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_rep > 1:
        k = torch.repeat_interleave(k, kv_rep, dim=2)
        v = torch.repeat_interleave(v, kv_rep, dim=2)

    if cache is not None and x.shape[1] == 1:            # decode
        q_pos = positions[..., 0]                        # scalar or [B]
        with region("decode_attention"):    # timed by a tracing engine
            if isinstance(cache, RingKVCache):
                cache.append_token(k, v)
                ck, cv, k_pos = cache.k, cache.v, cache.positions()
            elif isinstance(cache, PagedKVCache):
                # append into the mapped page, then gather the lane's
                # pages back into a position-ordered view: the dense
                # path's contract
                cache.append(k, v)
                ck, cv, k_pos = cache.flat_view()
            else:
                cache.append(k, v)
                ck, cv = cache.k, cache.v
                ar = torch.arange(ck.shape[1], device=x.device)
                k_pos = torch.where(ar[None, :] < cache.length[:, None],
                                    ar[None, :], -1)     # [B, S]
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
        out = attention(q, k, v, impl=impl, causal=causal, window=window,
                        kv_block=kv_block)
    B, S = x.shape[0], x.shape[1]
    out = out.reshape(B, S, cfg.n_heads, -1)
    if use_pallas:
        o_w = p["o"].reshape(-1, p["o"].shape[-1])       # [(H hd), d]
        return pod_dense(out.reshape(B, S, -1), o_w)
    return einsum("bshk,hkd->bsd", out, p["o"])


@dataclasses.dataclass
class MLACache:
    """Latent cache of multi-head latent attention, updated in place:
    `c_kv` [(L,) B, S_max, kv_lora] (the normed latent), `k_rope` [(L,) B,
    S_max, rope_dim] (the roped shared key), `length` [(L,) B] filled
    positions per lane. Per token and layer it holds kv_lora + rope_dim
    values, whatever the number of heads."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def zeros(batch, max_len, kv_lora, rope_dim, dtype=torch.bfloat16,
              layers: int | None = None, device=None):
        s1 = (batch, max_len, kv_lora)
        s2 = (batch, max_len, rope_dim)
        lshape: tuple[int, ...] = (batch,)
        if layers:
            s1, s2 = (layers,) + s1, (layers,) + s2
            lshape = (layers, batch)
        return MLACache(torch.zeros(s1, dtype=dtype, device=device),
                        torch.zeros(s2, dtype=dtype, device=device),
                        torch.zeros(lshape, dtype=torch.int64,
                                    device=device))

    def layer(self, i: int) -> "MLACache":
        """Layer i of a stacked cache, as views: writes land in the stack."""
        return MLACache(self.c_kv[i], self.k_rope[i], self.length[i])

    def append(self, c_new, r_new) -> None:
        """Write [B, s, kv_lora] and [B, s, rope_dim] at each lane's
        position `length`, in place, and advance `length` by s. A start
        past the end is clamped to S_max - s, as the reference's
        dynamic_update_slice does (KVCache.append). Nothing is read back
        to the host."""
        s = c_new.shape[1]
        if is_dtensor(self.c_kv):
            c, r, c_new, r_new, length = lane_shards(
                self.c_kv, self.k_rope, c_new, r_new, self.length)
            MLACache(c, r, length.clone()).append(c_new, r_new)
            self.length += s
            return
        B = c_new.shape[0]
        start = torch.clamp(self.length, 0, self.c_kv.shape[1] - s)  # [B]
        rows = torch.arange(B, device=c_new.device)[:, None]
        cols = start[:, None] + torch.arange(s, device=c_new.device)[None, :]
        self.c_kv[rows, cols] = c_new
        self.k_rope[rows, cols] = r_new
        self.length += s


def apply_mla(p, x, cfg: ArchConfig, *, positions,
              cache: MLACache | None = None, kv_block: int = 1024):
    """DeepSeek-V2 multi-head latent attention. Prefill (S > 1, or no
    cache): K and V decompressed per head from the latent through kv_b,
    the shared roped key broadcast over the heads, and chunked attention
    at 1/sqrt(qk_nope + qk_rope) whatever the model's attention_impl (the
    reference keeps MLA on einsums; it has no MLA kernel) over KV blocks
    of kv_block keys. Decode (S == 1 with a cache): the weight-absorbed
    form over the whole latent cache with the per-lane length mask,
    static shapes for the CUDA graphs.
    Every einsum rounds to x's dtype before the next, as in the
    reference; the cache is updated in place."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope, R = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope)

    q_lat = rmsnorm(einsum("bsd,dr->bsr", x, p["q_a"]), p["q_a_norm"])
    q = einsum("bsr,rhk->bshk", q_lat, p["q_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_lat = einsum("bsd,dr->bsr", x, p["kv_a"])
    c_kv = rmsnorm(kv_lat[..., :R], p["kv_a_norm"])
    k_rope = apply_rope(kv_lat[:, :, None, R:], positions,      # [B,S,1,r]
                        cfg.rope_theta)[:, :, 0, :]

    w_uk = p["kv_b"][..., :nope]                 # [R, H, nope], a view
    w_uv = p["kv_b"][..., nope:]                 # [R, H, v], a view

    if cache is not None and S == 1:             # absorbed decode
        cache.append(c_kv, k_rope)
        ckv, krope = cache.c_kv, cache.k_rope
        q_c = einsum("bshk,rhk->bshr", q_nope, w_uk)             # [B,1,H,R]
        s_nope = einsum("bshr,btr->bhst", q_c, ckv)
        s_rope = einsum("bshk,btk->bhst", q_rope, krope)
        s = (s_nope + s_rope).float() * scale                    # [B,H,1,T]
        t_pos = torch.arange(ckv.shape[1], device=x.device)
        s = s + torch.where(t_pos[None, :] < cache.length[:, None], 0.0,
                            NEG_INF)[:, None, None, :]
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        ctx_c = einsum("bhst,btr->bshr", pr, ckv)                # [B,1,H,R]
        ctx = einsum("bshr,rhv->bshv", ctx_c, w_uv)
        return einsum("bshv,hvd->bsd", ctx, p["o"])

    k_nope = einsum("bsr,rhk->bshk", c_kv, w_uk)
    v = einsum("bsr,rhv->bshv", c_kv, w_uv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                  dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = chunked_attention(qf, k, v, causal=True, softmax_scale=scale,
                            kv_block=kv_block)
    if cache is not None:
        cache.append(c_kv, k_rope)
    return einsum("bshv,hvd->bsd", out, p["o"])


def block_schema(cfg: ArchConfig, kind: str, layers: int | None) -> dict:
    if kind == "ssm":
        return {"ln_ssm": _norms(cfg, cfg.d_model, layers),
                "ssm": ssm_schema(cfg, layers)}
    if kind == "cross_layer":
        return {"ln_cross": _norms(cfg, cfg.d_model, layers),
                "cross": attn_schema(dataclasses.replace(cfg, mla=None),
                                     layers),
                "ln_mlp": _norms(cfg, cfg.d_model, layers),
                "mlp": mlp_schema(cfg.d_model, cfg.d_ff, cfg.activation,
                                  layers)}
    if kind not in ATTENTION_BLOCKS:
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
    if kind == "crossdec":
        sch["ln_cross"] = _norms(cfg, cfg.d_model, layers)
        sch["cross"] = attn_schema(dataclasses.replace(cfg, mla=None),
                                   layers)
    return sch


# the block kinds that open with pre-norm self-attention
ATTENTION_BLOCKS = ("dense", "moe", "hybrid", "encoder", "crossdec")


def _norms(cfg: ArchConfig, d: int, layers: int | None) -> dict:
    base = norm_schema(d, cfg.norm)
    if layers:
        return {k: ParamSpec((layers,) + v.shape, ("layers",) + v.axes,
                             init=v.init, dtype=v.dtype)
                for k, v in base.items()}
    return base


def cross_kv_precompute(p_cross, src, cfg: ArchConfig):
    """K/V of the cross attention from the encoder output (no rope), on
    einsums as in the reference, in the promoted dtype of src and the
    weights."""
    k = einsum("bsd,dhk->bshk", src, p_cross["k"])
    v = einsum("bsd,dhk->bshk", src, p_cross["v"])
    return k, v


def _cross_kv(p_cross, x, cfg: ArchConfig, cache: dict | None, cross_src):
    """(k, v) of a crossdec or cross_layer block's cross attention: read
    from the cache's CrossKV (model.py) at decode (a cache and S == 1,
    where nothing is computed from the source), else computed from
    `cross_src` (the encoder output, or the adapted image embeddings) and,
    with a cache, written into it."""
    c = cache.get("cross") if cache else None
    if c is not None and x.shape[1] == 1:
        return c.k, c.v
    if cross_src is None:
        raise ValueError("a cross-attention layer needs cross_src (the "
                         "encoder output or the image embeddings) outside "
                         "decode")
    k, v = cross_kv_precompute(p_cross, cross_src, cfg)
    if c is not None:
        c.write(k, v)
    return k, v


def _cross_attend(p, x, cfg: ArchConfig, cache: dict | None, cross_src):
    """The pre-norm cross attention of a crossdec or cross_layer block,
    without its residual: q and o projections on einsums and chunked
    attention over every source row (no mask), as in the reference, also
    under use_pallas and attention_impl="pallas"."""
    h = seq_gathered(apply_norm(p["ln_cross"], x, cfg.norm))
    k, v = _cross_kv(p["cross"], h, cfg, cache, cross_src)
    q = einsum("bsd,dhk->bshk", h, p["cross"]["q"])
    out = chunked_attention(q, k, v, causal=False)
    B, S = h.shape[0], h.shape[1]
    return einsum("bshk,hkd->bsd", out.reshape(B, S, cfg.n_heads, -1),
                  p["cross"]["o"])


def apply_block(p, x, cfg: ArchConfig, kind: str, *, positions,
                window: int | None = None, impl: str = "chunked",
                ssd_impl: str = "jnp", cache: dict | None = None,
                use_pallas: bool = False, true_lens=None,
                causal: bool = True, cross_src=None, kv_rep: int = 1,
                kv_block: int = 1024, constrain=None):
    """One layer, residual. dense: pre-norm GQA attention and pre-norm
    MLP, `cache` {"attn": KVCache | PagedKVCache} or None. moe: the same
    with the MoE FFN (models/moe.py) in place of the MLP. With cfg.mla,
    dense and moe blocks attend by apply_mla, `cache` {"attn": MLACache}
    or None, on einsums even under use_pallas (the reference's MLA has no
    kernel). ssm: a pre-norm Mamba-2 mixer, `cache`
    {"ssm": SSMCache} or None. hybrid: attention (over `window`, or
    global) and the Mamba-2 mixer both read the same x, each through its
    own norm, and add in as x + (a + s) / 2 before the pre-norm MLP;
    `cache` {"attn": RingKVCache | KVCache | PagedKVCache, "ssm":
    SSMCache} or None. The SSM's projections stay einsums under
    use_pallas, as in the reference. encoder: a dense block, called with
    causal=False and no cache. crossdec: causal self-attention, then a
    pre-norm cross attention to the encoder output, then the MLP; `cache`
    {"attn": KVCache, "cross": CrossKV} or None. Its K/V come from
    `cross_src` (the encoder output) and are written into the cache, or,
    at decode, are read from the cache (_cross_kv). Its q/o and K/V
    projections are einsums and its attention chunked torch ops even
    under use_pallas and attention_impl="pallas", as in the reference.
    cross_layer (the vision-language family's image layer): no
    self-attention; a pre-norm cross attention of the tokens over the
    image tokens `cross_src` (the adapted image embeddings), then the
    pre-norm MLP (on the pod GEMM under use_pallas); `cache` {"cross":
    CrossKV} or None, its K/V as crossdec's. `true_lens`: the per-lane
    lengths of a right-padded prefill. kv_rep and kv_block reach the
    self-attention as in the reference: kv_rep the GQA blocks' (hybrid
    ones included), kv_block the chunked prefill of the dense, moe,
    encoder and crossdec blocks and MLA (a hybrid block keeps the
    default, as the reference's does). `constrain` reaches the MoE
    experts (models/moe.py). Caches update in place."""
    if kind == "ssm":
        h = seq_gathered(apply_norm(p["ln_ssm"], x, cfg.norm))
        return x + apply_ssm(p["ssm"], h, cfg,
                             cache=cache["ssm"] if cache else None,
                             impl=ssd_impl, true_lens=true_lens)
    if kind == "cross_layer":
        x = x + _cross_attend(p, x, cfg, cache, cross_src)
        h = seq_gathered(apply_norm(p["ln_mlp"], x, cfg.norm))
        return x + apply_mlp(p["mlp"], h, cfg.activation,
                             use_pallas=use_pallas)
    if kind not in ATTENTION_BLOCKS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = seq_gathered(apply_norm(p["ln_attn"], x, cfg.norm))
    if cfg.mla is not None and kind in ("dense", "moe"):
        a = apply_mla(p["attn"], h, cfg, positions=positions,
                      cache=cache["attn"] if cache else None,
                      kv_block=kv_block)
    else:
        a = apply_gqa(p["attn"], h, cfg, positions=positions, causal=causal,
                      window=window, impl=impl,
                      cache=cache["attn"] if cache else None,
                      use_pallas=use_pallas, true_lens=true_lens,
                      kv_rep=kv_rep,
                      kv_block=1024 if kind == "hybrid" else kv_block)
    if kind == "hybrid":
        s = apply_ssm(p["ssm"],
                      seq_gathered(apply_norm(p["ln_ssm"], x, cfg.norm)), cfg,
                      cache=cache["ssm"] if cache else None, impl=ssd_impl,
                      true_lens=true_lens)
        x = x + 0.5 * (a + s)
    else:
        x = x + a
    if kind == "crossdec":
        x = x + _cross_attend(p, x, cfg, cache, cross_src)
    h = seq_gathered(apply_norm(p["ln_mlp"], x, cfg.norm))
    if kind == "moe":
        return x + apply_moe(p["moe"], h, cfg, use_pallas=use_pallas,
                             constrain=constrain)
    return x + apply_mlp(p["mlp"], h, cfg.activation, use_pallas=use_pallas)
