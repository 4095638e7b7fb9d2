"""Model API over the segment system (counterpart of
repro/models/model.py).

    model = Model(get_arch("granite-8b"), attention_impl="pallas",
                  use_pallas=True)                             # on the card
    # or Model(get_arch("mamba2-370m"), ssd_impl="pallas", use_pallas=True)
    # or Model(get_arch("dbrx-132b"), attention_impl="pallas", use_pallas=True)
    # or Model(get_arch("hymba-1.5b"), attention_impl="pallas",
    #          ssd_impl="pallas", use_pallas=True)
    # or Model(get_arch("deepseek-v2-236b"), use_pallas=True)  # MLA
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, cache = model.prefill(params, batch, model.init_cache(4, 512))
    logits, cache = model.decode_step(params, tok, cache, position)

Parameters are nested dicts of tensors with the reference's names and
stacked per-layer weights [L, ...] (also for a one-layer segment, which
the reference keeps unstacked); a Python loop walks the layers where the
reference scans them. Caches are updated in place and returned, so
call sites read as in the reference.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..runtime import resolve_device
from .attention import KVCache, PagedKVCache, RingKVCache
from .layers import (apply_norm, embed, embed_schema, init_from_schema,
                     norm_schema, param_count, unembed)
from .ssm import SSMCache
from .transformer import (MLACache, Segment, apply_block, block_schema,
                          segments)


def _index(tree, i: int):
    """Layer i of a stacked parameter or cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (KVCache, PagedKVCache, RingKVCache, MLACache,
                         SSMCache)):
        return tree.layer(i)
    return tree[i]


class Model:
    def __init__(self, cfg: ArchConfig, attention_impl: str = "chunked",
                 use_pallas: bool = False, ssd_impl: str = "jnp",
                 device=None):
        """device None means the card (raises without one); tests pass
        device="cpu". attention_impl picks the prefill attention: "chunked"
        (torch ops) or "pallas" (the flash-attention kernel on the card,
        its plain version on the CPU). ssd_impl picks the SSM prefill's
        chunk scan: "jnp" (the reference's arithmetic in torch ops) or
        "pallas" (the SSD kernel on the card, its plain version on the
        CPU). use_pallas routes every dense projection, the MLP and the LM
        head (tied or not) through the pod GEMM and the MoE experts through
        the grouped pod GEMM (kernels on the card, their plain versions on
        the CPU); off, they are plain torch einsums."""
        if attention_impl not in ("chunked", "pallas"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        if ssd_impl not in ("jnp", "pallas"):
            raise ValueError(f"unknown ssd_impl {ssd_impl!r}")
        self.cfg = cfg
        self.impl = attention_impl
        self.ssd_impl = ssd_impl
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        self.segs = segments(cfg)

    # -- schema / params ---------------------------------------------------
    def schema(self) -> dict:
        cfg = self.cfg
        sch: dict = {"embed": embed_schema(cfg.vocab, cfg.d_model,
                                           cfg.tie_embeddings),
                     "ln_f": norm_schema(cfg.d_model, cfg.norm)}
        for seg in self.segs:
            sch[seg.name] = block_schema(cfg, seg.kind, seg.n)
        return sch

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the model's device, drawn from `generator`
        (which must live on that device). Same schema and init styles as
        the reference; other numbers (see bridge.py for parity)."""
        return init_from_schema(self.schema(), generator, self.device)

    def param_count(self) -> int:
        return param_count(self.schema())

    # -- forward -----------------------------------------------------------
    def _run_segment(self, seg: Segment, p_seg, x, positions, cache_seg,
                     true_lens=None):
        kw = dict(positions=positions, window=seg.window, impl=self.impl,
                  ssd_impl=self.ssd_impl, use_pallas=self.use_pallas,
                  true_lens=true_lens)
        for i in range(seg.n):
            x = apply_block(_index(p_seg, i), x, self.cfg, seg.kind,
                            cache=None if cache_seg is None
                            else _index(cache_seg, i), **kw)
        return x

    def forward(self, params, batch, cache: dict | None = None,
                positions=None, true_lens=None):
        """Returns (logits, cache). With a cache, prefill (S > 1) or decode
        (S == 1) writes into it in place and the same object comes back.
        true_lens [B]: per-lane valid lengths of a right-padded (bucketed)
        prefill; the SSM blocks mask their state updates with it and the
        ring caches gather each lane's last-window real tokens, so the
        padding is inert (models/ssm.py::apply_ssm,
        attention.py::RingKVCache.fill_prefill)."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        if positions is None:
            positions = torch.arange(S, device=tokens.device)
        x = embed(params["embed"], tokens)
        for seg in self.segs:
            cseg = cache.get(seg.name) if cache is not None else None
            x = self._run_segment(seg, params[seg.name], x, positions, cseg,
                                  true_lens)
        x = apply_norm(params["ln_f"], x, self.cfg.norm)
        return unembed(params["embed"], x, use_pallas=self.use_pallas), cache

    # -- serving -----------------------------------------------------------
    @property
    def bucketed_prefill_ok(self) -> bool:
        """True when prefill lanes can be right-padded to a bucket length
        without corrupting serving state: KV caches are inert under padding
        (causal masking and the engine's length fixup) and SSM state takes
        masked updates driven by per-lane true lengths. MoE capacity lets
        padding tokens displace real ones, and encoder-decoder prompts
        carry non-token inputs: those families prefill exact-length."""
        return (self.cfg.family in ("dense", "ssm", "hybrid")
                and not self.cfg.encoder_decoder)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   page_size: int | None = None,
                   kv_pages: int | None = None,
                   ring_len: int | None = None) -> dict:
        """Per segment: ssm, an SSMCache; dense and moe, a KVCache (an
        MLACache of the latent when cfg.mla is set); hybrid,
        an SSMCache beside a RingKVCache of min(window, ring_len) slots in
        a window segment and a KVCache in a global one. ring_len defaults
        to max_len; the paged engine's prefill transient spans a bucket's
        pages only but keeps the engine's ring width.

        page_size/kv_pages set builds a *paged* cache: every KVCache
        becomes a PagedKVCache over a shared kv_pages-page pool
        (serve/paging.PagePool owns the host-side allocation). SSM state
        and rings are fixed-size per lane, so they stay lane-resident
        either way. Only the bucketed-prefill families page: their prefill
        scatters whole pages of a padded bucket into the pool."""
        cfg = self.cfg
        if (page_size is None) != (kv_pages is None):
            raise ValueError("page_size and kv_pages must be set together")
        if page_size is not None and not self.bucketed_prefill_ok:
            raise ValueError(
                f"paged KV cache requires a bucketed-prefill family "
                f"(dense/ssm/hybrid), not {cfg.family}")
        if page_size is not None and cfg.mla is not None:
            raise ValueError("paged KV cache does not support MLA caches")
        hd = cfg.resolved_head_dim
        dev = self.device
        ring_len = max_len if ring_len is None else ring_len

        def kv(n):
            if page_size is not None:
                return PagedKVCache.zeros(
                    batch, max_len, cfg.n_kv_heads, hd, n_pages=kv_pages,
                    page_size=page_size, dtype=dtype, layers=n, device=dev)
            return KVCache.zeros(batch, max_len, cfg.n_kv_heads, hd, dtype,
                                 layers=n, device=dev)
        caches: dict = {}
        for seg in self.segs:
            node: dict = {}
            if cfg.mla is not None and seg.kind in ("dense", "moe"):
                node["attn"] = MLACache.zeros(
                    batch, max_len, cfg.mla.kv_lora_rank,
                    cfg.mla.qk_rope_head_dim, dtype, layers=seg.n,
                    device=dev)
            elif seg.kind != "ssm":
                node["attn"] = kv(seg.n) if seg.window is None else \
                    RingKVCache.zeros(batch, min(seg.window, ring_len),
                                      cfg.n_kv_heads, hd, dtype,
                                      layers=seg.n, device=dev)
            if seg.kind in ("ssm", "hybrid"):
                node["ssm"] = SSMCache.zeros(cfg, batch, layers=seg.n,
                                             dtype=dtype, device=dev)
            caches[seg.name] = node
        return caches

    def prefill(self, params, batch, cache: dict):
        """Run the prompt, filling `cache` in place. Returns (last-position
        logits [B, vocab], cache)."""
        logits, cache = self.forward(params, batch, cache=cache)
        return logits[:, -1, :], cache

    def decode_step(self, params, tokens, cache: dict, position):
        """tokens [B] or [B,1]; position: a scalar, or [B] per-lane
        positions (lanes of mixed length in one batch)."""
        if tokens.dim() == 1:
            tokens = tokens[:, None]
        B = tokens.shape[0]
        pos_vec = torch.as_tensor(position, dtype=torch.int64,
                                  device=tokens.device).expand(B)
        logits, cache = self.forward(params, {"tokens": tokens}, cache=cache,
                                     positions=pos_vec[:, None])
        return logits[:, -1, :], cache
