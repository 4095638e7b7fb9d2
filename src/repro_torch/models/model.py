"""Model API over the segment system (counterpart of
repro/models/model.py).

    model = Model(get_arch("granite-8b"), attention_impl="pallas",
                  use_pallas=True)                             # on the card
    # or Model(get_arch("mamba2-370m"), ssd_impl="pallas", use_pallas=True)
    # or Model(get_arch("dbrx-132b"), attention_impl="pallas", use_pallas=True)
    # or Model(get_arch("hymba-1.5b"), attention_impl="pallas",
    #          ssd_impl="pallas", use_pallas=True)
    # or Model(get_arch("deepseek-v2-236b"), use_pallas=True)  # MLA
    # or Model(get_arch("whisper-small"), attention_impl="pallas",
    #          use_pallas=True)                                # enc-dec
    # or Model(get_arch("llama-3.2-vision-90b"), attention_impl="pallas",
    #          use_pallas=True)                                # vlm
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, cache = model.prefill(params, batch, model.init_cache(4, 512))
    logits, cache = model.decode_step(params, tok, cache, position)
    loss = Model(cfg, remat=True).loss(params, batch)   # train (batch
                                                        # with "labels")

Parameters are nested dicts of tensors with the reference's names and
stacked per-layer weights [L, ...] (also for a one-layer segment, which
the reference keeps unstacked); a Python loop walks the layers where the
reference scans them. Caches are updated in place and returned, so
call sites read as in the reference.

The encoder-decoder family (whisper) takes its encoder's input in the
batch: `batch["frames"]` [B, S_src, d_model], precomputed frame
embeddings (the conv frontend is a stub, as in the reference). A
prefill runs the encoder over them and writes each decoder layer's cross
K/V into the cache (`init_cache(src_len=)` sizes it); decode runs no
encoder and reads them back. Positions are sinusoids added to the
frames and to the token embeddings (`use_rope=False`).

The vision-language family (llama-3.2-vision) takes its image tokens in
the batch: `batch["image_embeds"]` [B, n_image_tokens, d_model], the
embeddings a vision tower would give (the tower is a stub, as in the
reference), which a prefill multiplies by `img_adapter` [d, d] into the
cross source of every group's `cross_layer`. Its one segment holds
`plain` dense blocks stacked [groups, cross_attn_every - 1, ...] and
`cross` blocks [groups, ...], stacked at every depth as the reference
stacks them. Its cache is flat (init_cache).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..runtime import resolve_device
from .attention import KVCache, PagedKVCache, RingKVCache, einsum
from .layers import (ParamSpec, apply_norm, cross_entropy_loss, embed,
                     embed_schema, init_from_schema, norm_schema,
                     param_count, unembed)
from .ssm import SSMCache
from .transformer import (MLACache, Segment, apply_block, block_schema,
                          segments)


@dataclasses.dataclass
class CrossKV:
    """Cross-attention K/V of the encoder output or the image tokens, per
    layer and lane, updated in place: `k`/`v` [(L,) B, S_src, H_kv, D]. A
    prefill writes the first S rows (S the frames or image tokens it was
    given); decode reads it whole and never writes it. It has no length:
    the cross attention attends every row, as the reference's does."""
    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(batch, src_len, n_kv, head_dim, dtype=torch.bfloat16,
              layers: int | None = None, device=None):
        shape = (batch, src_len, n_kv, head_dim)
        if layers:
            shape = (layers,) + shape
        return CrossKV(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))

    def layer(self, i: int) -> "CrossKV":
        """Layer i of a stacked cache, as views: writes land in the stack."""
        return CrossKV(self.k[i], self.v[i])

    def write(self, k, v) -> None:
        """Prefill's [B, S, H, D] keys and values into rows [0, S), cast
        to the cache's dtype, in place; rows past S keep what they held
        (the reference's dynamic_update_slice of a shorter update)."""
        S = k.shape[1]
        self.k[:, :S] = k
        self.v[:, :S] = v


def _sinusoid(seq: int, d: int, offset=0, device=None):
    """Sinusoidal positions [1 or B, seq, d] in f32, sin and cos
    concatenated (not interleaved), as the reference's. offset: an int,
    or a [B] tensor of per-lane decode positions (on the device: nothing
    is read back, so a captured decode step computes them)."""
    if isinstance(offset, int):
        pos = torch.arange(seq, device=device)[None, :] + offset
    else:
        off = torch.atleast_1d(offset)
        pos = torch.arange(seq, device=off.device)[None, :] + off[:, None]
    pos = pos.float()
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos[..., None] / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _stack_schema(sch, n: int):
    """A block schema with a leading axis of n (the vlm's groups)."""
    if isinstance(sch, dict):
        return {k: _stack_schema(v, n) for k, v in sch.items()}
    return dataclasses.replace(sch, shape=(n,) + sch.shape,
                               axes=("layers",) + sch.axes)


def _map_leaves(fn, schema):
    if isinstance(schema, dict):
        return {k: _map_leaves(fn, v) for k, v in schema.items()}
    return fn(schema)


def _index(tree, i: int):
    """Layer i of a stacked parameter or cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (KVCache, PagedKVCache, RingKVCache, MLACache,
                         SSMCache, CrossKV)):
        return tree.layer(i)
    return tree[i]


class Model:
    def __init__(self, cfg: ArchConfig, attention_impl: str = "chunked",
                 use_pallas: bool = False, ssd_impl: str = "jnp",
                 device=None, remat: bool = False, kv_rep: int = 1,
                 constrain=None, kv_block: int = 1024):
        """device None means the card (raises without one); tests pass
        device="cpu". attention_impl picks the prefill attention: "chunked"
        (torch ops) or "pallas" (the flash-attention kernel on the card,
        its plain version on the CPU). ssd_impl picks the SSM prefill's
        chunk scan: "jnp" (the reference's arithmetic in torch ops) or
        "pallas" (the SSD kernel on the card, its plain version on the
        CPU). use_pallas routes every dense projection, the MLP and the LM
        head (tied or not) through the pod GEMM and the MoE experts through
        the grouped pod GEMM (kernels on the card, their plain versions on
        the CPU); off, they are plain torch einsums. None of the kernels
        has a backward, so training (train/train_step.py) takes a model
        with all three off, as the reference does. remat checkpoints each
        layer body of a forward without a cache when autograd records it
        (torch.utils.checkpoint, non-reentrant): the backward keeps each
        layer's input and recomputes the rest, where the reference wraps
        its scan bodies in jax.checkpoint. It changes memory, never a
        number.

        The reference's three parallelism knobs: kv_rep repeats each K/V
        head kv_rep times in the GQA attention and widens init_cache's KV
        caches to n_kv_heads * kv_rep heads (a head count that divides the
        model axis). constrain(x, kind) is called on the residual stream
        after the embedding and after every layer ("residual"), on the
        logits ("logits") and on the MoE's dispatched tokens
        ("moe_dispatched"), at the reference's sites; the sharded step
        passes parallel/sharding.py::make_constrain. kv_block is the KV
        block of the chunked attention. The defaults change nothing."""
        if attention_impl not in ("chunked", "pallas"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        if ssd_impl not in ("jnp", "pallas"):
            raise ValueError(f"unknown ssd_impl {ssd_impl!r}")
        self.cfg = cfg
        self.impl = attention_impl
        self.ssd_impl = ssd_impl
        self.use_pallas = use_pallas
        self.remat = remat
        self.kv_rep = kv_rep
        self.constrain = constrain or (lambda x, kind: x)
        self.kv_block = kv_block
        self.device = resolve_device(device)
        self.segs = segments(cfg)

    # -- schema / params ---------------------------------------------------
    def schema(self) -> dict:
        cfg = self.cfg
        sch: dict = {"embed": embed_schema(cfg.vocab, cfg.d_model,
                                           cfg.tie_embeddings),
                     "ln_f": norm_schema(cfg.d_model, cfg.norm)}
        for seg in self.segs:
            if seg.kind == "vlm":
                sch[seg.name] = {
                    "plain": _stack_schema(block_schema(
                        cfg, "dense", cfg.cross_attn_every - 1), seg.n),
                    "cross": block_schema(cfg, "cross_layer", seg.n)}
            else:
                sch[seg.name] = block_schema(cfg, seg.kind, seg.n)
        if cfg.encoder_decoder:
            sch["encoder"] = {
                "blocks": block_schema(cfg, "encoder", cfg.n_encoder_layers),
                "ln_f": norm_schema(cfg.d_model, cfg.norm)}
        if cfg.family == "vlm":
            sch["img_adapter"] = ParamSpec((cfg.d_model, cfg.d_model),
                                           ("embed", None))
        return sch

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the model's device, drawn from `generator`
        (which must live on that device). Same schema and init styles as
        the reference; other numbers (see bridge.py for parity)."""
        return init_from_schema(self.schema(), generator, self.device)

    def shapes(self, device=None) -> dict:
        """The schema as uninitialised tensors of each leaf's shape and
        dtype on `device` (the model's own by default): the counterpart of
        the reference's ShapeDtypeStruct tree, to be called under a
        FakeTensorMode or with device="meta", where nothing is allocated."""
        dev = self.device if device is None else torch.device(device)
        return _map_leaves(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                 device=dev), self.schema())

    def param_count(self) -> int:
        return param_count(self.schema())

    # -- forward -----------------------------------------------------------
    def _layer(self, fn, x, cached: bool = False):
        """fn(x), checkpointed under remat when autograd records a forward
        without a cache (the reference's Model._body). fn binds its layer's
        parameters by value: the backward recomputes it after the loop has
        moved on."""
        if self.remat and not cached and torch.is_grad_enabled():
            return checkpoint(fn, x, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(x)

    def _run_segment(self, seg: Segment, p_seg, x, positions, cache_seg,
                     true_lens=None, cross_src=None):
        kw = dict(positions=positions, window=seg.window, impl=self.impl,
                  ssd_impl=self.ssd_impl, use_pallas=self.use_pallas,
                  true_lens=true_lens, cross_src=cross_src,
                  kv_rep=self.kv_rep, kv_block=self.kv_block,
                  constrain=self.constrain)
        if seg.kind == "vlm":
            return self._run_vlm_segment(seg, p_seg, x, cache_seg, kw)
        for i in range(seg.n):
            p_i = _index(p_seg, i)
            c_i = None if cache_seg is None else _index(cache_seg, i)
            x = self.constrain(self._layer(
                lambda h, p=p_i, c=c_i: apply_block(
                    p, h, self.cfg, seg.kind, cache=c, **kw), x,
                cached=c_i is not None), "residual")
        return x

    def _run_vlm_segment(self, seg: Segment, p_seg, x, cache_seg, kw):
        """The vlm's groups in order: each group's cross_attn_every - 1
        dense blocks, each with its self KV (flat layer g * inner + l of
        the cache's KVCache), then its cross_layer block with the group's
        CrossKV."""
        inner = self.cfg.cross_attn_every - 1
        cached = cache_seg is not None
        for g in range(seg.n):
            p_g = _index(p_seg, g)
            for l in range(inner):
                p_l = _index(p_g["plain"], l)
                c_l = {"attn": cache_seg["attn"].layer(g * inner + l)} \
                    if cached else None
                x = self.constrain(self._layer(
                    lambda h, p=p_l, c=c_l: apply_block(
                        p, h, self.cfg, "dense", cache=c, **kw), x, cached),
                    "residual")
            c_g = {"cross": cache_seg["cross"].layer(g)} if cached else None
            x = self.constrain(self._layer(
                lambda h, p=p_g["cross"], c=c_g: apply_block(
                    p, h, self.cfg, "cross_layer", cache=c, **kw), x,
                cached), "residual")
        return x

    def _embed_in(self, params, tokens, offset=0):
        """Token embeddings, plus sinusoidal positions where the arch has
        no rope (and is not an SSM) at `offset` (an int, or per-lane [B]
        decode positions), cast to the embeddings' dtype."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        if not cfg.use_rope and cfg.family != "ssm":
            x = x + _sinusoid(x.shape[1], cfg.d_model, offset,
                              device=x.device).to(x.dtype)
        return self.constrain(x, "residual")

    def _encode(self, params, frames):
        """The encoder over precomputed frame embeddings [B, S_src, d]:
        sinusoids added in f32 and cast to the frames' dtype, then the
        encoder blocks (non-causal self-attention) and the final norm. It
        runs in the frames' dtype: f32 frames give f32 activations against
        the bf16 weights, as in the reference."""
        cfg = self.cfg
        x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                               device=frames.device).to(frames.dtype)
        x = self.constrain(x, "residual")
        pos = torch.arange(frames.shape[1], device=frames.device)
        blocks = params["encoder"]["blocks"]
        for i in range(cfg.n_encoder_layers):
            p_i = _index(blocks, i)
            x = self.constrain(self._layer(lambda h, p=p_i: apply_block(
                p, h, cfg, "encoder", positions=pos, impl=self.impl,
                causal=False, use_pallas=self.use_pallas), x), "residual")
        return apply_norm(params["encoder"]["ln_f"], x, cfg.norm)

    def _cross_source(self, params, batch):
        """The encoder output for the crossdec blocks, or the image tokens
        through `img_adapter` for the cross_layer blocks (a plain product,
        as in the reference, in the promoted dtype of the embeddings and
        the adapter); None for an arch without cross attention."""
        if self.cfg.family == "vlm":
            if "image_embeds" not in batch:
                raise KeyError(
                    "image_embeds: a vision-language prefill needs the image "
                    "embeddings [B, n_image_tokens, d_model] in the batch "
                    "(serving: Request.extras['image_embeds'])")
            return einsum("bnd,de->bne", batch["image_embeds"],
                          params["img_adapter"])
        if not self.cfg.encoder_decoder:
            return None
        if "frames" not in batch:
            raise KeyError(
                "frames: an encoder-decoder prefill needs the encoder's "
                "input frames [B, S_src, d_model] in the batch (serving: "
                "Request.extras['frames'])")
        return self._encode(params, batch["frames"])

    def forward(self, params, batch, cache: dict | None = None,
                positions=None, true_lens=None):
        """Returns (logits, cache). With a cache, prefill (S > 1) or decode
        (S == 1) writes into it in place and the same object comes back.
        true_lens [B]: per-lane valid lengths of a right-padded (bucketed)
        prefill; the SSM blocks mask their state updates with it and the
        ring caches gather each lane's last-window real tokens, so the
        padding is inert (models/ssm.py::apply_ssm,
        attention.py::RingKVCache.fill_prefill). An encoder-decoder arch
        runs its encoder over batch["frames"] (a vision-language arch
        adapts batch["image_embeds"]) without a cache or when S > 1,
        never at decode (S == 1 with a cache: the cross-attention blocks
        read their cross K/V from the cache, also for a one-token prompt,
        as the reference does)."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        if positions is None:
            positions = torch.arange(S, device=tokens.device)
        x = self._embed_in(params, tokens,
                           offset=positions[..., 0] if S == 1 else 0)
        cross_src = self._cross_source(params, batch) \
            if cache is None or S > 1 else None
        for seg in self.segs:
            cseg = cache.get(seg.name) if cache is not None else None
            x = self._run_segment(seg, params[seg.name], x, positions, cseg,
                                  true_lens, cross_src)
        x = apply_norm(params["ln_f"], x, self.cfg.norm)
        logits = unembed(params["embed"], x, use_pallas=self.use_pallas)
        return self.constrain(logits, "logits"), cache

    # -- training ----------------------------------------------------------
    def loss(self, params, batch):
        """Mean next-token cross entropy of a forward without a cache over
        batch["labels"] (-1 ignored). The batch carries frames or
        image_embeds as it does for forward."""
        logits, _ = self.forward(params, batch)
        return cross_entropy_loss(logits, batch["labels"])

    # -- serving -----------------------------------------------------------
    @property
    def bucketed_prefill_ok(self) -> bool:
        """True when prefill lanes can be right-padded to a bucket length
        without corrupting serving state: KV caches are inert under padding
        (causal masking and the engine's length fixup) and SSM state takes
        masked updates driven by per-lane true lengths. MoE capacity lets
        padding tokens displace real ones, and encoder-decoder prompts
        carry non-token inputs (the frames): those families prefill
        exact-length."""
        return (self.cfg.family in ("dense", "ssm", "hybrid")
                and not self.cfg.encoder_decoder)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   page_size: int | None = None,
                   kv_pages: int | None = None,
                   ring_len: int | None = None, src_len: int = 0) -> dict:
        """Per segment: ssm, an SSMCache; dense and moe, a KVCache (an
        MLACache of the latent when cfg.mla is set); hybrid,
        an SSMCache beside a RingKVCache of min(window, ring_len) slots in
        a window segment and a KVCache in a global one; crossdec, a
        KVCache beside a CrossKV of src_len rows (the encoder's frames);
        vlm, a KVCache of groups x (cross_attn_every - 1) layers beside a
        CrossKV of one layer a group and `src_len or n_image_tokens` rows,
        n_kv_heads wide (the reference's size). ring_len defaults to max_len; the paged engine's prefill transient
        spans a bucket's pages only but keeps the engine's ring width.

        page_size/kv_pages set builds a *paged* cache: every KVCache
        becomes a PagedKVCache over a shared kv_pages-page pool
        (serve/paging.PagePool owns the host-side allocation). SSM state
        and rings are fixed-size per lane, so they stay lane-resident
        either way. Only the bucketed-prefill families page: their prefill
        scatters whole pages of a padded bucket into the pool.

        The vlm node is flat, {"attn": KVCache [groups * inner, B, ...],
        "cross": CrossKV [groups, B, ...]} with inner = cross_attn_every -
        1, where the reference nests {"plain": {"attn": [groups, inner, B,
        ...]}, "cross": {"cross": ...}}: plain layer (g, l) lives at index
        g * inner + l. So every node is {key: stacked cache} with the lane
        axis second, the layout the serve engine's lane helpers walk
        (_write_lane, _copy_lanes, _reset, _fix_lengths, _decode_state),
        and the vlm needs none of its own."""
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
        kv_v = max(1, cfg.n_kv_heads) * self.kv_rep
        dev = self.device
        ring_len = max_len if ring_len is None else ring_len

        def kv(n):
            if page_size is not None:
                return PagedKVCache.zeros(
                    batch, max_len, kv_v, hd, n_pages=kv_pages,
                    page_size=page_size, dtype=dtype, layers=n, device=dev)
            return KVCache.zeros(batch, max_len, kv_v, hd, dtype,
                                 layers=n, device=dev)
        caches: dict = {}
        for seg in self.segs:
            node: dict = {}
            if cfg.mla is not None and seg.kind in ("dense", "moe"):
                node["attn"] = MLACache.zeros(
                    batch, max_len, cfg.mla.kv_lora_rank,
                    cfg.mla.qk_rope_head_dim, dtype, layers=seg.n,
                    device=dev)
            elif seg.kind == "crossdec":
                node["attn"] = kv(seg.n)
                node["cross"] = CrossKV.zeros(batch, src_len, cfg.n_kv_heads,
                                              hd, dtype, layers=seg.n,
                                              device=dev)
            elif seg.kind == "vlm":
                node["attn"] = kv(seg.n * (cfg.cross_attn_every - 1))
                node["cross"] = CrossKV.zeros(
                    batch, src_len or cfg.n_image_tokens, cfg.n_kv_heads, hd,
                    dtype, layers=seg.n, device=dev)
            elif seg.kind != "ssm":
                node["attn"] = kv(seg.n) if seg.window is None else \
                    RingKVCache.zeros(batch, min(seg.window, ring_len),
                                      kv_v, hd, dtype,
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
