"""Attention forward passes and the dense and paged KV caches (counterpart
of repro/models/attention.py).

Shapes: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] with Hq = G * Hkv (GQA).
Masks come from position comparisons, with the finite NEG_INF = -1e30 of
the reference; q is scaled in its own dtype before QK^T, scores are f32,
and probabilities are cast to q's dtype before PV. These are jnp functions
in the reference, so they are torch ops here; `attention(impl="pallas")`
reaches the flash-attention kernel (kernels/flash_attention).
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEG_INF = -1e30


def _scale_q(q, scale: float):
    # the reference multiplies by a weakly typed scalar, which JAX casts to
    # q's dtype first; a 0-d tensor of q's dtype rounds the same way. It is
    # filled on the device: a CUDA graph must not capture a copy from host
    # memory
    return q * torch.full((), scale, dtype=q.dtype, device=q.device)


def einsum(eq: str, *operands):
    """torch.einsum with JAX's type promotion: operands of mixed float
    dtypes are cast to the wider one first, as jnp.einsum computes them
    (an encoder fed f32 frames runs f32 activations against bf16
    weights, and its f32 cross K/V meet a bf16 decoder query). Operands
    of one dtype pass unchanged. DTensor operands (the sharded step's) go
    through local_einsum."""
    if any(is_dtensor(o) for o in operands):
        return local_einsum(eq, *operands)
    dt = operands[0].dtype
    for o in operands[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in operands))


def is_dtensor(t) -> bool:
    """True for a DTensor (the sharded step's). torch.distributed.tensor is
    imported only when a tensor is not a plain one: the import takes about
    a second."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def replicate_dim(t, dim: int):
    """A DTensor `t` redistributed with axis `dim` replicated (an
    all-gather over the mesh dimensions that shard it); any other tensor
    as it is. The sharded step's explicit redistribution at an op whose
    DTensor sharding rule fails on a sharded axis (split_safe,
    seq_gathered)."""
    if not is_dtensor(t):
        return t
    dim %= t.ndim
    if not any(pl.is_shard(dim) for pl in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_shard(dim) else pl for pl in t.placements])


def lane_shards(dst, *ts):
    """For an in-place cache write of the sharded step: the local shard of
    the DTensor `dst`, then each of `ts` as the part of it that meets
    those rows: a DTensor redistributed to dst's placements on every
    dimension whose size it shares with dst (a replicated tensor is then
    only sliced), replicated on the rest, and made local; anything else as
    it is. DTensor has no sharding rule for an in-place index_put_ into a
    sharded cache, so the writes index the local shards, as GSPMD's
    partitioned dynamic_update_slice writes each device's own rows. A cache
    sharded on a dimension that its update does not share (its sequence)
    is refused."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = dst.device_mesh
    out = [dst.to_local()]
    for t in ts:
        if not isinstance(t, DTensor):
            out.append(t)
            continue
        want = []
        for pl in dst.placements:
            if pl.is_shard() and pl.dim < t.ndim and \
                    t.shape[pl.dim] == dst.shape[pl.dim]:
                want.append(Shard(pl.dim))
            elif pl.is_shard() and pl.dim < t.ndim and pl.dim != 0:
                raise ValueError(
                    f"a cache of {tuple(dst.shape)} sharded on dimension "
                    f"{pl.dim}, which its update {tuple(t.shape)} does not "
                    f"share: only lanes and heads may be sharded")
            else:
                want.append(Replicate())
        out.append(t.redistribute(mesh, want).to_local())
    return out


def _expand_ellipsis(eq: str, operands) -> tuple[list[str], str]:
    """The subscripts of an einsum equation with "..." spelled out in
    letters the equation does not use, and its explicit output."""
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    free = iter(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq)
    n_ell = max((o.ndim - len(sub) + 3 for sub, o in zip(subs, operands)
                 if "..." in sub), default=0)
    ell = "".join(next(free) for _ in range(n_ell))
    subs = [sub.replace("...", ell[n_ell - (o.ndim - len(sub) + 3):])
            for sub, o in zip(subs, operands)]
    return subs, out.replace("...", ell)


def local_einsum(eq: str, *operands):
    """einsum of DTensors computed on their local shards, the sharding
    decided here, as GSPMD partitions a dot, rather than by DTensor's
    rule for each op the einsum decomposes into (which may shard an output
    over a mesh axis that no operand shards and then fail to split it
    into heads, "Cannot unflatten unevenly sharded tensor", and on a 3-D
    mesh spends minutes planning redistributions). On each mesh axis:

    - the first operand that shards an output index keeps it: every
      operand holding that index is sliced to match, every other sharding
      on the axis is gathered, and the output is sharded there;
    - else a contracted index that an operand shards is kept the same way
      and the output is a pending sum (Partial) over the axis, as a
      row-parallel product leaves it;
    - else everything is gathered and the output replicated.

    An operand's gradient comes back sharded as it was taken where it
    holds the kept index, as a pending sum where it does not (it saw only
    its slice), else replicated. Pending sums and strided shards of the
    operands are reduced or gathered first. Plain tensors meet the
    DTensors as replicated. Mixed float dtypes promote as in `einsum`."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    subs, out = _expand_ellipsis(eq, operands)
    mesh = next(o.device_mesh for o in operands if is_dtensor(o))
    dt = operands[0].dtype
    for o in operands[1:]:
        dt = torch.promote_types(dt, o.dtype)
    ops = []
    for o in operands:
        if not is_dtensor(o):
            o = DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        plain = [pl if type(pl) in (Shard, Replicate) else Replicate()
                 for pl in o.placements]
        if plain != list(o.placements):
            o = o.redistribute(mesh, plain)
        ops.append(o)

    def sharded(m):
        return [sub[o.placements[m].dim] if o.placements[m].is_shard()
                else None for o, sub in zip(ops, subs)]
    kept = []                       # per mesh axis: the kept index or None
    for m in range(mesh.ndim):
        letters = [c for c in sharded(m) if c is not None]
        keep = next((c for c in letters if c in out), None)
        if keep is None and letters:
            keep = letters[0]
        kept.append(keep)
    sizes: dict[str, int] = {}
    locals_ = []
    for o, sub in zip(ops, subs):
        sizes.update(zip(sub, o.shape))
        want, grad = [], []
        for m, k in enumerate(kept):
            if k is not None and k in sub:
                want.append(Shard(sub.index(k)))
                grad.append(Shard(sub.index(k)))
            else:
                want.append(Replicate())
                grad.append(Partial() if k is not None else Replicate())
        if list(o.placements) != want:
            o = o.redistribute(mesh, want)
        locals_.append(o.to_local(grad_placements=grad).to(dt))
    y = torch.einsum(",".join(subs) + "->" + out, *locals_)
    shape = torch.Size(sizes[c] for c in out)
    placements = [Shard(out.index(k)) if k is not None and k in out
                  else (Partial() if k is not None else Replicate())
                  for k in kept]
    return DTensor.from_local(y, mesh, placements, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of `shape` (a DTensor's global
    strides, given to from_local without making a tensor)."""
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def grad_as_forward(t):
    """t as it is, its gradient brought back to t's own placements where t
    is a DTensor. DTensor's backward may hand a reshape's output a
    gradient sharded where the output was not (a product's rule shards it
    over a free mesh axis), and the reshape's backward then cannot split
    that axis back into heads that do not divide it."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.to_local(grad_placements=t.placements),
                              t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def split_safe(t, dim: int, parts: int):
    """t with axis `dim` replicated where it is a DTensor sharded into a
    number of shards that does not divide `parts`, the heads the axis is
    split into or merged from by a reshape: DTensor reshapes a sharded
    axis only when its leading factor divides over the shards ("Cannot
    unflatten unevenly sharded tensor"; hymba's 5 K/V heads or 50 SSM
    heads on a 16-way model axis). Anything else as it is."""
    if not is_dtensor(t):
        return t
    dim %= t.ndim
    ways = 1
    for pl, n in zip(t.placements, t.device_mesh.shape):
        if pl.is_shard(dim):
            ways *= n
    return replicate_dim(t, dim) if parts % ways else t


def gqa_heads(*ts, n_kv: int):
    """The attention's [B, S, H, D] operands with the head axis replicated
    where its sharding does not divide the n_kv K/V heads, which the GQA
    view [B, S, Hq, D] -> [B, S, Hkv, G, D] splits out (split_safe).
    Heads that divide stay sharded, and the attention runs head-parallel,
    as GSPMD runs it. Query heads that divide where the K/V heads do not
    never reach here: the entry points run them on their local shards
    (query_head_dims, on_query_shards)."""
    return tuple(split_safe(t, 2, n_kv) for t in ts)


def query_head_dims(q, k, v) -> tuple[int, ...]:
    """The mesh dimensions that split the heads of a DTensor query q [B,
    S, Hq, D] where that split divides Hq but not the Hkv heads of k and
    v: GSPMD splits one mesh axis over (Hkv, G) there, which DTensor
    cannot. Empty (the attention then takes gqa_heads) for a plain q, a
    split that divides Hkv too (head-parallel) or not Hq (gathered), and
    where q or the K/V hold any other placement than a batch or head
    split (a sequence-sharded cache keeps its own path)."""
    if not is_dtensor(q):
        return ()
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    dims = tuple(i for i, pl in enumerate(q.placements)
                 if type(pl) is Shard and pl.dim % q.ndim == 2)
    ways = math.prod(mesh.size(i) for i in dims)
    if ways == 1 or q.shape[2] % ways or k.shape[2] % ways == 0:
        return ()
    for t in (q, k, v):
        if is_dtensor(t) and any(
                type(pl) is not Replicate and not (
                    type(pl) is Shard and pl.dim % t.ndim in (0, 2))
                for pl in t.placements):
            return ()
    return dims


def on_query_shards(fn, q, k, v, dims, rows=()):
    """fn(q, k, v, *rows) of the sharded step where the query heads stay
    split over the mesh dimensions `dims` (query_head_dims), computed on
    each rank's local tensors: q's shard of Hq / m heads [h0, h0 + Hq /
    m), the whole K and V (they hold the Hkv heads only) narrowed to the
    heads those query heads read (query head h reads K/V head h // G: one
    head where the rank's heads share it, else one per query head, G 1),
    and each of `rows` (tensors led by the batch axis, 0-d tensors, None)
    cut to the rank's batch. The batch keeps q's data split. The output
    [B, S, Hq, Dv] keeps q's placements; q's gradient comes back split
    like q, K's and V's as sums pending (Partial) over `dims` (each rank
    saw only its query heads), reduced where they meet the K/V's
    producers."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    B, S, Hq = q.shape[:3]
    Hkv = k.shape[2]
    batch = [type(pl) is Shard and pl.dim % q.ndim == 0
             for pl in q.placements]
    tq = [Shard(2) if i in dims else Shard(0) if batch[i] else Replicate()
          for i in range(mesh.ndim)]
    tkv = [Shard(0) if batch[i] else Replicate() for i in range(mesh.ndim)]
    gkv = [Partial() if i in dims else pl for i, pl in enumerate(tkv)]

    def local(t, want, grad=None):
        if not isinstance(t, torch.Tensor):
            return t
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if t.ndim == 0:
            want = [Replicate()] * mesh.ndim
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local(grad_placements=grad or want)

    ql = local(q, tq)
    kl, vl = local(k, tkv, gkv), local(v, tkv, gkv)
    hl = ql.shape[2]
    rank = 0
    for i in dims:
        rank = rank * mesh.size(i) + mesh.get_local_rank(i)
    G = Hq // Hkv
    first, last = rank * hl // G, (rank * hl + hl - 1) // G
    if first == last:
        kl, vl = kl[:, :, first:first + 1], vl[:, :, first:first + 1]
    else:
        idx = torch.div(rank * hl + torch.arange(hl, device=kl.device), G,
                        rounding_mode="floor")
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    out = fn(ql, kl, vl, *(local(t, tkv) for t in rows))
    shape = torch.Size((B, S, Hq, out.shape[-1]))
    return DTensor.from_local(out, mesh, tq, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def seq_gathered(h):
    """A block's normed input [B, S, D] with its sequence axis replicated
    where it is a DTensor: under sequence parallelism (make_constrain's
    seq_shard) the residual is sharded over S, and the block's
    projections take it gathered, as Megatron-style sequence parallelism
    all-gathers before a block (the block's output is scattered back at
    the next constrain). DTensor's own rule fails there: an einsum
    flattens B and S, both sharded, and cannot unflatten its output's
    heads when they are fewer than the model axis. Plain tensors pass
    unchanged."""
    return replicate_dim(h, 1)


def _gqa_scores(q, k):
    """q [B,Sq,Hkv,G,D] x k [B,Skv,Hkv,D] -> [B,Hkv,G,Sq,Skv]."""
    return einsum("bqhgd,bkhd->bhgqk", q, k)


def _gqa_out(p, v):
    """p [B,Hkv,G,Sq,Skv] x v [B,Skv,Hkv,D] -> [B,Sq,Hkv,G,D]."""
    return einsum("bhgqk,bkhd->bqhgd", p, v)


def _mask_ok(q_pos, k_pos, causal: bool, window: int | None):
    """[Sq, Skv] bool: which (query, key) pairs may attend."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return ok


def _state_like(qg, fill: float, width: int | None = None):
    """f32 online-softmax state [B, Hkv, G, Sq] (with width, [B, Hkv, G,
    Sq, width]) filled with `fill`, made like qg [B, Sq, Hkv, G, D]: a
    DTensor query's state keeps its batch and head sharding, where a fresh
    tensor of the global shape would be whole on every rank."""
    st = torch.full_like(qg.permute(0, 2, 3, 1, 4)[..., 0], fill,
                         dtype=torch.float32)
    return st if width is None else st[..., None].expand(*st.shape, width)


def _forward_blocks(q, k, v, *, causal, window, q_offset, kv_block, scale,
                    kv_valid_len):
    """The online-softmax loop over KV blocks: (acc [B,Hkv,G,Sq,Dv], m, l
    [B,Hkv,G,Sq]) in f32. A short last block stands in for the
    reference's zero padding, whose keys are masked and add exact zeros."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    q, k, v = gqa_heads(q, k, v, n_kv=Hkv)
    qg = _scale_q(q, scale).reshape(B, Sq, Hkv, G, D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    acc = _state_like(qg, 0.0, Dv)
    m = _state_like(qg, NEG_INF)
    l = _state_like(qg, 0.0)
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
    return acc, m, l


def _out_of(acc, l, q):
    """acc / max(l, 1e-30) as [B, Sq, Hq, Dv] in q's dtype."""
    B, Hkv, G, Sq, Dv = acc.shape
    out = acc / torch.clamp_min(l, 1e-30)[..., None]        # [B,Hkv,G,Sq,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * G, Dv).to(q.dtype)


def _scale_of(q, softmax_scale):
    return softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0,
                      kv_block: int = 1024, softmax_scale: float | None = None,
                      kv_valid_len=None):
    """Online-softmax attention over KV blocks. Where the reference takes
    its flash custom VJP (no window, no kv_valid_len, q_offset 0) and a
    gradient can flow (grad mode on, an input requiring grad), this takes
    `_FlashVJP`: the same forward, which saves only (q, k, v, out, L) and
    recomputes the scores blockwise in the backward. Every other case is
    the forward loop, which autograd differentiates as JAX's autodiff does
    the reference's; with no gradient to take, the flash case runs the
    same loop without L. A DTensor query whose head split divides Hq but
    not Hkv runs on its local heads (on_query_shards), the flash forward
    and backward with it."""
    dims = query_head_dims(q, k, v)
    if dims:
        return on_query_shards(
            lambda q, k, v, n: chunked_attention(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                kv_block=kv_block, softmax_scale=softmax_scale,
                kv_valid_len=n), q, k, v, dims, rows=(kv_valid_len,))
    if (window is None and kv_valid_len is None and q_offset == 0
            and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _FlashVJP.apply(q, k, v, causal, kv_block, softmax_scale)
    acc, _, l = _forward_blocks(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_block=kv_block,
                                scale=_scale_of(q, softmax_scale),
                                kv_valid_len=kv_valid_len)
    return _out_of(acc, l, q)


# ---------------------------------------------------------------------------
# flash attention with a flash backward (the reference's custom VJP)
# ---------------------------------------------------------------------------

def _flash_fwd_pass(q, k, v, causal, kv_block, softmax_scale):
    """The forward of the flash VJP: (out, L), L = m + log(max(l, 1e-30))
    the rowwise logsumexp of the scaled scores, [B, Hkv, G, Sq] in f32.
    Its arithmetic is chunked_attention's."""
    acc, m, l = _forward_blocks(q, k, v, causal=causal, window=None,
                                q_offset=0, kv_block=kv_block,
                                scale=_scale_of(q, softmax_scale),
                                kv_valid_len=None)
    return _out_of(acc, l, q), m + torch.log(torch.clamp_min(l, 1e-30))


def _flash_bwd_pass(q, k, v, out, L, dout, causal, kv_block,
                    softmax_scale):
    """Flash backward, at the reference's rounding points
    (repro/models/attention.py::_flash_vjp_bwd): per KV block the scores
    from the *unscaled* q, times scale in f32, masked (causal) and
    exponentiated against L; dv from p in dO's dtype; dp in f32; ds = p
    (dp - delta) scale, delta = rowsum(dO O) in f32, cast to q's dtype
    for dk (against the unscaled q) and dq (summed in f32 over the blocks,
    cast at the end). D may differ from Dv (MLA). Mixed dtypes (a bf16
    query against an f32 encoder's K/V) promote as jnp.einsum does."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = _scale_of(q, softmax_scale)
    q, k, v, out, dout = gqa_heads(q, k, v, out, dout, n_kv=Hkv)
    qg = q.reshape(B, Sq, Hkv, G, D)
    dog = dout.reshape(B, Sq, Hkv, G, Dv)
    delta = einsum("bqhgd,bqhgd->bhgq", dog.float(),
                   out.reshape(B, Sq, Hkv, G, Dv).float())
    q_pos = torch.arange(Sq, device=q.device)
    dq = torch.zeros_like(qg, dtype=torch.float32)
    dks, dvs = [], []
    for start in range(0, Skv, kv_block):
        kblk = k[:, start:start + kv_block]
        vblk = v[:, start:start + kv_block]
        k_pos = start + torch.arange(kblk.shape[1], device=q.device)
        s = _gqa_scores(qg, kblk).float() * scale
        if causal:
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        p = torch.exp(s - L[..., None])                      # [B,Hkv,G,Sq,kb]
        dvs.append(einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype), dog))
        dp = einsum("bqhgd,bkhd->bhgqk", dog, vblk).float()
        dsq = (p * (dp - delta[..., None]) * scale).to(q.dtype)
        dq = dq + einsum("bhgqk,bkhd->bqhgd", dsq, kblk).float()
        dks.append(einsum("bhgqk,bqhgd->bkhd", dsq, qg))
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _FlashVJP(torch.autograd.Function):
    """chunked_attention with the flash backward: the forward saves (q, k,
    v, out, L), O(S D) with no score-sized tensor; the backward recomputes
    the scores block by block (_flash_bwd_pass)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_block, softmax_scale):
        out, L = _flash_fwd_pass(q, k, v, causal, kv_block, softmax_scale)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.args = (causal, kv_block, softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, L = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_pass(q, k, v, out, L, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    softmax_scale=None, kv_valid_len=None):
    """Reference implementation (materializes [Sq, Skv] scores). A
    DTensor query whose head split divides Hq but not Hkv runs on its
    local heads (on_query_shards)."""
    dims = query_head_dims(q, k, v)
    if dims:
        return on_query_shards(
            lambda q, k, v, n: naive_attention(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                softmax_scale=softmax_scale, kv_valid_len=n), q, k, v, dims,
            rows=(kv_valid_len,))
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    q, k, v = gqa_heads(q, k, v, n_kv=Hkv)
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


def attention(q, k, v, *, impl: str = "chunked", causal: bool = True,
              window: int | None = None, kv_block: int = 1024):
    """Prefill attention by implementation: "chunked" (torch ops over KV
    blocks of kv_block keys) or "pallas" (the flash-attention kernel on
    the card, its plain version on the CPU; kv_block does not reach it,
    as in the reference)."""
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 kv_block=kv_block)
    if impl == "pallas":
        # imported here: the kernel's plain version imports this module
        from ..kernels.flash_attention import ops as fl
        return fl.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(impl)


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
        s = k_new.shape[1]
        if is_dtensor(self.k):
            k, v, k_new, v_new, length = lane_shards(
                self.k, self.v, k_new, v_new, self.length)
            KVCache(k, v, length.clone()).append(k_new, v_new)
            self.length += s
            return
        B = k_new.shape[0]
        start = torch.clamp(self.length, 0, self.k.shape[1] - s)     # [B]
        rows = torch.arange(B, device=k_new.device)[:, None]
        cols = start[:, None] + torch.arange(s, device=k_new.device)[None, :]
        self.k[rows, cols] = k_new
        self.v[rows, cols] = v_new
        self.length += s


@dataclasses.dataclass
class RingKVCache:
    """Sliding-window ring buffer (window-sized memory for the SWA layers of
    the hybrid family), updated in place. `k`/`v`: [(L,) B, W, H, D], token
    p of a lane in slot p % W; `length`: [(L,) B] tokens seen per lane.
    Not a KVCache: the engine's length fixup must leave its lengths alone
    (a bucketed prefill sets them to the true lengths itself)."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def zeros(batch, window, n_kv, head_dim, dtype=torch.bfloat16,
              layers: int | None = None, device=None):
        shape = (batch, window, n_kv, head_dim)
        lshape: tuple[int, ...] = (batch,)
        if layers:
            shape = (layers,) + shape
            lshape = (layers, batch)
        return RingKVCache(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(lshape, dtype=torch.int64,
                                       device=device))

    @property
    def window(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "RingKVCache":
        """Layer i of a stacked cache, as views: writes land in the stack."""
        return RingKVCache(self.k[i], self.v[i], self.length[i])

    def append_token(self, k_new, v_new) -> None:
        """Decode-step write of [B, 1, H, D] into each lane's slot
        length % W, in place; `length` advances by 1."""
        if is_dtensor(self.k):
            k, v, k_new, v_new, length = lane_shards(
                self.k, self.v, k_new, v_new, self.length)
            RingKVCache(k, v, length.clone()).append_token(k_new, v_new)
            self.length += 1
            return
        rows = torch.arange(k_new.shape[0], device=k_new.device)
        slot = self.length % self.window
        self.k[rows, slot] = k_new[:, 0].to(self.k.dtype)
        self.v[rows, slot] = v_new[:, 0].to(self.v.dtype)
        self.length += 1

    def positions(self) -> torch.Tensor:
        """Absolute position held in each slot per lane, [B, W] (-1 where
        the slot is invalid: never written, or older than the window)."""
        W = self.window
        slots = torch.arange(W, device=self.length.device)[None, :]
        newest = (self.length - 1)[:, None]                  # [B, 1]
        pos = newest - (newest % W - slots) % W
        return torch.where((pos >= 0) & (pos > newest - W), pos, -1)

    def fill_prefill(self, k, v, true_lens=None) -> None:
        """Prefill of [B, S, H, D] keys and values, in place. With
        true_lens [B] (a right-padded bucket), each lane's last-window
        real tokens are gathered into their slots (token p -> slot p % W;
        slot s holds the newest real position congruent to s, and a slot
        older than the window or before position 0 is zero), and `length`
        becomes true_lens. Without (exact length), the last W tokens are
        kept, rolled so that token p lands in slot p % W, and `length`
        becomes S. Nothing is read back to the host."""
        if is_dtensor(self.k):
            kl, vl, k, v, tl = lane_shards(self.k, self.v, k, v, true_lens)
            RingKVCache(kl, vl, kl.new_zeros(kl.shape[0], dtype=torch.int64)
                        ).fill_prefill(k, v, tl)
            if true_lens is None:
                self.length.fill_(k.shape[1])
            else:
                self.length.copy_(true_lens)
            return
        W = self.window
        B, S = k.shape[0], k.shape[1]
        if true_lens is not None:
            last = (true_lens - 1)[:, None]                      # [B, 1]
            slots = torch.arange(W, device=k.device)[None, :]    # [1, W]
            pos = last - (last - slots) % W                      # [B, W]
            valid = ((pos >= 0) & (pos > last - W))[..., None, None]
            idx = pos.clamp(0, S - 1)
            rows = torch.arange(B, device=k.device)[:, None]
            for buf, new in ((self.k, k), (self.v, v)):
                buf.copy_(torch.where(valid, new[rows, idx], 0))
            self.length.copy_(true_lens)
            return
        for buf, new in ((self.k, k), (self.v, v)):
            kept = new[:, -W:]
            if kept.shape[1] < W:        # S < W: the tokens sit at slot p
                buf.zero_()
                buf[:, :kept.shape[1]] = kept
            else:
                buf.copy_(torch.roll(kept, S % W, dims=1))
        self.length.fill_(S)


@dataclasses.dataclass
class PagedKVCache:
    """Pooled (paged) KV cache for serving, updated in place: device memory
    scales with the pages mapped, not `slots x max_len`.

    `k`/`v`: [(L,) n_pages + 1, page_size, H, D], a pool of pages shared by
    every lane plus one scratch page at index `n_pages`. `page_table`:
    [B, P_max] int64, position-ordered: entry j of lane b names the pool
    page that holds that lane's tokens [j*page_size, (j+1)*page_size). The
    sentinel id `n_pages` marks an unmapped entry. `length`: [(L,) B] filled
    tokens per lane, as KVCache.length.

    The reference lets JAX drop every write routed through the sentinel
    (`mode="drop"`); torch has no drop mode, so such writes land in the
    scratch page instead, which nothing reads: a lane writes only into
    pages its table maps, or into scratch. One page table serves every
    layer (the reference broadcasts it across L).
    """
    k: torch.Tensor
    v: torch.Tensor
    page_table: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def zeros(batch, max_len, n_kv, head_dim, *, n_pages, page_size,
              dtype=torch.bfloat16, layers: int | None = None, device=None):
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        shape = (n_pages + 1, page_size, n_kv, head_dim)
        lshape: tuple[int, ...] = (batch,)
        if layers:
            shape = (layers,) + shape
            lshape = (layers, batch)
        return PagedKVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.full((batch, max_len // page_size), n_pages,
                       dtype=torch.int64, device=device),
            torch.zeros(lshape, dtype=torch.int64, device=device))

    @property
    def n_pages(self) -> int:
        return self.k.shape[-4] - 1          # the scratch page is not a page

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "PagedKVCache":
        """Layer i of a stacked cache, as views: writes land in the stack."""
        return PagedKVCache(self.k[i], self.v[i], self.page_table,
                            self.length[i])

    def append(self, k_new, v_new) -> None:
        """Decode-step write of [B, 1, H, D] at each lane's position
        `length`, inside the page the table maps it to, in place; `length`
        advances by 1. A position past the lane's mapped pages (an empty
        slot, or a lane decoding inertly after it finished) resolves to the
        sentinel, whose write lands in the scratch page."""
        ps, P = self.page_size, self.page_table.shape[1]
        col = torch.div(self.length, ps, rounding_mode="floor")      # [B]
        page = self.page_table.gather(1, col.clamp(max=P - 1)[:, None])[:, 0]
        page = torch.where(col < P, page, self.n_pages)
        slot = self.length % ps
        self.k[page, slot] = k_new[:, 0].to(self.k.dtype)
        self.v[page, slot] = v_new[:, 0].to(self.v.dtype)
        self.length += k_new.shape[1]

    def flat_view(self):
        """Gather by page table: dense [B, P_max*page_size, H, D] views of
        k/v and absolute positions [B, P_max*page_size] (-1 on unmapped
        pages and past-length slots, the decode_attention mask contract).
        Unmapped entries read page n_pages - 1 (never the scratch page) and
        are masked, as in the reference; every masked slot is also zeroed,
        so whatever a page not owned by the lane holds never reaches the
        arithmetic. The view is position-ordered, so decode attention over
        it computes what it computes over the dense KVCache."""
        pt = self.page_table                               # [B, P]
        B, P = pt.shape
        ps = self.page_size
        safe = pt.clamp(max=self.n_pages - 1)
        t = torch.arange(P * ps, device=pt.device)[None, :]
        mapped = (pt < self.n_pages).repeat_interleave(ps, dim=1)
        valid = mapped & (t < self.length[:, None])
        k_pos = torch.where(valid, t, -1)
        masked = ~valid[:, :, None, None]
        k = self.k[safe].reshape(B, P * ps, *self.k.shape[-2:])
        v = self.v[safe].reshape(B, P * ps, *self.v.shape[-2:])
        return k.masked_fill(masked, 0), v.masked_fill(masked, 0), k_pos

    def scatter_prefill(self, lane: KVCache, dest_pages, slot_ids,
                        true_lens) -> None:
        """Page-granular scatter of a dense transient prefill cache into
        the pool, in place. `lane` is a KVCache over the full lane batch
        ([(L,) B, S, H, D], S = P*page_size with P <= P_max: the engine's
        transient spans the prefill bucket's pages only); `dest_pages`
        [B, P] maps lane g's page j to a pool page (sentinel entries, for
        pad lanes and pages past the prompt, land in scratch). `slot_ids`
        [B] routes lane g's true length to its engine slot (negative = pad
        lane, no write). Garbage past a lane's true length inside its last
        mapped page is masked by `length` and overwritten by decode."""
        ps = self.page_size
        P = dest_pages.shape[-1]
        for pool, lk in ((self.k, lane.k), (self.v, lane.v)):
            shp = lk.shape
            pages = lk.reshape(shp[:-3] + (P, ps) + shp[-2:]).to(pool.dtype)
            if pool.dim() == 5:                   # stacked [L, n_pages+1, ...]
                pool[:, dest_pages] = pages
            else:
                pool[dest_pages] = pages
        # length[..., slot_ids[g]] = true_lens[g] for real lanes, without
        # reading slot_ids back to the host
        n_slots = self.length.shape[-1]
        hit = slot_ids[:, None] == torch.arange(n_slots,
                                                device=slot_ids.device)
        new = (hit * true_lens[:, None].to(self.length.dtype)).sum(0)
        self.length.copy_(torch.where(hit.any(0), new, self.length))


def decode_attention(q, cache_k, cache_v, k_pos, q_pos, *,
                     softmax_scale=None, window: int | None = None):
    """Single-token decode against a cache. q [B,1,Hq,D]; cache [B,S,Hkv,D];
    k_pos [S] or [B,S] absolute positions (-1 = invalid slot); q_pos a
    scalar or [B] (per-lane positions). A DTensor query whose head split
    divides Hq but not Hkv (where kv_rep leaves Hkv undivided) runs on
    its local heads (on_query_shards)."""
    B, _, Hq, D = q.shape
    Hkv = cache_k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    k_pos = torch.as_tensor(k_pos, device=q.device)
    k_pos = torch.atleast_2d(k_pos).expand(B, cache_k.shape[1])
    q_pos = torch.as_tensor(q_pos, device=q.device).expand(B)
    dims = query_head_dims(q, cache_k, cache_v)
    if dims:
        return on_query_shards(
            lambda q, k, v, kp, qp: decode_attention(
                q, k, v, kp, qp, softmax_scale=scale, window=window),
            q, cache_k, cache_v, dims, rows=(k_pos, q_pos))
    q, cache_k, cache_v = gqa_heads(q, cache_k, cache_v, n_kv=Hkv)
    qg = _scale_q(q, scale).reshape(B, 1, Hkv, G, D)
    s = _gqa_scores(qg, cache_k).float()                    # [B,Hkv,G,1,S]
    q_pos = q_pos[:, None]
    ok = (k_pos >= 0) & (k_pos <= q_pos)
    if window is not None:
        ok &= (q_pos - k_pos) < window
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = _gqa_out(p, cache_v)                              # [B,1,Hkv,G,Dv]
    return out.reshape(B, 1, Hq, cache_v.shape[-1]).to(q.dtype)
