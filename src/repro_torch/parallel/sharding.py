"""Logical-axis -> partition-spec rules with divisibility guards, on
DeviceMesh and DTensor (counterpart of repro/parallel/sharding.py).

Every ParamSpec carries logical axis names ("embed", "heads", "ff",
"experts", "vocab", ...). `pspecs_from_schema` maps them onto mesh axes
via PARAM_RULES, dropping any assignment whose dimension is not divisible
by the mesh axis size (whisper's 12 heads or hymba's 25 heads on a 16-way
model axis fall back to replication). The rules and the specs are the
reference's, word for word; a spec is a `P`, a tuple like JAX's
PartitionSpec.

Every function takes a `torch.distributed.device_mesh.DeviceMesh`, or any
object whose `.shape` maps mesh axis names to sizes in mesh order (the
reference's `mesh.shape`; the CPU tests pass such a stand-in). A
DeviceMesh's own `.shape` is a tuple, so sizes are read through
`mesh_shape_dict`.

Where JAX hands a spec to GSPMD through a NamedSharding, the port turns
it into DTensor placements (`placements`), one per mesh dimension:
`distribute_params` is the counterpart of jax.device_put with
NamedShardings, and `make_constrain`'s hook of
jax.lax.with_sharding_constraint. A sum that GSPMD would insert stays a
pending `Partial` placement of the DTensor until it is redistributed.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

from ..launch.mesh import mesh_shape_dict
from ..models.layers import ParamSpec


class P(tuple):
    """A partition spec: one entry per tensor dimension, each None
    (replicated), a mesh axis name, or a tuple of names (one dimension
    sharded over several mesh axes, major to minor). Entries normalise as
    JAX's do: an empty tuple is None, a one-name tuple or list that name."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# parameter logical axes -> preferred mesh axes (in priority order)
PARAM_RULES: dict[str, tuple[str, ...]] = {
    "embed": (),                # replicated (TP shards the other operand dim)
    "ff": ("model",),
    "expert_ff": (),            # experts already shard over model
    "heads": ("model",),
    "kv_heads": ("model",),     # guarded: kv counts rarely divide
    "experts": ("model",),
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "layers": (),
    None: (),
}

# activation tags -> pspec builders
ACT_RULES: dict[str, tuple] = {
    "residual": ("batch", None, None),          # [B, S, D]
    "logits": ("batch", None, "vocab_model"),   # [B, S, V]
}


def _sizes(mesh) -> dict:
    return mesh_shape_dict(mesh)


def _mesh_axis_size(mesh, name: str) -> int:
    sizes = _sizes(mesh)
    return sizes[name] if name in sizes else 0


def batch_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: ('pod', 'data') when multi-pod, else ('data',)."""
    sizes = _sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def pspec_for_axes(axes: tuple, shape: tuple, mesh,
                   rules: dict | None = None) -> P:
    rules = rules or PARAM_RULES
    sizes = _sizes(mesh)
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        assigned: Optional[str] = None
        for cand in rules.get(ax, ()):
            if cand in sizes and cand not in used:
                if dim % sizes[cand] == 0 and dim >= sizes[cand]:
                    assigned = cand
                    used.add(cand)
                    break
        out.append(assigned)
    return P(*out)


def _map_schema(fn, schema):
    if isinstance(schema, ParamSpec):
        return fn(schema)
    return {k: _map_schema(fn, v) for k, v in schema.items()}


def pspecs_from_schema(schema, mesh, rules: dict | None = None):
    return _map_schema(
        lambda s: pspec_for_axes(s.axes, s.shape, mesh, rules), schema)


def fsdp_pspecs_from_schema(schema, mesh, rules: dict | None = None):
    """TP rules + the DP axes sharded onto each param's largest free dim
    (FSDP/ZeRO-3): weights live fully sharded, and are gathered one layer
    at a time in the forward."""
    def spec(s):
        base = pspec_for_axes(s.axes, s.shape, mesh, rules)
        return zero1_pspec(base, s.shape, mesh)
    return _map_schema(spec, schema)


# sequence-parallel attention: q/k/v/o weights replicated (FSDP re-shards
# them over DP), so head-sharding's per-layer [B,S,D]-sized partial-sum
# reductions disappear; only the FFN keeps TP
ATTN_SP_RULES = dict(PARAM_RULES)
ATTN_SP_RULES["heads"] = ()
ATTN_SP_RULES["kv_heads"] = ()


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`, one per mesh dimension
    in mesh order: Shard(d) where tensor dimension d names that mesh axis,
    else Replicate(). A tuple entry shards one tensor dimension over
    several mesh axes; DTensor lays such a dimension out over the mesh
    dimensions in mesh order, major to minor, so the tuple must list them
    in that order (JAX's layout of P(('pod', 'data'))); any other order
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(_sizes(mesh))
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        names = tuple(n for n in names if n is not None)
        if [order.index(n) for n in names] != sorted(
                order.index(n) for n in names):
            raise ValueError(
                f"spec {spec}: dimension {d} lists mesh axes {names} out of "
                f"mesh order {tuple(order)}; DTensor shards major to minor "
                f"in mesh order only")
        for n in names:
            if n in dim_of:
                raise ValueError(f"spec {spec}: mesh axis {n!r} used twice")
            dim_of[n] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in order)


def shardings_from_schema(schema, mesh):
    """The DTensor placements of every leaf (the reference's
    NamedShardings)."""
    return _map_schema(
        lambda s: placements(pspec_for_axes(s.axes, s.shape, mesh), mesh),
        schema)


def distribute_params(params, schema, mesh, rules: dict | None = None,
                      specs=None):
    """Each leaf of `params` (nested dicts of tensors of `schema`'s
    structure) distributed over the DeviceMesh `mesh` by
    torch.distributed.tensor.distribute_tensor with the placements of
    its spec: the counterpart of jax.device_put with NamedShardings. Every
    rank passes the same full tensors; each keeps its shard. The spec of a
    leaf is pspec_for_axes under `rules`, or its entry of `specs` (a tree
    of P of the schema's structure, e.g. fsdp_pspecs_from_schema's)."""
    from torch.distributed.tensor import distribute_tensor

    def walk(p, s, sp):
        if isinstance(s, ParamSpec):
            if tuple(p.shape) != tuple(s.shape):
                raise ValueError(f"leaf of shape {tuple(p.shape)} for a spec "
                                 f"of {s.shape}")
            spec = sp if sp is not None else \
                pspec_for_axes(s.axes, s.shape, mesh, rules)
            return distribute_tensor(p, mesh, placements(spec, mesh))
        if set(p) != set(s):
            raise ValueError(f"params keys {sorted(p)} against schema keys "
                             f"{sorted(s)}")
        return {k: walk(p[k], s[k], None if sp is None else sp[k])
                for k in p}
    return walk(params, schema, specs)


def sharded_step(fn):
    """`fn` (grads_fn's step, a forward) made to run on DTensor
    parameters and batches, unchanged: each call runs under
    torch.distributed.tensor.experimental.implicit_replication, so the
    plain tensors the port makes inside from global shapes (positions,
    rope tables, masks, the online softmax's accumulators, the flash
    backward's dq) meet the DTensors as Replicate, as GSPMD treats such
    constants. The backward runs inside the call too (grads_fn takes
    torch.autograd.grad there)."""
    @functools.wraps(fn)
    def run(*args, **kw):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return fn(*args, **kw)
    return run


def act_pspec(kind: str, mesh, shape: tuple | None = None,
              vocab: int | None = None,
              seq_shard: bool = False) -> P:
    """PartitionSpec for an activation tag. batch -> all DP axes;
    logits vocab dim -> model (if divisible); residual seq -> model when
    sequence parallelism is on."""
    sizes = _sizes(mesh)
    dp = batch_axes(mesh)
    if kind == "residual":
        seq = ("model",) if (seq_shard and "model" in sizes) else None
        return P(dp if dp else None, seq if seq else None, None)
    if kind == "logits":
        vshard = None
        if vocab is not None and "model" in sizes and \
                vocab % sizes["model"] == 0:
            vshard = "model"
        return P(dp if dp else None, None, vshard)
    if kind == "moe_dispatched" and shape is not None:
        # [G, E, C, D]: groups over DP, experts over model (EP)
        e_ok = ("model" in sizes and len(shape) >= 2
                and shape[1] % sizes["model"] == 0)
        g_ok = shape[0] % _dp_size(mesh) == 0
        return P(dp if (dp and g_ok) else None,
                 "model" if e_ok else None, None, None)
    return P()


def _fit(spec: P, ndim: int) -> P:
    if len(spec) > ndim:
        return P(*tuple(spec)[:ndim])
    if len(spec) < ndim:
        return P(*(tuple(spec) + (None,) * (ndim - len(spec))))
    return spec


def make_constrain(mesh, vocab: int, seq_shard: bool = False):
    """The Model's `constrain` hook: a DTensor activation is redistributed
    to the placements of its tag's `act_pspec` (the counterpart of
    with_sharding_constraint; a pending Partial sum is reduced there). A
    plain tensor comes back unchanged: a tensor of one rank has nothing to
    constrain."""
    from torch.distributed.tensor import DTensor

    def constrain(x, kind: str):
        if mesh is None or x.ndim < 2 or not isinstance(x, DTensor):
            return x
        spec = _fit(act_pspec(kind, mesh, shape=tuple(x.shape), vocab=vocab,
                              seq_shard=seq_shard), x.ndim)
        return x.redistribute(x.device_mesh, placements(spec, mesh))
    return constrain


def batch_pspec(mesh, ndim: int = 2) -> P:
    """Input batch arrays: [B, S, ...] with B over all DP axes."""
    dp = batch_axes(mesh)
    return P(dp if dp else None, *([None] * (ndim - 1)))


def batch_sharding(mesh, ndim: int = 2) -> tuple:
    """The placements of an input batch array [B, S, ...] (B over all DP
    axes): the reference's NamedSharding(mesh, batch_pspec(mesh, ndim))."""
    return placements(batch_pspec(mesh, ndim), mesh)


# the dataclass fields cache_pspecs reads, by the rule that places them
_CACHE_FIELDS = ("k", "v", "c_kv", "k_rope", "conv", "state")


def _cache_leaf_spec(field: str, shape: tuple, mesh, dpa, msize: int,
                     mla_seq_shard: bool, kv_seq_shard: bool) -> P:
    nd = len(shape)
    spec = [None] * nd
    dps = _dp_size(mesh)
    if field in ("k", "v"):                # [(L,)B,S,KV,hd]
        b_ax, s_ax, kv_ax = nd - 4, nd - 3, nd - 2
        if shape[b_ax] % dps == 0:
            spec[b_ax] = dpa
        if msize > 1 and shape[kv_ax] % msize == 0:
            spec[kv_ax] = "model"
        elif kv_seq_shard and msize > 1 and \
                shape[s_ax] % msize == 0 and shape[s_ax] > 1:
            # heads that do not divide the model axis: shard the cache's
            # sequence instead
            spec[s_ax] = "model"
    elif field in ("c_kv", "k_rope"):      # [(L,)B,S,R] latent cache
        b_ax, s_ax = nd - 3, nd - 2
        if shape[b_ax] % dps == 0:
            spec[b_ax] = dpa
        if mla_seq_shard and msize > 1 and shape[s_ax] % msize == 0:
            spec[s_ax] = "model"
    elif field == "conv":                  # [(L,)B,K-1,C]
        b_ax, c_ax = nd - 3, nd - 1
        if shape[b_ax] % dps == 0:
            spec[b_ax] = dpa
        if msize > 1 and shape[c_ax] % msize == 0:
            spec[c_ax] = "model"
    elif field == "state":                 # [(L,)B,H,P,N]
        b_ax, h_ax = nd - 4, nd - 3
        if shape[b_ax] % dps == 0:
            spec[b_ax] = dpa
        if msize > 1 and shape[h_ax] % msize == 0:
            spec[h_ax] = "model"
    return P(*spec)


def cache_pspecs(cache_tree, mesh, mla_seq_shard: bool = False,
                 kv_seq_shard: bool = False):
    """PartitionSpecs for a serving cache (built by Model.init_cache): the
    same nested dicts, each cache dataclass (KVCache, RingKVCache,
    PagedKVCache, MLACache, SSMCache, CrossKV) with a P in every field.
    The field name picks the rule and the rank tells stacked from
    unstacked: batch dims shard over the DP axes; KV-head / SSM-head dims
    over `model` when divisible (Model(kv_rep=) widens the decode caches
    so GQA heads divide). Lengths, page tables and anything unknown stay
    replicated. The vlm's cache is flat here ({"attn": [groups * inner,
    B, ...]}) where the reference nests it; each leaf's rule reads its
    last dimensions, so the specs agree but for the one leading axis."""
    dp = batch_axes(mesh)
    dpa = dp if len(dp) > 1 else (dp[0] if dp else None)
    msize = _sizes(mesh).get("model", 1)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: (_cache_leaf_spec(
                    f.name, tuple(getattr(t, f.name).shape), mesh, dpa,
                    msize, mla_seq_shard, kv_seq_shard)
                    if f.name in _CACHE_FIELDS
                    else P(*([None] * getattr(t, f.name).ndim)))
                for f in dataclasses.fields(t)})
        return P(*([None] * t.ndim))
    return walk(cache_tree)


def _dp_size(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= _sizes(mesh)[a]
    return max(1, n)


def zero1_pspec(param_pspec: P, shape: tuple, mesh) -> P:
    """ZeRO-1: optimizer-state sharding — add DP axes onto the largest
    unsharded dim of the param spec (guarded by divisibility)."""
    dp = batch_axes(mesh)
    if not dp:
        return param_pspec
    # idempotent: FSDP param specs already carry the DP axes
    used = set()
    for entry in param_pspec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            used.add(a)
    if any(a in used for a in dp):
        return param_pspec
    dp_size = math.prod(_mesh_axis_size(mesh, a) for a in dp)
    spec = list(param_pspec) + [None] * (len(shape) - len(param_pspec))
    # pick the largest dim currently unsharded and divisible by dp
    best, best_dim = -1, 0
    for i, (d, s) in enumerate(zip(shape, spec)):
        if s is None and d % dp_size == 0 and d > best_dim:
            best, best_dim = i, d
    if best >= 0:
        spec[best] = dp if len(dp) > 1 else dp[0]
    return P(*spec)
