"""Common layers and the parameter schema (counterpart of
repro/models/layers.py).

A model declares a *schema*: nested dicts of `ParamSpec`s with shape,
logical axis names, init style and dtype. The axis names ("embed", "heads",
"ff", "experts", "vocab", ...) are the reference's; parallel/sharding.py
maps them onto mesh dimensions. `init_from_schema` materializes it on a
device from a `torch.Generator`, with the JAX package's init styles
(normal with fan-in scale, ones, zeros). The numbers differ from
`jax.random`'s, so parity tests convert the reference's own parameters
instead (bridge.py).

Layers are plain functions over dicts of tensors. Where the result depends
on the order of rounding, they follow the reference step for step.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels.systolic_gemm.guard import active_guard
from .attention import contiguous_stride, einsum, is_dtensor
from ..kernels.systolic_gemm.ops import fused_lane_gemm, fused_lane_gemm_t


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...] | None = None   # logical axis names;
    # None: one unnamed axis per dimension
    init: str = "normal"                  # normal | zeros | ones
    scale: float | None = None            # stddev; default fan-in
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    scale = spec.scale
    if scale is None:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    # one matrix (the last two axes) at a time, so the f32 staging is one
    # matrix: dbrx-132b's stacked experts hold 8.5 G elements per
    # projection at 8 layers, 34 GB in f32 drawn whole
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for m in out.view(-1, *spec.shape[-2:]):
        m.copy_(torch.randn(m.shape, generator=generator, dtype=torch.float32,
                            device=device).mul_(scale))
    return out


def init_from_schema(schema: dict, generator: torch.Generator, device):
    """Materialize a schema, leaf by leaf in sorted key order (the order
    jax.tree flattens dicts in), drawing from `generator`."""
    if isinstance(schema, ParamSpec):
        return _init_leaf(schema, generator, device)
    return {k: init_from_schema(schema[k], generator, device)
            for k in sorted(schema)}


def param_count(schema: dict) -> int:
    if isinstance(schema, ParamSpec):
        return math.prod(schema.shape)
    return sum(param_count(v) for v in schema.values())


# --------------------------------------------------------------------------
# primitive layers
# --------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6):
    """Statistics in f32, cast back to x's dtype, then times w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


def norm_schema(d: int, kind: str) -> dict:
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones"),
                "bias": ParamSpec((d,), ("embed",), init="zeros")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def apply_norm(p: dict, x, kind: str):
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=device), exps)


def apply_rope(x, positions, theta: float):
    """Split-half RoPE in f32. x: [..., S, H, hd]; positions broadcastable
    to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., :, None].float() * freqs            # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]                    # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def pod_dense(x, w, *, activation: str | None = None):
    """One dense projection on the pod GEMM, in fused-lane form: every
    leading axis of x folds into M, and trailing axes of w past the
    contraction fold into N and unfold on return ([d, H, hd] heads).
    `activation` runs in the kernel's fused epilogue. Under an active
    GuardTape (guard.py) the GEMM runs guarded, the activation after it."""
    k = x.shape[-1]
    out = fused_lane_gemm(x, w.reshape(k, -1), activation=activation,
                          out_dtype=x.dtype, guard=active_guard())
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def activation_fn(name: str):
    if name == "silu":
        return lambda x: x * torch.sigmoid(x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(name)


def mlp_schema(d_model: int, d_ff: int, activation: str,
               layers: int | None = None) -> dict:
    """Gated (GLU) for silu archs; plain up/down for relu2/gelu."""
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    sch = {"up": ParamSpec(lead + (d_model, d_ff), la + ("embed", "ff")),
           "down": ParamSpec(lead + (d_ff, d_model), la + ("ff", "embed"))}
    if activation in ("silu",):
        sch["gate"] = ParamSpec(lead + (d_model, d_ff), la + ("embed", "ff"))
    return sch


def apply_mlp(p: dict, x, activation: str, use_pallas: bool = False):
    if use_pallas:
        # up without activation, then gate with the activation fused in the
        # epilogue; their product in x's dtype, then down
        up = pod_dense(x, p["up"],
                       activation=None if "gate" in p else activation)
        if "gate" in p:
            up = pod_dense(x, p["gate"], activation=activation) * up
        return pod_dense(up, p["down"])
    act = activation_fn(activation)
    up = einsum("...d,df->...f", x, p["up"])
    if "gate" in p:
        up = act(einsum("...d,df->...f", x, p["gate"])) * up
    else:
        up = act(up)
    return einsum("...f,fd->...d", up, p["down"])


def embed_schema(vocab: int, d_model: int, tie: bool) -> dict:
    sch = {"tok": ParamSpec((vocab, d_model), ("vocab", "embed"), scale=1.0)}
    if not tie:
        sch["unembed"] = ParamSpec((d_model, vocab), ("embed", "vocab"))
    return sch


def embed(p: dict, tokens):
    """The token table's rows. A DTensor batch (the sharded step's) looks
    its rows up on each rank from its own ids and the table gathered whole
    (as FSDP gathers a weight), and the rows come back in the ids'
    placements; the table's gradient is then each rank's rows summed
    across the ranks that hold other ids. DTensor's rule for the lookup's
    backward (aten.index_put with accumulate, its indices sharded over
    data) fails in torch 2.11 ("Shard dim -1 ... must be normalized"), so
    the lookup runs on the local shards."""
    if not is_dtensor(tokens):
        return p["tok"][tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = tokens.device_mesh
    table = p["tok"]
    if not is_dtensor(table):
        table = DTensor.from_local(table, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    table = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad = [Partial() if pl.is_shard() else Replicate()
            for pl in tokens.placements]
    rows = table.to_local(grad_placements=grad)[tokens.to_local()]
    shape = tuple(tokens.shape) + (table.shape[-1],)
    return DTensor.from_local(rows, mesh, tokens.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def unembed(p: dict, x, use_pallas: bool = False):
    """Hidden states -> logits, the largest GEMM of a decode step. Under
    use_pallas the untied [d, vocab] head runs on the fused-lane pod GEMM,
    tied embeddings on its transposed-weight form, which reads the stored
    [vocab, d] token table directly (no transpose copy). Under an active
    GuardTape either form runs guarded."""
    if use_pallas:
        g = active_guard()
        if "unembed" in p:
            return fused_lane_gemm(x, p["unembed"], out_dtype=x.dtype,
                                   guard=g)
        return fused_lane_gemm_t(x, p["tok"], out_dtype=x.dtype, guard=g)
    if "unembed" in p:
        return einsum("...d,dv->...v", _head_input(x, p["unembed"], 1),
                      p["unembed"])
    return einsum("...d,vd->...v", _head_input(x, p["tok"], 0), p["tok"])


def _head_input(x, w, vdim: int):
    """The head's input [B, S, d] with its sequence gathered over the mesh
    axes on which the DTensor weight `w` splits its vocabulary (axis vdim)
    and x its sequence (sequence parallelism): the product keeps one split
    an axis, and the sequence, d wide, is the cheap one to gather, so the
    logits come out split over the vocabulary as the "logits" constraint
    places them, as GSPMD partitions it, rather than re-split from the
    sequence (an all-to-all of the logits, which a CPU mesh runs as an
    all-gather of them whole). Anything else as it is."""
    if not (is_dtensor(x) and is_dtensor(w)) or x.ndim < 3:
        return x
    from torch.distributed.tensor import Replicate
    sdim = x.ndim - 2
    want = [Replicate() if pl.is_shard(sdim) and wpl.is_shard(vdim) else pl
            for pl, wpl in zip(x.placements, w.placements)]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """Mean next-token cross entropy over the labels that are not
    `ignore_id`: logits in f32, logsumexp minus the label's logit, summed
    and divided by max(count, 1), as the reference's. An ignored label
    reads logit 0 (its term is multiplied by 0). DTensor logits (the
    sharded step's) take _sharded_cross_entropy."""
    if is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels, ignore_id)
    total, count = _cross_entropy_sums(logits.float(), labels, ignore_id)
    return total / torch.clamp_min(count, 1.0)


def _cross_entropy_sums(logits, labels, ignore_id: int):
    """(sum of the kept tokens' losses, their count) of f32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    keep = labels != ignore_id
    idx = torch.where(keep, labels, 0).long()
    ll = torch.gather(logits, -1, idx[..., None])[..., 0]
    mask = keep.float()
    return ((lse - ll) * mask).sum(), mask.sum()


def _sharded_cross_entropy(logits, labels, ignore_id: int):
    """cross_entropy_loss of the sharded step, on each rank's local shard
    of the logits as the "logits" constrain left them: the rows as their
    placements split them (the batch over the data axes), the vocabulary
    split where act_pspec shards it (over model, where it divides), as
    GSPMD partitions the reference's loss. A vocabulary split over more
    than one rank takes _VocabParallelSums, which never gathers it; a
    replicated one (hymba's 32001 words on 16 ways, or a one-rank mesh)
    _cross_entropy_sums on the local rows. Any other placement (a pending
    sum, an uneven split of the vocabulary) is replicated first. The
    sums are pending (Partial) over the mesh axes that split the rows,
    and reduced before the division."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    vdims = [i for i, pl in enumerate(logits.placements)
             if type(pl) is Shard and pl.dim % logits.ndim == vdim]
    even = logits.shape[vdim] % math.prod(mesh.size(i) for i in vdims) == 0
    want = []
    for i, pl in enumerate(logits.placements):
        rows = type(pl) is Shard and pl.dim % logits.ndim != vdim
        want.append(pl if rows or (i in vdims and even) else Replicate())
    if want != list(logits.placements):
        logits = logits.redistribute(mesh, want)
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = [pl if i not in vdims else Replicate()
            for i, pl in enumerate(want)]
    if list(labels.placements) != rows:
        labels = labels.redistribute(mesh, rows)
    split = [i for i in vdims if even and mesh.size(i) > 1]
    if split:
        # the rank's vocabulary range: its coordinate over the splitting
        # mesh axes, major to minor in mesh order, as DTensor lays out a
        # dimension sharded over several of them
        local_v = logits.to_local().shape[-1]
        start = 0
        for i in vdims:
            start = start * mesh.size(i) + mesh.get_local_rank(i)
        total, count = _VocabParallelSums.apply(
            logits.to_local(), labels.to_local(), ignore_id,
            start * local_v, [mesh.get_group(i) for i in split])
    else:
        total, count = _cross_entropy_sums(logits.to_local().float(),
                                           labels.to_local(), ignore_id)
    pend = [Partial() if pl.is_shard() else Replicate() for pl in rows]
    total, count = (DTensor.from_local(t, mesh, pend, run_check=False)
                    for t in (total, count))
    return total / torch.clamp_min(count, 1.0)


def _all_reduce(t, op: str, groups):
    """t reduced by `op` over each process group in turn."""
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.all_reduce(t, op, g)
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _VocabParallelSums(torch.autograd.Function):
    """_cross_entropy_sums of logits whose vocabulary is split over the
    ranks of `groups`, on this rank's shard [..., V_local], which holds
    the words [start, start + V_local): the row maxima reduced by max,
    the sums of exp(logit - max) by sum, and each label's logit taken on
    the rank that holds it (0 elsewhere) and reduced by sum, so that
    every rank holds each row's logsumexp and label logit. The backward
    is (softmax - onehot) * mask * grad on the rank's own slice, with no
    collective and no tensor of the whole vocabulary; the forward saves
    the logits as they came (the cast to f32 is made again)."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_id, start, groups):
        lf = logits.float()
        m = _all_reduce(lf.amax(dim=-1), "max", groups)
        s = _all_reduce((lf - m[..., None]).exp_().sum(dim=-1), "sum",
                        groups)
        lse = torch.log(s) + m
        keep = labels != ignore_id
        idx = labels.long() - start
        own = keep & (idx >= 0) & (idx < lf.shape[-1])
        idx = torch.where(own, idx, 0)
        ll = _all_reduce(torch.gather(lf, -1, idx[..., None])[..., 0] * own,
                         "sum", groups)
        mask = keep.float()
        ctx.save_for_backward(logits, lse, idx, own, mask)
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return ((lse - ll) * mask).sum(), count

    @staticmethod
    def backward(ctx, g_total, g_count):
        logits, lse, idx, own, mask = ctx.saved_tensors
        dl = g_total * mask
        grad = (logits.float() - lse[..., None]).exp_().mul_(dl[..., None])
        grad.scatter_add_(-1, idx[..., None], -(dl * own)[..., None])
        return grad.to(logits.dtype), None, None, None, None
