"""Sharding rules and the model's parallelism knobs against the JAX
package's, in process (no ranks): a mesh stand-in whose `.shape` maps axis
names to sizes, for (data 16, model 16), (pod 2, data 16, model 16),
(data 2, model 4) and (data 1, model 1).

Covered: every schema leaf's logical axes at full size, for every arch;
pspecs_from_schema, fsdp_pspecs_from_schema, ATTN_SP_RULES, zero1_pspec
and act_pspec; cache_pspecs on each family's init_cache (the port's on
the meta device, JAX's under jax.eval_shape); Model(kv_rep=2) logits and
cache shapes on reduced granite; the (kind, shape) pairs a recording
`constrain` sees (sets: JAX traces a scanned body once, so it is run with
unroll=True); launch/mesh.py's refusals. batch_sharding and
shardings_from_schema, which want a real mesh on the JAX side, are held
in tests/test_torch_parallel.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, list_archs, reduced
from repro.models.layers import is_spec
from repro.models.model import Model as JaxModel
from repro.parallel import sharding as jsh
from repro.parallel.compression import compression_ratio as j_ratio
from repro_torch import TOLERANCES
from repro_torch.bridge import model_params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import Model
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.compression import compression_ratio

MESHES = {"dm16": ((16, 16), ("data", "model")),
          "pdm": ((2, 16, 16), ("pod", "data", "model")),
          "dm24": ((2, 4), ("data", "model")),
          "dm11": ((1, 1), ("data", "model"))}
ARCHS = list_archs()


class Mesh:
    """A mesh stand-in: `.shape` maps axis names to sizes in mesh order,
    as the reference's Mesh.shape does."""

    def __init__(self, key):
        shape, names = MESHES[key]
        self.shape = dict(zip(names, shape))


def _jax_leaves(tree) -> dict:
    """{path: leaf} of a JAX schema (ParamSpec leaves)."""
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]}


def _port_leaves(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_port_leaves(tree[k], f"{prefix}{k}/"))
    return out


@functools.lru_cache(maxsize=None)
def _schemas(arch: str):
    return (_jax_leaves(JaxModel(get_arch(arch)).schema()),
            _port_leaves(Model(t_get_arch(arch), device="meta").schema()))


def _stacked(jax_leaf, port_leaf) -> bool:
    """The port stacks a one-layer segment the reference keeps unstacked."""
    return len(port_leaf.shape) == len(jax_leaf.shape) + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_axes_equal_jax(arch):
    """Every leaf's logical axes (and shape) at full size: the reference's,
    with "layers" in front where the port stacks a one-layer segment."""
    j, t = _schemas(arch)
    assert set(j) == set(t)
    for k, js in j.items():
        ts = t[k]
        lead = ("layers",) if _stacked(js, ts) else ()
        assert ts.axes == lead + tuple(js.axes), (k, ts.axes, js.axes)
        assert ts.shape[len(lead):] == tuple(js.shape), k
        if lead:
            assert ts.shape[0] == 1, k


def _effective(spec, m) -> tuple:
    """spec without the mesh axes of size 1 (a shard over one rank is the
    whole tensor)."""
    def keep(e):
        names = e if isinstance(e, tuple) else (e,)
        names = tuple(n for n in names if n is not None and m.shape[n] > 1)
        return None if not names else (names[0] if len(names) == 1
                                       else names)
    return tuple(keep(e) for e in spec)


def _spec_equal(port, want, stacked: bool, m=None):
    """The port's spec equals the reference's, with a leading None where
    the port stacks a one-layer segment. On such a leaf ZeRO-1 may put a
    DP axis of size 1 on the stacked axis (its one divisible free dim when
    dp is 1), where the reference has no free dim: the same placement,
    compared without size-1 axes when `m` is given."""
    want = tuple(want)
    if stacked:
        want = (None,) + want
    if tuple(port) == want:
        return True
    return stacked and m is not None and \
        _effective(port, m) == _effective(want, m)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_jax(arch, mesh):
    """pspecs_from_schema (PARAM_RULES and ATTN_SP_RULES),
    fsdp_pspecs_from_schema and zero1_pspec of every leaf: the
    reference's, on the same mesh shape."""
    m = Mesh(mesh)
    j, t = _schemas(arch)
    for k, js in j.items():
        ts = t[k]
        st = _stacked(js, ts)
        for rules in (None, jsh.ATTN_SP_RULES):
            trules = None if rules is None else tsh.ATTN_SP_RULES
            want = jsh.pspec_for_axes(js.axes, js.shape, m, rules)
            got = tsh.pspec_for_axes(ts.axes, ts.shape, m, trules)
            assert _spec_equal(got, want, st), (k, got, want)
            want_z = jsh.zero1_pspec(want, js.shape, m)
            got_z = tsh.zero1_pspec(got, ts.shape, m)
            assert _spec_equal(got_z, want_z, st, m), (k, got_z, want_z)
    jtree = JaxModel(get_arch(arch)).schema()
    ttree = Model(t_get_arch(arch), device="meta").schema()
    jf = jax.tree.leaves(jsh.fsdp_pspecs_from_schema(jtree, m),
                         is_leaf=lambda x: isinstance(x, jax.sharding.
                                                      PartitionSpec))
    tf = list(_port_leaves(tsh.fsdp_pspecs_from_schema(ttree, m)).values())
    assert len(jf) == len(tf)
    for (k, js), want, got in zip(j.items(), jf, tf):
        assert _spec_equal(got, want, _stacked(js, t[k]), m), (k, got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_act_pspec_equal_jax(mesh):
    """act_pspec for residual (sequence sharding off and on), logits (a
    vocab that divides the model axis and one that does not) and
    moe_dispatched (groups and experts that divide and do not), and an
    unknown tag."""
    m = Mesh(mesh)
    cases = [("residual", None, None, False), ("residual", None, None, True),
             ("logits", None, 256000, False), ("logits", None, 51865, False),
             ("moe_dispatched", (32, 16, 8, 64), None, False),
             ("moe_dispatched", (3, 5, 8, 64), None, False),
             ("moe_dispatched", (64, 160, 4, 64), None, False),
             ("unknown", (4, 4), None, False)]
    for kind, shape, vocab, seq in cases:
        want = jsh.act_pspec(kind, m, shape=shape, vocab=vocab,
                             seq_shard=seq)
        got = tsh.act_pspec(kind, m, shape=shape, vocab=vocab, seq_shard=seq)
        assert tuple(got) == tuple(want), (kind, shape, got, want)
    assert tsh.batch_axes(m) == jsh.batch_axes(m)
    assert tsh._dp_size(m) == jsh._dp_size(m)


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec
    for entries in [((), ("a", "b"), ["c"], None), (("data",), None),
                    ("model",), ()]:
        assert tuple(tsh.P(*entries)) == tuple(PartitionSpec(*entries))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = Mesh("pdm")
    assert tsh.placements(tsh.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="out of mesh order"):
        tsh.placements(tsh.P(("data", "pod")), m)
    assert tsh.batch_sharding(m, 3) == (Shard(0), Shard(0), Replicate())


def test_compression_ratio_equals_jax():
    for td, jd in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                   jnp.bfloat16)):
        assert compression_ratio(td) == j_ratio(jd)


# --------------------------------------------------------------------------
# cache_pspecs
# --------------------------------------------------------------------------

CACHE_ARCHS = ["granite-8b", "dbrx-132b", "deepseek-v2-236b", "mamba2-370m",
               "hymba-1.5b", "whisper-small", "llama-3.2-vision-90b"]


def _cache_leaves(tree, prefix: str = "") -> dict:
    """{path: leaf} over nested dicts and cache dataclasses."""
    import dataclasses
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_cache_leaves(tree[k], f"{prefix}{k}/"))
        return out
    if dataclasses.is_dataclass(tree):
        return {f"{prefix}{f.name}": getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    return {prefix[:-1]: tree}


def _jax_cache_key(key: str, vlm: bool) -> str:
    """The port's flat vlm node {"attn", "cross"} in the reference's nested
    one {"plain": {"attn"}, "cross": {"cross"}}."""
    seg, node, field = key.split("/")
    if vlm:
        node = {"attn": "plain/attn", "cross": "cross/cross"}[node]
    return f"{seg}/{node}/{field}"


@pytest.mark.parametrize("kv_rep", [1, 2])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_pspecs_equal_jax(arch, kv_rep):
    """cache_pspecs of init_cache(8 lanes, 1024 positions) at full size
    on every mesh, with the sequence-sharding flags off and on: the
    reference's spec of each leaf, whose rules read its last dimensions
    (the port stacks a one-layer segment and flattens the vlm's groups,
    so a port leaf may lead with one more or one fewer replicated axis).
    kv_rep widens the KV caches as the reference's."""
    jm = JaxModel(get_arch(arch), kv_rep=kv_rep)
    tm = Model(t_get_arch(arch), device="meta", kv_rep=kv_rep)
    src = 1500 if arch == "whisper-small" else 0
    jcache = jax.eval_shape(lambda: jm.init_cache(8, 1024, src_len=src))
    tcache = tm.init_cache(8, 1024, src_len=src)
    jleaves = {"/".join(str(getattr(p, "name", getattr(p, "key", "")))
                        for p in path): leaf for path, leaf in
               jax.tree_util.tree_flatten_with_path(jcache)[0]}
    tleaves = _cache_leaves(tcache)
    vlm = tm.cfg.family == "vlm"
    assert {_jax_cache_key(k, vlm) for k in tleaves} == set(jleaves)
    for k, tl in tleaves.items():
        jl = jleaves[_jax_cache_key(k, vlm)]
        n = min(tl.ndim, jl.ndim) - (tl.ndim != jl.ndim)
        assert tl.numel() == np.prod(jl.shape) and \
            tuple(tl.shape)[tl.ndim - n:] == tuple(jl.shape)[jl.ndim - n:], k
    for mesh in MESHES:
        m = Mesh(mesh)
        for flags in ((False, False), (True, True)):
            jspecs = jax.tree_util.tree_flatten_with_path(
                jsh.cache_pspecs(jcache, m, *flags),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            jspec = {"/".join(str(getattr(p, "name", getattr(p, "key", "")))
                              for p in path): s for path, s in jspecs[0]}
            tspec = _cache_leaves(tsh.cache_pspecs(tcache, m, *flags))
            for k, got in tspec.items():
                want = tuple(jspec[_jax_cache_key(k, vlm)])
                got = tuple(got)
                n = min(len(got), len(want))
                assert got[len(got) - n:] == want[len(want) - n:] and \
                    not any(got[:len(got) - n]) and \
                    not any(want[:len(want) - n]), (mesh, flags, k, got,
                                                    want)


# --------------------------------------------------------------------------
# the model's knobs: kv_rep, constrain, kv_block
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_init(arch: str):
    jm = JaxModel(reduced(get_arch(arch)))
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.jit(jm.init)(jax.random.PRNGKey(0)))


def _excess(got, want) -> float:
    """|got - want| under logits_f32, atol relative to max|want|: at most 1
    within tolerance."""
    want = torch.from_numpy(np.array(want, np.float32))
    scale = float(want.abs().max())
    return TOLERANCES["logits_f32"].excess(got / scale, want / scale)


def test_kv_rep_logits_and_cache_shapes_equal_jax():
    """Model(kv_rep=2) on reduced granite in f32: the KV cache shapes the
    reference's Model(kv_rep=2) builds (twice n_kv_heads); the logits of a
    prefill and three decode steps within logits_f32 of the port's
    kv_rep=1 (a repeated head attends as its source), and as close to
    JAX's Model(kv_rep=2) as the port's kv_rep=1 is to JAX's kv_rep=1
    (within logits_f32, or within 1.5x of that pair's own excess: at
    this prompt the kv_rep=1 pair reads 1.6 at the third decode step,
    ROADMAP queue 3)."""
    arch = "granite-8b"
    cfg = reduced(get_arch(arch))
    jp = jax.tree.map(jnp.asarray, _jax_init(arch))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 7))
    logits = {}
    for rep in (1, 2):
        jm = JaxModel(cfg, kv_rep=rep)
        tm = Model(t_reduced(t_get_arch(arch)), kv_rep=rep, device="cpu")
        tp = model_params_from_jax(tm, _jax_init(arch))
        jc = jm.init_cache(2, 16, dtype=jnp.float32)
        tc = tm.init_cache(2, 16, dtype=torch.float32)
        for f in ("k", "v", "length"):
            assert tuple(getattr(tc["layers"]["attn"], f).shape) == \
                tuple(getattr(jc["layers"]["attn"], f).shape), f
        assert tc["layers"]["attn"].k.shape[-2] == rep * cfg.n_kv_heads
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
        with torch.no_grad():
            tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
            steps = [(tl, np.asarray(jl))]
            for pos in range(7, 10):
                # the kv_rep=1 reference's tokens feed both
                tok = np.asarray(logits[1][len(steps) - 1][1]).argmax(-1) \
                    if rep == 2 else np.asarray(jl).argmax(-1)
                jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                        pos)
                tl, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, pos)
                steps.append((tl, np.asarray(jl)))
        logits[rep] = steps
    for (t1, j1), (t2, j2) in zip(logits[1], logits[2]):
        assert _excess(t2, t1.numpy()) <= 1.0
        assert _excess(torch.from_numpy(j2), j1) <= 1.0
        assert _excess(t2, j2) <= max(1.0, 1.5 * _excess(t1, j1))


def _decode_excess(tm, tp, jm, jp, toks) -> list[float]:
    """_excess of the port's logits against JAX's at a prefill of `toks`
    and three decode steps (JAX's argmax tokens feed both), in f32."""
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    tc = tm.init_cache(2, 16, dtype=torch.float32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    with torch.no_grad():
        tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
        out = [_excess(tl, np.asarray(jl))]
        for pos in range(7, 10):
            tok = np.asarray(jl).argmax(-1)
            jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc, pos)
            tl, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, pos)
            out.append(_excess(tl, np.asarray(jl)))
    return out


def test_kv_rep_logits_drift_is_rmsnorm_rounding(monkeypatch):
    """The cause of the watch item above (ROADMAP queue 3): the RMSNorm.
    In f32 the port's torch.mean (another order of summation than XLA's
    reduce) and torch.rsqrt round over a quarter of their elements
    otherwise than the reference's (repro/models/layers.py::rmsnorm),
    while the projections, which carry most of the arithmetic, are
    bit-equal. With the reference's own rmsnorm swapped into the port
    (through JAX on the same values), the third decode step's excess
    under logits_f32 falls from above 1 to below half of it: the norm,
    5 of them a step, carries most of the drift; the attention's batched
    products and softmax the rest."""
    from repro.models.layers import rmsnorm as j_rmsnorm
    from repro_torch.models import layers as tlayers
    from repro_torch.models import transformer as ttransformer
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((4096, 64))).astype(np.float32)
    w = np.ones(64, np.float32)
    got = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jax.jit(j_rmsnorm)(jnp.asarray(x), jnp.asarray(w)))
    assert np.abs(got - want).max() <= 4 * np.spacing(np.abs(want)).max()
    assert np.count_nonzero(got != want) > want.size // 4
    q = jnp.asarray(rng.standard_normal((4096, 64)).astype(np.float32))
    assert np.array_equal(
        np.asarray(jax.jit(lambda a, b: a @ b)(q, jnp.asarray(x[:64]))),
        (torch.from_numpy(np.asarray(q)) @ torch.from_numpy(x[:64])).numpy())

    arch = "granite-8b"
    cfg = reduced(get_arch(arch))
    jm = JaxModel(cfg)
    jp = jax.tree.map(jnp.asarray, _jax_init(arch))
    tm = Model(t_reduced(t_get_arch(arch)), device="cpu")
    tp = model_params_from_jax(tm, _jax_init(arch))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 7))
    plain = _decode_excess(tm, tp, jm, jp, toks)

    def ref_rmsnorm(x, w, eps=1e-6):
        return torch.from_numpy(np.array(j_rmsnorm(
            jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), eps)))
    monkeypatch.setattr(tlayers, "rmsnorm", ref_rmsnorm)
    monkeypatch.setattr(ttransformer, "rmsnorm", ref_rmsnorm)
    swapped = _decode_excess(tm, tp, jm, jp, toks)
    assert plain[-1] > 1.0 and swapped[-1] < 0.5 * plain[-1]
    assert max(swapped) < 1.0


CONSTRAIN_ARCHS = ["yi-6b", "dbrx-132b", "deepseek-v2-236b", "mamba2-370m",
                   "hymba-1.5b", "whisper-small", "llama-3.2-vision-90b"]


def _batch(cfg, S: int) -> dict:
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)}
    if cfg.encoder_decoder:
        b["frames"] = rng.standard_normal((2, 8, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", CONSTRAIN_ARCHS)
def test_constrain_sites_equal_jax(arch):
    """The set of (kind, shape) pairs a recording constrain sees: a forward
    without a cache, a prefill into a cache and a decode step, against
    JAX's Model(constrain=..., unroll=True) traced by jax.eval_shape."""
    cfg = reduced(get_arch(arch))
    tcfg = t_reduced(t_get_arch(arch))
    seen = {"jax": set(), "port": set()}

    def rec(side):
        def hook(x, kind):
            seen[side].add((kind, tuple(x.shape)))
            return x
        return hook
    jm = JaxModel(cfg, constrain=rec("jax"), unroll=True)
    tm = Model(tcfg, constrain=rec("port"), device="cpu")
    src = 8 if cfg.encoder_decoder else 0
    b = _batch(cfg, 6)
    jb = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in b.items()}
    shapes = jm.shapes()
    jax.eval_shape(lambda p, x: jm.forward(p, x)[0], shapes, jb)
    jc = jax.eval_shape(lambda: jm.init_cache(2, 16, src_len=src))
    jc = jax.eval_shape(lambda p, x, c: jm.prefill(p, x, c)[1], shapes, jb,
                        jc)
    jax.eval_shape(lambda p, c: jm.decode_step(
        p, jnp.zeros((2,), jnp.int32), c, 6)[0], shapes, jc)
    params = tm.init(torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["tokens"] = tb["tokens"].long()
    with torch.no_grad():
        tm.forward(params, tb)
        tc = tm.init_cache(2, 16, src_len=src)
        tm.prefill(params, tb, tc)
        tm.decode_step(params, torch.zeros(2, dtype=torch.long), tc, 6)
    assert seen["port"] == seen["jax"], (seen["port"] ^ seen["jax"])
    assert {k for k, _ in seen["port"]} >= {"residual", "logits"}
    if cfg.moe:
        assert "moe_dispatched" in {k for k, _ in seen["port"]}


def test_kv_block_reaches_the_chunked_attention():
    """kv_block 4 against the default on reduced yi-6b in f32: logits
    within f32 reassociation of the online softmax (the blocks split the
    16 keys), and both against JAX's Model(kv_block=4)."""
    arch = "yi-6b"
    cfg = reduced(get_arch(arch))
    jm = JaxModel(cfg, kv_block=4)
    tm = Model(t_reduced(t_get_arch(arch)), kv_block=4, device="cpu")
    t0 = Model(t_reduced(t_get_arch(arch)), device="cpu")
    tp = model_params_from_jax(tm, _jax_init(arch))
    b = _batch(cfg, 16)
    jl = np.asarray(jm.forward(jax.tree.map(jnp.asarray, _jax_init(arch)),
                               {"tokens": jnp.asarray(b["tokens"])})[0])
    calls = []
    from repro_torch.models import attention as attn
    real = attn._forward_blocks

    def spy(*a, **kw):
        calls.append(kw["kv_block"])
        return real(*a, **kw)
    attn._forward_blocks = spy
    try:
        with torch.no_grad():
            tl = tm.forward(tp, {"tokens": torch.from_numpy(
                b["tokens"]).long()})[0]
            tl0 = t0.forward(tp, {"tokens": torch.from_numpy(
                b["tokens"]).long()})[0]
    finally:
        attn._forward_blocks = real
    assert calls == [4] * cfg.n_layers + [1024] * cfg.n_layers
    assert _excess(tl, jl) <= 1.0
    assert _excess(tl, tl0.numpy()) <= 1.0


# --------------------------------------------------------------------------
# launch/mesh.py
# --------------------------------------------------------------------------

def test_mesh_builders_raise(tmp_path):
    """Without a process group both builders raise; device None without a
    CUDA device raises; on a one-rank gloo world the production meshes
    name the world size they need, a mesh on the card refuses gloo, and
    the host mesh is (data 1, model 1)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_host_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_production_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="needs a world of 256"):
            tmesh.make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="needs a world of 512"):
            tmesh.make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(RuntimeError, match="nccl"):
            tmesh.make_host_mesh(device="cuda")
        m = tmesh.make_host_mesh(model=4, device="cpu")
        assert tmesh.mesh_shape_dict(m) == {"data": 1, "model": 1}
        assert tmesh.mesh_shape_dict(Mesh("pdm")) == Mesh("pdm").shape
    finally:
        dist.destroy_process_group()
