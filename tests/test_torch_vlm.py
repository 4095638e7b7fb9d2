"""The port's vision-language family (llama-3.2-vision-90b) against the
JAX package, on the CPU.

reduced(llama-3.2-vision-90b): d 64, 4 heads of 16 over 2 KV heads, d_ff
128 gated SiLU, rmsnorm, rope, untied head over a 256-token vocabulary,
cross_attn_every 2 and 16 image tokens; at its 2 layers that is one group
(one dense block, then one cross_layer block), and at n_layers = 4 two
groups. Parameters come from the JAX Model through
`bridge.model_params_from_jax`, inputs (tokens and image embeddings, what
the stubbed vision tower would give) from numpy seeds.

* segments, schema and param_count at full size (87,733,903,360) and
  reduced, a cut that is not whole groups refused, and the bridge at one
  and at two groups (the reference stacks the groups at every depth, so
  nothing gains an axis);
* `_cross_source` (the image embeddings through `img_adapter`, f32 and
  bf16 embeddings) and its KeyError without them;
* one `cross_layer` block (GQA, 4 over 2 heads) at prefill (its cross K/V
  written into the cache) and at decode (read from it), f32 and bf16
  image embeddings;
* Model logits at two groups, a 6-token prefill then 3 decode steps,
  use_pallas and attention_impl off and on, bf16 weights with bf16 and
  with f32 embeddings, and f32 weights and embeddings (logits_bf16_vlm
  and logits_f32_vlm, atol relative to max |ref|: at the reference's
  init the cross K/V reach ~27 and the self K/V ~20, and the JAX
  package's own chunked and Pallas forwards differ by up to 0.26 of
  max|logit| in bf16; `python tests/test_torch_vlm.py` prints the
  readings);
* served tokens against JAX's ServeEngine and ReferenceEngine on the
  prompts and image of tests/test_serve_matrix.py's vlm case (a
  difference only after a near tie, `token_margin`);
* the flat cache against the reference's nested one after a prefill into
  slot 1 of a 2-slot engine, at 2 groups of 2 dense blocks (plain layer
  (g, l) at flat index g * 2 + l);
* the guarded engine (abft) serves the unguarded tokens, with its decode
  state holding no CrossKV;
* a paged engine refuses image embeddings, a paged vlm cache is refused,
  and the launcher fails at its first prefill naming `image_embeds`;
* on the card: tests/test_torch_vlm_gpu.py, which imports no JAX.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import model as jmodel
from repro.models import transformer as jtr
from repro.models.model import Model as JaxModel
from repro.serve.engine import InvalidRequest as JaxInvalidRequest
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.reference import ReferenceEngine as JaxReferenceEngine
from repro_torch import TOLERANCES
from repro_torch.bridge import model_params_from_jax, params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import transformer as ttr
from repro_torch.models.attention import KVCache
from repro_torch.models.model import CrossKV, Model
from repro_torch.models.transformer import segments
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.admission import InvalidRequest
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.reference import ReferenceEngine

ARCH = "llama-3.2-vision-90b"
N_IMG = 16                    # reduced()'s n_image_tokens
ROOT = Path(__file__).resolve().parents[1]
T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the model's tolerances: its large cross and self K/V (runtime.TOLERANCES)
TOL = {"float32": "logits_f32_vlm", "bfloat16": "logits_bf16_vlm"}


def _close(got: torch.Tensor, ref, tol, scale: float):
    """Within tol, atol relative to `scale` (max |ref|)."""
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    err = (got.float() - ref_t).abs()
    assert bool((err <= tol.atol * scale + tol.rtol * ref_t.abs()).all()), (
        f"max_abs_err {float(err.max())} of max|ref| {scale} ({tol})")


def _scale(ref) -> float:
    return float(np.abs(np.asarray(ref, np.float32)).max())


def _images(seed: int, batch: int = 1, n: int = N_IMG, d: int = 64):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, d)).astype(np.float32)


def _configs(n_layers: int, every: int | None = None):
    """The reduced JAX and port configs at n_layers (and cross_attn_every,
    if given)."""
    kw = dict(n_layers=n_layers)
    if every is not None:
        kw["cross_attn_every"] = every
    return (dataclasses.replace(reduced(get_arch(ARCH)), **kw),
            dataclasses.replace(t_reduced(t_get_arch(ARCH)), **kw))


def _bridge(cfg, tcfg, seed: int = 0):
    """JAX parameters in bf16 and f32 and the port's (bridged) in both."""
    tm = Model(tcfg, device="cpu")
    jp = JaxModel(cfg).init(jax.random.PRNGKey(seed))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jps = {"bfloat16": jp, "float32": jp32}
    tps = {k: model_params_from_jax(tm, jax.tree.map(np.asarray, v))
           for k, v in jps.items()}
    return jps, tps


@pytest.fixture(scope="module")
def one_group():
    cfg, tcfg = _configs(2)
    return (cfg, tcfg) + _bridge(cfg, tcfg)


@pytest.fixture(scope="module")
def two_groups():
    cfg, tcfg = _configs(4)
    return (cfg, tcfg) + _bridge(cfg, tcfg)


# --------------------------------------------------------------------------
# segments, schema and the bridge
# --------------------------------------------------------------------------

def _walk(j, t, s, path=()):
    """Every leaf of the JAX tree `j` equal to the port's `t` and of the
    schema `s`'s shape, with no axis added."""
    if isinstance(j, dict):
        assert set(j) == set(t) == set(s), path
        for k in j:
            _walk(j[k], t[k], s[k], path + (k,))
        return
    assert tuple(t.shape) == tuple(j.shape) == tuple(s.shape), path
    assert torch.equal(t, T(j)), path


def _shapes(sch):
    return jax.tree.map(lambda s: tuple(s.shape), sch,
                        is_leaf=lambda s: hasattr(s, "shape"))


def test_segments_schema_and_param_count():
    """One segment of n_layers / cross_attn_every groups, as the
    reference's; the schema's leaves and shapes equal the reference's at
    full size and at one and two reduced groups (`plain` [groups, 4 or 1,
    ...], `cross` [groups, ...], `img_adapter` [d, d]); param_count at
    full size is the reference's 87,733,903,360; a depth that is not whole
    groups raises a ValueError."""
    full = [(s.name, s.kind, s.n) for s in segments(t_get_arch(ARCH))]
    assert full == [("blocks", "vlm", 20)] == \
        [(s.name, s.kind, s.n) for s in jtr.segments(get_arch(ARCH))]
    for tcfg, cfg in ((t_get_arch(ARCH), get_arch(ARCH)),
                      (_configs(2)[1], _configs(2)[0]),
                      (_configs(4)[1], _configs(4)[0])):
        tsch, jsch = Model(tcfg, device="cpu").schema(), \
            JaxModel(cfg).schema()
        assert _shapes(tsch) == _shapes(jsch)
    tsch = Model(t_get_arch(ARCH), device="cpu").schema()
    assert set(tsch["blocks"]) == {"plain", "cross"}
    assert set(tsch["blocks"]["cross"]) == {"ln_cross", "cross", "ln_mlp",
                                            "mlp"}
    assert tsch["blocks"]["plain"]["attn"]["q"].shape == (20, 4, 8192, 64,
                                                          128)
    assert tsch["blocks"]["cross"]["cross"]["k"].shape == (20, 8192, 8, 128)
    assert tsch["img_adapter"].shape == (8192, 8192)
    n = Model(t_get_arch(ARCH), device="cpu").param_count()
    assert n == JaxModel(get_arch(ARCH)).param_count() == 87_733_903_360
    with pytest.raises(ValueError, match="whole groups"):
        segments(dataclasses.replace(t_get_arch(ARCH), n_layers=6))


@pytest.mark.parametrize("groups", [1, 2])
def test_bridge_keeps_the_groups_stacked(request, groups):
    """The reference stacks a vlm's groups at every depth, one group
    included ([1, 1, ...] plain, [1, ...] cross), so the bridge carries
    every leaf as it is, in bf16 and f32; the result has the shapes and
    dtypes the port's own init gives, which draws its leaves in sorted
    key order."""
    cfg, tcfg, jps, tps = request.getfixturevalue(
        {1: "one_group", 2: "two_groups"}[groups])
    jp = jps["bfloat16"]
    assert jp["blocks"]["plain"]["attn"]["q"].shape[:2] == (groups, 1)
    assert jp["blocks"]["cross"]["cross"]["q"].shape[0] == groups
    tm = Model(tcfg, device="cpu")
    for dtype in ("bfloat16", "float32"):
        _walk(jps[dtype], tps[dtype], tm.schema())
    own = tm.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: (tuple(a.shape), a.dtype), own) == \
        jax.tree.map(lambda a: (tuple(a.shape), a.dtype), tps["bfloat16"])
    assert list(own) == sorted(own)
    assert list(own["blocks"]) == ["cross", "plain"]


# --------------------------------------------------------------------------
# the cross source and the cross_layer block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_source_matches_jax(one_group, dtype):
    """The image embeddings of 2 lanes through img_adapter (bf16), in the
    promoted dtype: f32 embeddings give f32 (logits_f32 relative to
    max|ref|), bf16 give bf16 (logits_bf16). A batch without them raises
    a KeyError that names them, as the reference's does."""
    cfg, tcfg, jps, tps = one_group
    jdt, tdt = DTYPES[dtype]
    im = _images(12, batch=2)
    jm, tm = JaxModel(cfg), Model(tcfg, device="cpu")
    ref = jm._cross_source(jps["bfloat16"], {"image_embeds":
                                             jnp.asarray(im, jdt)})
    got = tm._cross_source(tps["bfloat16"], {"image_embeds":
                                             torch.from_numpy(im).to(tdt)})
    assert got.dtype == tdt and jnp.asarray(ref).dtype == jdt
    _close(got, ref, TOLERANCES[TOL[dtype]], _scale(ref))
    toks = {"tokens": torch.zeros((1, 3), dtype=torch.int64)}
    with pytest.raises(KeyError, match="image_embeds"):
        tm._cross_source(tps["bfloat16"], toks)
    with pytest.raises(KeyError, match="image_embeds"):
        jm._cross_source(jps["bfloat16"], {"tokens": jnp.zeros((1, 3),
                                                               jnp.int32)})


@pytest.mark.parametrize("case", ["prefill_f32", "prefill_bf16", "decode"])
def test_cross_layer_block_matches_jax(one_group, case):
    """Group 0's cross_layer in bf16 with its cache, 4 query heads over 2
    KV heads. prefill: 6 tokens of 2 lanes into an empty cross cache, the
    K/V computed from the adapted f32 or bf16 image embeddings (f32: f32
    K/V in the attention, bf16 in the cache). decode: one token a lane
    over a cross cache of random K/V, which is read and left as it was."""
    cfg, tcfg, jps, tps = one_group
    mode = case.split("_")[0]
    emb_dtype = "bfloat16" if case == "prefill_bf16" else "float32"
    jp = jax.tree.map(lambda a: a[0], jps["bfloat16"]["blocks"]["cross"])
    tp = jax.tree.map(lambda a: a[0], tps["bfloat16"]["blocks"]["cross"])
    jdt, tdt = DTYPES[emb_dtype]
    rng = np.random.default_rng(5)
    B, H, hd = 2, cfg.n_kv_heads, cfg.resolved_head_dim
    assert (cfg.n_heads, H) == (4, 2)
    bf = jnp.bfloat16
    if mode == "prefill":
        S = 6
        cross0 = np.zeros((B, N_IMG, H, hd), np.float32)
        src = np.asarray(JaxModel(cfg)._cross_source(
            jps["bfloat16"], {"image_embeds": jnp.asarray(
                _images(13, batch=B), jdt)}).astype(jnp.float32))
        jpos, tpos = jnp.arange(S), torch.arange(S)
    else:
        S = 1
        cross0 = rng.standard_normal((B, N_IMG, H, hd))
        src = None
        jpos = jnp.asarray([[5], [11]])
        tpos = torch.tensor([[5], [11]])
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), bf)
    jcache = {"cross": jmodel.CrossKV(jnp.asarray(cross0, bf),
                                      jnp.asarray(cross0, bf))}
    tcache = {"cross": CrossKV(T(jcache["cross"].k), T(jcache["cross"].v))}
    jsrc = None if src is None else jnp.asarray(src, jdt)
    tsrc = None if src is None else torch.from_numpy(src).to(tdt)
    ref, jnew = jax.jit(lambda p, x, pos, c, s: jtr.apply_block(
        p, x, cfg, "cross_layer", positions=pos, cache=c, cross_src=s))(
        jp, x, jpos, jcache, jsrc)
    got = ttr.apply_block(tp, T(x), tcfg, "cross_layer", positions=tpos,
                          cache=tcache, cross_src=tsrc)
    assert got.dtype == torch.bfloat16
    _close(got, ref, TOLERANCES["logits_bf16"], _scale(ref))
    for a, b in ((tcache["cross"].k, jnew["cross"].k),
                 (tcache["cross"].v, jnew["cross"].v)):
        assert a.dtype == torch.bfloat16
        if mode == "decode":         # read, never written
            assert torch.equal(a, T(b))
        else:                        # JAX returns the fresh K/V
            assert jnp.asarray(b).dtype == jdt
            _close(a, jnp.asarray(b).astype(jnp.float32),
                   TOLERANCES["logits_bf16"], _scale(b))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

CASES = {"bf16": ("bfloat16", "bfloat16"), "bf16_f32images":
         ("bfloat16", "float32"), "f32": ("float32", "float32")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "kernels"])
def test_model_logits_match_jax(two_groups, use_pallas, case):
    """Two groups: a 6-token prefill of 2 lanes, each with its own image
    embeddings, then 3 decode steps at per-lane positions, against the JAX
    Model on the same parameters: every dense projection, the MLPs (the
    cross layers' too) and the head on the pod GEMM and the self-attention
    prefill on flash when use_pallas (JAX's kernels in interpret mode),
    the cross attention and img_adapter on einsums either way. f32
    embeddings on bf16 weights give an f32 cross source and prefill K/V,
    the rest bf16 (logits_bf16_vlm); f32 weights and embeddings are f32
    throughout (logits_f32_vlm). The cross cache holds the K/V in the
    cache's dtype, one layer a group."""
    cfg, tcfg, jps, tps = two_groups
    pdt, edt = CASES[case]
    (jdt, tdt), (jedt, tedt) = DTYPES[pdt], DTYPES[edt]
    jp, tp = jps[pdt], tps[pdt]
    impl = "pallas" if use_pallas else "chunked"
    jm = JaxModel(cfg, attention_impl=impl, use_pallas=use_pallas)
    tm = Model(tcfg, attention_impl=impl, use_pallas=use_pallas,
               device="cpu")
    tol = TOLERANCES[TOL[pdt]]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6))
    im = _images(21, batch=2)
    jl, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "image_embeds": jnp.asarray(im, jedt)},
        jm.init_cache(2, 16, dtype=jdt))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "image_embeds": torch.from_numpy(im).to(tedt)},
                        tm.init_cache(2, 16, dtype=tdt))
    scale = _scale(jl)
    _close(tl, jl, tol, scale)
    tcross, jcross = tc["blocks"]["cross"], jc["blocks"]["cross"]["cross"]
    assert tcross.k.dtype == tdt and tcross.k.shape == (2, 2, N_IMG, 2, 16)
    _close(tcross.k, jcross.k, tol, _scale(jcross.k))
    tok = np.asarray(jl, np.float32).argmax(-1)
    decode = jax.jit(jm.decode_step)
    for s in range(3):
        pos = np.array([6 + s, 6 + s])
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl, tol, scale)
        tok = np.asarray(jl, np.float32).argmax(-1)     # same inputs both
    assert tc["blocks"]["attn"].length.tolist() == [[9, 9]] * 2


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _matrix_case(vocab):
    """tests/test_serve_matrix.py's vlm case: prompts of 4, 9 and 6 tokens
    and one f32 image drawn after them, from default_rng(7)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, n, dtype=np.int32) for n in (4, 9, 6)]
    image = rng.standard_normal((1, N_IMG, 64)).astype(np.float32)
    return prompts, image


def _serve(engine, prompts, images, max_new=3, cls=Request):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new,
                extras={"image_embeds": im})
            for i, (p, im) in enumerate(zip(prompts, images))]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _margin_rule(jm, jp, p, im, a, b):
    """Equal tokens, or a first difference after a near tie of the JAX
    model's logits there."""
    assert len(a) == len(b)
    if a == b:
        return
    j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    seq = jnp.asarray(np.concatenate([p, b[:j]]).astype(np.int32))
    logits, _ = jm.forward(jp, {"tokens": seq[None],
                                "image_embeds": jnp.asarray(im)})
    last = np.asarray(logits[0, -1], np.float32)
    top2 = np.sort(last)[-2:]
    assert top2[1] - top2[0] <= \
        TOLERANCES["token_margin"].atol * np.abs(last).max(), (p, a, b)


def test_serve_engines_match_jax_engines(one_group):
    """Port ServeEngine vs JAX ServeEngine and port ReferenceEngine vs JAX
    ReferenceEngine (slots 2, max_len 32, src_len 0: the cross cache takes
    n_image_tokens rows; 3 new tokens; use_pallas and flash prefill on),
    on the serve matrix's vlm prompts and image: equal tokens, or a first
    difference after a near tie of the reference's logits."""
    cfg, tcfg, jps, tps = one_group
    jp, tp = jps["bfloat16"], tps["bfloat16"]
    jm = JaxModel(cfg, attention_impl="pallas", use_pallas=True)
    tm = Model(tcfg, attention_impl="pallas", use_pallas=True, device="cpu")
    prompts, image = _matrix_case(cfg.vocab)
    images = [image] * len(prompts)
    kw = dict(slots=2, max_len=32, src_len=0)
    pairs = [(JaxServeEngine(jm, jp, **kw), ServeEngine(tm, tp, **kw)),
             (JaxReferenceEngine(jm, jp, **kw),
              ReferenceEngine(tm, tp, **kw))]
    for jeng, teng in pairs:
        ref = _serve(jeng, prompts, images, cls=JaxRequest)
        got = _serve(teng, prompts, images)
        for p, im, a, b in zip(prompts, images, got, ref):
            assert len(a) == 3
            _margin_rule(jm, jp, p, im, a, b)
    assert teng.cache["blocks"]["cross"].k.shape == (1, 2, N_IMG, 2, 16)


def test_flat_cache_matches_the_nested_cache():
    """2 groups of 2 dense blocks and a cross_layer (n_layers 6,
    cross_attn_every 3, on einsums): a request with its own f32 image
    prefilled into slot 1 of a 2-slot engine, in both packages. The port's
    flat KVCache holds plain layer (g, l) at index g * 2 + l, equal to the
    reference's nested [g, l] within logits_bf16 of its max, with the same
    lengths; the CrossKV, one layer a group, equals the reference's; slot
    0 stays zero in both."""
    cfg, tcfg = _configs(6, every=3)
    jps, tps = _bridge(cfg, tcfg, seed=3)
    jm, tm = JaxModel(cfg), Model(tcfg, device="cpu")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, 7,
                                               dtype=np.int32)
    im = _images(9)
    kw = dict(slots=2, max_len=32)
    jeng = JaxServeEngine(jm, jps["bfloat16"], **kw)
    teng = ServeEngine(tm, tps["bfloat16"], **kw)
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        req = cls(rid=0, prompt=prompt, max_new_tokens=3,
                  extras={"image_embeds": im})
        eng.submit(req)
        eng.queue.remove(req)
        eng._prefill_into(1, req)
    tc, jc = teng.cache["blocks"], jeng.cache["blocks"]
    tol = TOLERANCES["logits_bf16"]
    assert tc["attn"].k.shape == (4, 2, 32, 2, 16)
    assert tc["cross"].k.shape == (2, 2, N_IMG, 2, 16)
    for g in range(2):
        for l in range(2):
            i = g * 2 + l
            jattn_gl = jc["plain"]["attn"]
            for a, b in ((tc["attn"].k[i], jattn_gl.k[g, l]),
                         (tc["attn"].v[i], jattn_gl.v[g, l])):
                _close(a, jnp.asarray(b).astype(jnp.float32), tol,
                       _scale(b))
                assert not a[0].any()
            assert tc["attn"].length[i].tolist() == \
                np.asarray(jattn_gl.length[g, l]).tolist() == [0, 7]
        jcross = jc["cross"]["cross"]
        for a, b in ((tc["cross"].k[g], jcross.k[g]),
                     (tc["cross"].v[g], jcross.v[g])):
            _close(a, jnp.asarray(b).astype(jnp.float32), tol, _scale(b))
            assert not a[0].any() and a[1].any()


def test_guarded_engine_serves_vlm(one_group):
    """Under the SDC guard (abft) every decode step's pod GEMMs run
    guarded, and the engine saves the state a decode chunk advances before
    each guarded call: the KV lengths, not the cross K/V, which decode
    never writes. Clean abft serves the unguarded engine's tokens, each
    request with its own image."""
    cfg, tcfg, jps, tps = one_group
    tm = Model(tcfg, use_pallas=True, device="cpu")
    prompts = _matrix_case(cfg.vocab)[0][:2]
    images = [_images(70), _images(71)]
    kw = dict(slots=2, max_len=32)
    off = _serve(ServeEngine(tm, tps["bfloat16"], **kw), prompts, images)
    eng = ServeEngine(tm, tps["bfloat16"], guard="abft", **kw)
    assert _serve(eng, prompts, images) == off
    cross = eng.cache["blocks"]["cross"]
    state = engine_mod._decode_state(eng.cache)
    assert not any(t is cross.k or t is cross.v for t in state)
    assert any(t is eng.cache["blocks"]["attn"].length for t in state)
    assert eng.guard_events["uncorrectable"] == 0


def test_paged_refusals_as_the_reference(one_group):
    """A paged engine raises InvalidRequest("extras") at submit for a
    request with image embeddings, with the reference's message (on
    reduced granite, a bucketed family); the vlm is not a bucketed family,
    so a paged vlm cache is refused in both packages, and so is its paged
    engine."""
    cfg, tcfg, jps, tps = one_group
    gcfg = reduced(get_arch("granite-8b"))
    jm = JaxModel(gcfg)
    tm = Model(t_reduced(t_get_arch("granite-8b")), device="cpu")
    prompt = np.arange(5, dtype=np.int32)
    kw = dict(slots=2, max_len=32, paged=True, page_size=8)
    jeng = JaxServeEngine(jm, jm.init(jax.random.PRNGKey(0)), **kw)
    teng = ServeEngine(tm, {}, **kw)
    extras = {"image_embeds": _images(1)}
    with pytest.raises(JaxInvalidRequest) as jerr:
        jeng.submit(JaxRequest(rid=0, prompt=prompt, extras=dict(extras)))
    with pytest.raises(InvalidRequest) as terr:
        teng.submit(Request(rid=0, prompt=prompt, extras=dict(extras)))
    assert terr.value.field == jerr.value.field == "extras"
    assert str(terr.value) == str(jerr.value)
    assert not teng.queue
    vm, jvm = Model(tcfg, device="cpu"), JaxModel(cfg)
    assert not vm.bucketed_prefill_ok and not jvm.bucketed_prefill_ok
    with pytest.raises(ValueError, match="bucketed") as terr:
        vm.init_cache(2, 32, page_size=8, kv_pages=8)
    with pytest.raises(ValueError, match="bucketed") as jerr:
        jvm.init_cache(2, 32, page_size=8, kv_pages=8)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="bucketed"):
        ServeEngine(vm, tps["bfloat16"], **kw)


def test_serve_launcher_fails_on_vlm_naming_the_image_embeds():
    """python -m repro_torch.launch.serve --arch llama-3.2-vision-90b
    --reduced --device cpu: the launcher passes no image (the reference's
    has no option for one and fails with KeyError 'image_embeds' at its
    first prefill), so the port's fails there too, naming them."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    last = proc.stderr.strip().splitlines()[-1]
    assert last.startswith("KeyError") and "image_embeds" in last, \
        proc.stderr


# --------------------------------------------------------------------------
# the readings behind logits_f32_vlm and logits_bf16_vlm
# --------------------------------------------------------------------------

def logit_readings(seeds=range(6)):
    """Per case (weights/images dtype) and use_pallas, over `seeds` of
    tokens and images at two groups: the port's largest difference from
    the JAX Model over a prefill and 3 decode steps (fed the JAX model's
    tokens), and the JAX package's own other path (chunked against
    Pallas) on the same tokens, each relative to max|prefill logit|, raw
    and past rtol 0.1; and, in f32, one decode step from the same cache
    state (the JAX cache carried into the port's flat layout)."""
    cfg, tcfg = _configs(4)
    jps, tps = _bridge(cfg, tcfg)
    out = []
    for case, (pdt, edt) in CASES.items():
        (jdt, tdt), (jedt, tedt) = DTYPES[pdt], DTYPES[edt]
        for up in (False, True):
            impl = ("chunked", "pallas")
            jm = JaxModel(cfg, attention_impl=impl[up], use_pallas=up)
            jo = JaxModel(cfg, attention_impl=impl[not up],
                          use_pallas=not up)
            tm = Model(tcfg, attention_impl=impl[up], use_pallas=up,
                       device="cpu")
            row = {"case": case, "use_pallas": up, "port": 0.0,
                   "port_past_rtol": 0.0, "jax_other_path": 0.0,
                   "jax_other_path_past_rtol": 0.0}
            for seed in seeds:
                toks = np.random.default_rng(100 + seed).integers(
                    0, cfg.vocab, (2, 6))
                im = _images(200 + seed, batch=2)
                runs = {}
                for name, m in (("ref", jm), ("other", jo)):
                    jl, jc = jax.jit(m.prefill)(
                        jps[pdt], {"tokens": jnp.asarray(toks, jnp.int32),
                                   "image_embeds": jnp.asarray(im, jedt)},
                        m.init_cache(2, 16, dtype=jdt))
                    logits = [np.asarray(jl, np.float32)]
                    fed = runs["ref"][1] if name == "other" else []
                    for s in range(3):
                        tok = fed[s] if name == "other" else \
                            logits[-1].argmax(-1)
                        if name == "ref":
                            fed.append(tok)
                        jl, jc = jax.jit(m.decode_step)(
                            jps[pdt], jnp.asarray(tok, jnp.int32), jc,
                            jnp.asarray([6 + s] * 2, jnp.int32))
                        logits.append(np.asarray(jl, np.float32))
                    runs[name] = (logits, fed, jc)
                tl, tc = tm.prefill(
                    tps[pdt], {"tokens": torch.from_numpy(toks),
                               "image_embeds": torch.from_numpy(im).to(
                                   tedt)}, tm.init_cache(2, 16, dtype=tdt))
                port = [tl.float().numpy()]
                for s in range(3):
                    tl, tc = tm.decode_step(
                        tps[pdt], torch.from_numpy(runs["ref"][1][s]), tc,
                        torch.tensor([6 + s] * 2))
                    port.append(tl.float().numpy())
                ref = runs["ref"][0]
                scale = float(np.abs(ref[0]).max())
                for key, got in (("port", port),
                                 ("jax_other_path", runs["other"][0])):
                    err = [np.abs(g - r) for g, r in zip(got, ref)]
                    row[key] = max(row[key], max(
                        float(e.max()) for e in err) / scale)
                    row[key + "_past_rtol"] = max(
                        row[key + "_past_rtol"],
                        max(float((e - 0.1 * np.abs(r)).max())
                            for e, r in zip(err, ref)) / scale)
                if pdt == "float32":
                    row["same_state_decode"] = max(
                        row.get("same_state_decode", 0.0),
                        _same_state_step(jm, tm, jps[pdt], tps[pdt],
                                         runs["ref"][2],
                                         ref[-1].argmax(-1)))
            out.append(row)
    return out


def _same_state_step(jm, tm, jp, tp, jc, tok):
    """One decode step of both packages from the JAX cache `jc` (carried
    into the port's flat layout), relative to max|ref|."""
    plain, cross = jc["blocks"]["plain"]["attn"], jc["blocks"]["cross"][
        "cross"]
    n, inner = plain.k.shape[:2]
    flat = lambda a: T(a).reshape((n * inner,) + tuple(a.shape[2:]))
    tc = {"blocks": {"attn": KVCache(flat(plain.k), flat(plain.v),
                                     flat(plain.length).long()),
                     "cross": CrossKV(T(cross.k), T(cross.v))}}
    jl, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(tok, jnp.int32), jc,
                                    jnp.asarray([9, 9], jnp.int32))
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok), tc,
                           torch.tensor([9, 9]))
    ref = np.asarray(jl, np.float32)
    return float(np.abs(tl.float().numpy() - ref).max()
                 / np.abs(ref).max())


if __name__ == "__main__":
    import json
    for r in logit_readings():
        print(json.dumps(r))
