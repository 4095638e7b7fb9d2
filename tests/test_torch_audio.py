"""The port's encoder-decoder family (whisper-small) against the JAX
package, on the CPU.

reduced(whisper-small): 2 encoder and 2 decoder layers, d 64, 4 heads of
16 over 2 KV heads, d_ff 128 with GELU, layernorm, no rope (sinusoidal
positions), untied head over a 256-token vocabulary. Parameters come from
the JAX Model through `bridge.model_params_from_jax`, inputs (tokens and
frames, the precomputed embeddings the stubbed conv frontend would give)
from numpy seeds; the sources are SRC_LEN = 8 frames long, as in
tests/test_serve_matrix.py.

* segments, schema and the bridge, the `encoder` subtree included, and
  a one-layer encoder and decoder (the reference keeps the one-layer
  decoder unstacked);
* `_sinusoid` over the encoder's 1500 positions (sinusoid_f32), at a
  scalar and at per-lane offsets (elementwise_f32);
* the encoder, use_pallas off and on, chunked and flash prefill, f32 and
  bf16 frames (logits_f32_encdec and logits_bf16_encdec, atol relative
  to max |ref|: at the reference's init the residual stream reaches ~50,
  and the JAX package's own chunked and Pallas forwards differ by up to
  0.79 of max|logit| 2.97 in bf16);
* `cross_kv_precompute`, and one `crossdec` block at prefill (its cross
  K/V written into the cache) and at decode (read from it);
* Model logits, a 6-token prefill then 3 decode steps, use_pallas and
  attention_impl off and on, bf16 weights with bf16 and with f32 frames,
  and f32 weights and frames;
* a one-token prompt: both packages ignore its frames (the decode path
  reads the fresh lane's zero cross K/V);
* served tokens against JAX's ServeEngine and ReferenceEngine (a
  difference only after a near tie, `token_margin`), and what a request
  with fewer frames than src_len leaves in its slot;
* the guarded engine (abft) serves the unguarded tokens, its decode
  state without the cross K/V;
* a paged engine refuses extras; whisper cannot be paged; the launcher
  fails at its first prefill with an error that names the frames;
* on the card (`gpu`): the reduced forward against its CPU plain
  version, 12 pod GEMMs and 2 flash launches an encoder pass, 13 and 2 a
  decoder prefill, 13 and none a decode step.
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
from repro.models import attention as jattn
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
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.systolic_gemm.systolic_gemm import systolic_gemm_cuda
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr
from repro_torch.models.attention import KVCache
from repro_torch.models.model import CrossKV, Model
from repro_torch.models.transformer import segments
from repro_torch.serve.admission import InvalidRequest
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.reference import ReferenceEngine

ARCH = "whisper-small"
SRC_LEN = 8
ROOT = Path(__file__).resolve().parents[1]
T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the model's tolerances: its large residual stream (runtime.TOLERANCES)
TOL = {"float32": "logits_f32_encdec", "bfloat16": "logits_bf16_encdec"}


def _close(got: torch.Tensor, ref, tol, scale: float):
    """Within tol, atol relative to `scale` (max |ref|)."""
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    err = (got.float() - ref_t).abs()
    assert bool((err <= tol.atol * scale + tol.rtol * ref_t.abs()).all()), (
        f"max_abs_err {float(err.max())} of max|ref| {scale} ({tol})")


def _scale(ref) -> float:
    return float(np.abs(np.asarray(ref, np.float32)).max())


def _frames(seed: int, n: int = SRC_LEN, batch: int = 1, d: int = 64):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def bridged():
    """The JAX and port configs, JAX parameters in bf16 and f32, and the
    port's (bridged) in both dtypes."""
    cfg = reduced(get_arch(ARCH))
    tm = Model(t_reduced(t_get_arch(ARCH)), device="cpu")
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jps = {"bfloat16": jp, "float32": jp32}
    tps = {k: model_params_from_jax(tm, jax.tree.map(np.asarray, v))
           for k, v in jps.items()}
    return cfg, tm.cfg, jps, tps


# --------------------------------------------------------------------------
# segments, schema and the bridge
# --------------------------------------------------------------------------

def _walk(j, t, s, stacked, path=()):
    """Every leaf of the JAX tree `j` equal to the port's `t`, whose shape
    is the schema `s`'s; a leaf under a path that `stacked` names gains
    the port's leading layer axis."""
    if isinstance(j, dict):
        assert set(j) == set(t) == set(s), path
        for k in j:
            _walk(j[k], t[k], s[k], stacked, path + (k,))
        return
    shape = ((1,) if stacked(path) else ()) + tuple(j.shape)
    assert tuple(t.shape) == shape == tuple(s.shape), path
    assert torch.equal(t.reshape(j.shape), T(j)), path


def test_segments_schema_and_bridge(bridged):
    """whisper's segments are the reference's (the decoder; the encoder
    is a subtree of its own); the schema has the reference's leaves and
    shapes, encoder and cross attention included; the bridge carries
    every leaf. With one layer each, the reference keeps the encoder
    stacked [1, ...] and the decoder unstacked: the bridge stacks the
    decoder only."""
    cfg, tcfg, jps, tps = bridged
    full = [(s.name, s.kind, s.n) for s in segments(t_get_arch(ARCH))]
    assert full == [("dec", "crossdec", 12)] == \
        [(s.name, s.kind, s.n) for s in jtr.segments(get_arch(ARCH))]
    assert [(s.name, s.kind, s.n) for s in segments(tcfg)] == \
        [("dec", "crossdec", 2)]
    jsch = JaxModel(get_arch(ARCH)).schema()
    tsch = Model(t_get_arch(ARCH), device="cpu").schema()
    shapes = lambda sch: jax.tree.map(lambda s: tuple(s.shape), sch,
                                      is_leaf=lambda s: hasattr(s, "shape"))
    assert shapes(tsch) == shapes(jsch)
    assert set(tsch["dec"]) == {"ln_attn", "attn", "ln_cross", "cross",
                                "ln_mlp", "mlp"}
    assert set(tsch["encoder"]["blocks"]) == {"ln_attn", "attn", "ln_mlp",
                                              "mlp"}
    assert Model(t_get_arch(ARCH), device="cpu").param_count() == \
        JaxModel(get_arch(ARCH)).param_count()
    _walk(jps["bfloat16"], tps["bfloat16"],
          Model(tcfg, device="cpu").schema(), lambda path: False)
    one = dataclasses.replace(cfg, n_layers=1, n_encoder_layers=1)
    tone = dataclasses.replace(tcfg, n_layers=1, n_encoder_layers=1)
    jp1 = JaxModel(one).init(jax.random.PRNGKey(1))
    assert jp1["encoder"]["blocks"]["attn"]["q"].shape[0] == 1
    assert jp1["dec"]["attn"]["q"].ndim == 3           # unstacked
    tm1 = Model(tone, device="cpu")
    tp1 = model_params_from_jax(tm1, jax.tree.map(np.asarray, jp1))
    _walk(jp1, tp1, tm1.schema(), lambda path: path[0] == "dec")


# --------------------------------------------------------------------------
# positions, encoder, cross K/V and the crossdec block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("offset", ["zero", "scalar", "per_lane"])
def test_sinusoid_matches_jax(offset):
    """sin and cos concatenated in f32: at offset 0 over 1500 positions
    (the encoder's, sinusoid_f32: XLA's f32 pow and torch's round a few
    denominators apart), at a scalar offset, and at per-lane [B] decode
    offsets (elementwise_f32)."""
    seq, d = (1500, 768) if offset == "zero" else (1, 64)
    off = {"zero": 0, "scalar": 37,
           "per_lane": np.array([3, 447, 0, 120])}[offset]
    ref = jmodel._sinusoid(seq, d, offset=jnp.asarray(off))
    got = tmodel._sinusoid(seq, d, offset=off if isinstance(off, int)
                           else torch.from_numpy(off))
    assert got.dtype == torch.float32
    tol = TOLERANCES["sinusoid_f32" if offset == "zero"
                     else "elementwise_f32"]
    assert tuple(got.shape) == tuple(ref.shape)
    ref = torch.from_numpy(np.array(ref))
    assert tol.ok(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "kernels"])
def test_encoder_matches_jax(bridged, use_pallas, impl, frames_dtype):
    """The encoder over 2 lanes of SRC_LEN frames on bf16 weights: its
    non-causal self-attention chunked or on flash (JAX's Pallas kernel in
    interpret mode), the projections and MLP (GELU in the epilogue) on
    einsums or the pod GEMM. It runs in the frames' dtype."""
    cfg, tcfg, jps, tps = bridged
    jdt, tdt = DTYPES[frames_dtype]
    fr = _frames(11, batch=2)
    jm = JaxModel(cfg, attention_impl=impl, use_pallas=use_pallas)
    tm = Model(tcfg, attention_impl=impl, use_pallas=use_pallas,
               device="cpu")
    ref = jax.jit(jm._encode)(jps["bfloat16"], jnp.asarray(fr, jdt))
    got = tm._encode(tps["bfloat16"], torch.from_numpy(fr).to(tdt))
    assert got.dtype == tdt
    _close(got, ref, TOLERANCES[TOL[frames_dtype]], _scale(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_precompute_matches_jax(bridged, dtype):
    """K and V of layer 1's cross attention from an encoder output, in
    the promoted dtype (f32 source against bf16 weights: f32)."""
    cfg, tcfg, jps, tps = bridged
    jdt, tdt = DTYPES[dtype]
    src = _frames(12, batch=2)
    jp = jax.tree.map(lambda a: a[1], jps["bfloat16"]["dec"]["cross"])
    tp = {k: v[1] for k, v in tps["bfloat16"]["dec"]["cross"].items()}
    jk, jv = jtr.cross_kv_precompute(jp, jnp.asarray(src, jdt), cfg)
    tk, tv = ttr.cross_kv_precompute(tp, torch.from_numpy(src).to(tdt), tcfg)
    tol = TOLERANCES["logits_f32" if dtype == "float32" else "logits_bf16"]
    for got, ref in ((tk, jk), (tv, jv)):
        assert got.dtype == tdt
        _close(got, ref, tol, _scale(ref))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_crossdec_block_matches_jax(bridged, mode):
    """Decoder layer 0 in bf16 with its cache. prefill: 6 tokens of 2
    lanes into empty caches, the cross K/V computed from an f32 encoder
    output (f32 K/V in the attention, bf16 in the cache). decode: one
    token a lane over a KV cache holding 5 and 11 positions and a cross
    cache of random K/V, which is read and left as it was."""
    cfg, tcfg, jps, tps = bridged
    jp = jax.tree.map(lambda a: a[0], jps["bfloat16"]["dec"])
    tp = jax.tree.map(lambda a: a[0], tps["bfloat16"]["dec"])
    rng = np.random.default_rng(5)
    B, S_max, H, hd = 2, 16, cfg.n_kv_heads, cfg.resolved_head_dim
    bf = jnp.bfloat16
    if mode == "prefill":
        S, lengths = 6, np.zeros(B, np.int32)
        kv0 = np.zeros((B, S_max, H, hd), np.float32)
        cross0 = np.zeros((B, SRC_LEN, H, hd), np.float32)
        jpos, tpos = jnp.arange(S), torch.arange(S)
        src = _frames(13, batch=B)
    else:
        S, lengths = 1, np.array([5, 11], np.int32)
        kv0 = rng.standard_normal((B, S_max, H, hd))
        cross0 = rng.standard_normal((B, SRC_LEN, H, hd))
        jpos = jnp.asarray(lengths)[:, None]
        tpos = torch.from_numpy(lengths).long()[:, None]
        src = None
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), bf)
    jcache = {"attn": jattn.KVCache(jnp.asarray(kv0, bf), jnp.asarray(kv0, bf),
                                    jnp.asarray(lengths)),
              "cross": jmodel.CrossKV(jnp.asarray(cross0, bf),
                                      jnp.asarray(cross0, bf))}
    tcache = {"attn": KVCache(T(jcache["attn"].k), T(jcache["attn"].v),
                              torch.from_numpy(lengths).long()),
              "cross": CrossKV(T(jcache["cross"].k), T(jcache["cross"].v))}
    ref, jnew = jax.jit(lambda p, x, pos, c, src: jtr.apply_block(
        p, x, cfg, "crossdec", positions=pos, cache=c, cross_src=src))(
        jp, x, jpos, jcache, None if src is None else jnp.asarray(src))
    got = ttr.apply_block(
        tp, T(x), tcfg, "crossdec", positions=tpos, cache=tcache,
        cross_src=None if src is None else torch.from_numpy(src))
    tol = TOLERANCES["logits_bf16"]
    assert got.dtype == torch.bfloat16
    _close(got, ref, tol, _scale(ref))
    assert tcache["attn"].length.tolist() == \
        np.asarray(jnew["attn"].length).tolist()
    for a, b in ((tcache["attn"].k, jnew["attn"].k),
                 (tcache["attn"].v, jnew["attn"].v)):
        _close(a, b, tol, _scale(b))
    for a, b in ((tcache["cross"].k, jnew["cross"].k),
                 (tcache["cross"].v, jnew["cross"].v)):
        assert a.dtype == torch.bfloat16
        if mode == "decode":         # read, never written
            assert torch.equal(a, T(b))
        else:                        # JAX returns the fresh f32 K/V
            assert jnp.asarray(b).dtype == jnp.float32
            assert torch.equal(a, T(jnp.asarray(b).astype(bf)))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

CASES = {"bf16": ("bfloat16", "bfloat16"), "bf16_f32frames":
         ("bfloat16", "float32"), "f32": ("float32", "float32")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "kernels"])
def test_model_logits_match_jax(bridged, use_pallas, case):
    """A 6-token prefill of 2 lanes with SRC_LEN frames each, then 3
    decode steps at per-lane positions, against the JAX Model on the same
    parameters: every projection, the MLPs and the head on the pod GEMM
    and the self-attention prefill on flash when use_pallas (JAX's
    kernels in interpret mode), the cross attention on einsums either
    way. f32 frames on bf16 weights run the encoder and the prefill's
    cross K/V in f32 and the rest in bf16 (logits_bf16_encdec); f32
    weights and frames are f32 throughout (logits_f32_encdec)."""
    cfg, tcfg, jps, tps = bridged
    pdt, fdt = CASES[case]
    (jdt, tdt), (jfdt, tfdt) = DTYPES[pdt], DTYPES[fdt]
    jp, tp = jps[pdt], tps[pdt]
    impl = "pallas" if use_pallas else "chunked"
    jm = JaxModel(cfg, attention_impl=impl, use_pallas=use_pallas)
    tm = Model(tcfg, attention_impl=impl, use_pallas=use_pallas,
               device="cpu")
    tol = TOLERANCES[TOL[pdt]]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6))
    fr = _frames(21, batch=2)
    jl, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "frames": jnp.asarray(fr, jfdt)},
        jm.init_cache(2, 16, src_len=SRC_LEN, dtype=jdt))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "frames": torch.from_numpy(fr).to(tfdt)},
                        tm.init_cache(2, 16, dtype=tdt, src_len=SRC_LEN))
    scale = _scale(jl)
    _close(tl, jl, tol, scale)
    assert tc["dec"]["cross"].k.dtype == tdt
    _close(tc["dec"]["cross"].k, jc["dec"]["cross"].k, tol,
           _scale(jc["dec"]["cross"].k))
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
    assert tc["dec"]["attn"].length.tolist() == [[9, 9]] * 2


def test_one_token_prompt_ignores_its_frames(bridged):
    """A one-token prompt prefills through the decode path in both
    packages (a cache and S == 1: no encoder), so its cross attention
    reads the fresh lane's zero cross K/V and its frames change nothing:
    the port's logits are bit-equal for two sets of frames and agree with
    JAX's."""
    cfg, tcfg, jps, tps = bridged
    jm = JaxModel(cfg, use_pallas=True)
    tm = Model(tcfg, use_pallas=True, device="cpu")
    tok = np.array([[17]])
    outs = []
    for seed in (31, 32):
        fr = _frames(seed)
        tl, tc = tm.prefill(tps["bfloat16"], {
            "tokens": torch.from_numpy(tok), "frames": torch.from_numpy(fr)},
            tm.init_cache(1, 16, src_len=SRC_LEN))
        assert not tc["dec"]["cross"].k.any()
        outs.append(tl)
    assert torch.equal(outs[0], outs[1])
    jl, _ = jm.prefill(jps["bfloat16"], {
        "tokens": jnp.asarray(tok, jnp.int32),
        "frames": jnp.asarray(_frames(31))},
        jm.init_cache(1, 16, src_len=SRC_LEN))
    _close(outs[0], jl, TOLERANCES["logits_bf16"], _scale(jl))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _prompts(vocab):
    """The first three of tests/test_serve_matrix.py::_parity's prompt
    lengths (each prompt length costs the JAX engines one compile of
    their interpreted Pallas kernels)."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in (4, 9, 6)]


def _serve(engine, prompts, frames, max_new=3, cls=Request):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new,
                extras={"frames": f})
            for i, (p, f) in enumerate(zip(prompts, frames))]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _margin_rule(jm, jp, p, f, a, b):
    """Equal tokens, or a first difference after a near tie of the JAX
    model's logits there."""
    assert len(a) == len(b)
    if a == b:
        return
    j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    seq = jnp.asarray(np.concatenate([p, b[:j]]).astype(np.int32))
    logits, _ = jm.forward(jp, {"tokens": seq[None],
                                "frames": jnp.asarray(f)})
    last = np.asarray(logits[0, -1], np.float32)
    top2 = np.sort(last)[-2:]
    assert top2[1] - top2[0] <= \
        TOLERANCES["token_margin"].atol * np.abs(last).max(), (p, a, b)


def test_serve_engines_match_jax_engines(bridged):
    """Port ServeEngine vs JAX ServeEngine and port ReferenceEngine vs JAX
    ReferenceEngine (slots 2, max_len 32, src_len SRC_LEN, 3 new tokens,
    use_pallas and flash prefill on), each request with its own f32
    frames: equal tokens, or a first difference after a near tie of the
    reference's logits."""
    cfg, tcfg, jps, tps = bridged
    jp, tp = jps["bfloat16"], tps["bfloat16"]
    jm = JaxModel(cfg, attention_impl="pallas", use_pallas=True)
    tm = Model(tcfg, attention_impl="pallas", use_pallas=True, device="cpu")
    prompts = _prompts(cfg.vocab)
    frames = [_frames(40 + i) for i in range(len(prompts))]
    kw = dict(slots=2, max_len=32, src_len=SRC_LEN)
    pairs = [(JaxServeEngine(jm, jp, **kw), ServeEngine(tm, tp, **kw)),
             (JaxReferenceEngine(jm, jp, **kw),
              ReferenceEngine(tm, tp, **kw))]
    for jeng, teng in pairs:
        ref = _serve(jeng, prompts, frames, cls=JaxRequest)
        got = _serve(teng, prompts, frames)
        for p, f, a, b in zip(prompts, frames, got, ref):
            assert len(a) == 3
            _margin_rule(jm, jp, p, f, a, b)
    assert teng.cache["dec"]["cross"].k.shape == (2, 2, SRC_LEN, 2, 16)


def test_short_frames_leave_zero_rows_in_their_slot(bridged):
    """A request with fewer frames than src_len (6 of 8), served in the
    slot a full-length request left: the port copies the whole fresh
    lane, so the slot's last 2 cross K/V rows are zero, and decode attends
    them (scores 0, values 0: the cross attention has no length mask), as
    the JAX engine does. Tokens equal JAX's ServeEngine's under the
    margin rule on einsums."""
    cfg, tcfg, jps, tps = bridged
    jp, tp = jps["bfloat16"], tps["bfloat16"]
    jm, tm = JaxModel(cfg), Model(tcfg, device="cpu")
    prompts = _prompts(cfg.vocab)[:2]
    frames = [_frames(50), _frames(51, n=6)]
    kw = dict(slots=1, max_len=32, src_len=SRC_LEN)
    jeng, teng = JaxServeEngine(jm, jp, **kw), ServeEngine(tm, tp, **kw)
    ref = _serve(jeng, prompts, frames, cls=JaxRequest)
    got = _serve(teng, prompts, frames)
    for p, f, a, b in zip(prompts, frames, got, ref):
        _margin_rule(jm, jp, p, f, a, b)
    tk = teng.cache["dec"]["cross"].k
    jk = np.asarray(jeng.cache["dec"]["cross"].k.astype(jnp.float32))
    assert not tk[:, 0, 6:].any() and not jk[:, 0, 6:].any()
    assert tk[:, 0, :6].any()


def test_guarded_engine_serves_whisper(bridged):
    """Under the SDC guard (abft) every decode step's pod GEMMs run
    guarded, and the engine saves the state a decode chunk advances before
    each guarded call: the KV lengths, not the cross K/V, which decode
    never writes. Clean abft serves the unguarded engine's tokens."""
    cfg, tcfg, jps, tps = bridged
    tm = Model(tcfg, use_pallas=True, device="cpu")
    prompts = _prompts(cfg.vocab)[:2]
    frames = [_frames(70), _frames(71)]
    kw = dict(slots=2, max_len=32, src_len=SRC_LEN)
    off = _serve(ServeEngine(tm, tps["bfloat16"], **kw), prompts, frames)
    eng = ServeEngine(tm, tps["bfloat16"], guard="abft", **kw)
    assert _serve(eng, prompts, frames) == off
    cross = eng.cache["dec"]["cross"]
    assert not any(t is cross.k or t is cross.v for t in
                   engine_mod._decode_state(eng.cache))
    assert eng.guard_events["uncorrectable"] == 0


def test_paged_engine_refuses_extras_as_the_reference():
    """A paged engine raises InvalidRequest("extras") at submit with the
    reference's message (on reduced granite, a bucketed family); whisper
    is not a bucketed family, so its paged engine is refused at
    construction, as in the reference."""
    cfg = reduced(get_arch("granite-8b"))
    tcfg = t_reduced(t_get_arch("granite-8b"))
    jm = JaxModel(cfg)
    tm = Model(tcfg, device="cpu")
    prompt = np.arange(5, dtype=np.int32)
    kw = dict(slots=2, max_len=32, paged=True, page_size=8)
    jeng = JaxServeEngine(jm, jm.init(jax.random.PRNGKey(0)), **kw)
    teng = ServeEngine(tm, {}, **kw)
    with pytest.raises(JaxInvalidRequest) as jerr:
        jeng.submit(JaxRequest(rid=0, prompt=prompt,
                               extras={"frames": _frames(1)}))
    with pytest.raises(InvalidRequest) as terr:
        teng.submit(Request(rid=0, prompt=prompt,
                            extras={"frames": _frames(1)}))
    assert terr.value.field == jerr.value.field == "extras"
    assert str(terr.value) == str(jerr.value)
    assert not teng.queue
    wm = Model(t_reduced(t_get_arch(ARCH)), device="cpu")
    with pytest.raises(ValueError, match="bucketed"):
        ServeEngine(wm, {}, src_len=SRC_LEN, **kw)
    assert not wm.bucketed_prefill_ok


def test_serve_launcher_fails_on_whisper_naming_the_frames():
    """python -m repro_torch.launch.serve --arch whisper-small --reduced
    --device cpu: the launcher passes no frames (the reference's has no
    option for them and fails with KeyError 'frames' at its first
    prefill), so the port's fails there too, naming them."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    last = proc.stderr.strip().splitlines()[-1]
    assert last.startswith("KeyError") and "frames" in last, proc.stderr


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_reduced_whisper_on_card_launches_the_kernels(cuda_device, bridged):
    """Reduced whisper on CUDA tensors (use_pallas, flash prefill), bf16
    frames, against the same calls on the CPU (plain versions) within
    logits_bf16_encdec: an encoder pass launches 12 pod GEMMs (q, k, v, o, up,
    down a layer) and 2 flash, the decoder of a prefill 13 (the head too)
    and 2 flash, a decode step 13 and no flash."""
    _, tcfg, _, tps = bridged
    tp = tps["bfloat16"]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab, (1, 6)))
    fr = torch.from_numpy(_frames(60)).to(torch.bfloat16)
    cpu = Model(tcfg, attention_impl="pallas", use_pallas=True, device="cpu")
    card = Model(tcfg, attention_impl="pallas", use_pallas=True,
                 device=cuda_device)
    tp_card = _to(tp, cuda_device)
    counts = lambda: (systolic_gemm_cuda.launches,
                      flash_attention_cuda.launches)
    n0 = counts()
    enc = card._encode(tp_card, fr.to(cuda_device))
    torch.cuda.synchronize()
    n1 = counts()
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (12, 2)
    _close(enc.cpu(), cpu._encode(tp, fr).float().numpy(),
           TOLERANCES["logits_bf16_encdec"], float(enc.float().abs().max()))
    ref, rc = cpu.prefill(tp, {"tokens": toks, "frames": fr},
                          cpu.init_cache(1, 16, src_len=SRC_LEN))
    cache = card.init_cache(1, 16, src_len=SRC_LEN)
    n0 = counts()
    got, cache = card.prefill(tp_card, {"tokens": toks.to(cuda_device),
                                        "frames": fr.to(cuda_device)}, cache)
    torch.cuda.synchronize()
    n1 = counts()
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (12 + 13, 2 + 2)
    scale = float(ref.float().abs().max())
    _close(got.cpu(), ref.float().numpy(), TOLERANCES["logits_bf16_encdec"], scale)
    tok = ref.argmax(-1)
    ref, _ = cpu.decode_step(tp, tok, rc, 6)
    n0 = counts()
    got, _ = card.decode_step(tp_card, tok.to(cuda_device), cache, 6)
    torch.cuda.synchronize()
    n1 = counts()
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (13, 0)
    _close(got.cpu(), ref.float().numpy(), TOLERANCES["logits_bf16_encdec"], scale)
