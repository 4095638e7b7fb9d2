"""The port's SSM family (mamba2) against the JAX package, on the CPU.

reduced(mamba2-370m): 2 layers, d 64, 8 SSD heads of P 16, N 16, chunk
32, vocab 256, tied embeddings. Parameters come from the JAX Model and are
converted by bridge.params_from_jax; inputs from numpy seeds.

* the causal conv (with and without the true-length window) is exact;
* `apply_ssm` for a prefill, a decode step and a right-padded prefill with
  true_lens, both SSD impls, at `mixer_bf16` (XLA may keep a fused bf16
  product in f32 inside one jit, torch rounds each op); the conv window at
  `elementwise_bf16`;
* a bucketed prefill's state and last logits equal an exact-length
  prefill's (the dt-mask identity), bit for bit;
* Model logits with use_pallas and ssd_impl both off and both on, in bf16
  (`logits_bf16`) and f32 (`logits_f32`), prefill and decode;
* served tokens of the port's ServeEngine (dense and paged) against JAX's
  ReferenceEngine on the serve-matrix prompts, by the margin rule
  (`token_margin`); the port's own per-token ReferenceEngine over an
  SSMCache; paged tokens equal to dense and a drained pool.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import ssm as jssm
from repro.models.model import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.reference import ReferenceEngine as JaxReferenceEngine
from repro_torch import TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model
from repro_torch.models.transformer import segments
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.reference import ReferenceEngine

ARCH = "mamba2-370m"
T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)
SETTINGS = {"einsum": dict(use_pallas=False, ssd_impl="jnp"),
            "kernels": dict(use_pallas=True, ssd_impl="pallas")}


def _close(got: torch.Tensor, ref, tol, scale=None):
    """Within tol; with a scale (max |ref| of the logits) atol is relative
    to it, as in tests/test_torch_model.py."""
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    if scale is None:
        assert tol.ok(got.float(), ref_t), (
            f"excess {tol.excess(got.float(), ref_t)} ({tol})")
        return
    err = (got.float() - ref_t).abs()
    assert bool((err <= tol.atol * scale + tol.rtol * ref_t.abs()).all()), (
        f"max_abs_err {float(err.max())} ({tol})")


@pytest.fixture(scope="module")
def bf16_params():
    cfg = reduced(get_arch(ARCH))
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_causal_conv_matches_jax_with_true_length_window():
    """Exact in bf16; the true-length window of a lane shorter than K-1
    reaches into the zero padding."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 12, 24)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 24)) * 0.5, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(24) * 0.1, jnp.bfloat16)
    lens = np.array([12, 5, 2])
    for kw, tkw in (({}, {}), ({"true_lens": jnp.asarray(lens)},
                               {"true_lens": torch.from_numpy(lens)})):
        jy, jc = jssm._causal_conv(x, w, b, **kw)
        ty, tc = tssm._causal_conv(T(x), T(w), T(b), **tkw)
        assert torch.equal(ty, T(jy)) and torch.equal(tc, T(jc))
    # decode: one token against a given context
    ctx = jnp.asarray(rng.standard_normal((3, 3, 24)), jnp.bfloat16)
    jy, jc = jssm._causal_conv(x[:, :1], w, b, cache=ctx)
    ty, tc = tssm._causal_conv(T(x[:, :1]), T(w), T(b), cache=T(ctx))
    assert torch.equal(ty, T(jy)) and torch.equal(tc, T(jc))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_apply_ssm_matches_jax(bf16_params, impl):
    """Prefill into a cache, one decode step from it, and a right-padded
    prefill with true_lens: outputs and the cache (conv window, state)."""
    cfg, jp, tp = bf16_params
    tcfg = t_reduced(t_get_arch(ARCH))
    p = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
    q = {k: v[0] for k, v in tp["layers"]["ssm"].items()}
    tol, tol_conv = TOLERANCES["mixer_bf16"], TOLERANCES["elementwise_bf16"]
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal((2, 40, cfg.d_model)), jnp.bfloat16)
    jcache = jssm.SSMCache.zeros(cfg, 2)
    tcache = tssm.SSMCache.zeros(tcfg, 2)
    jo, jcache = jax.jit(lambda p, u, c: jssm.apply_ssm(
        p, u, cfg, cache=c, impl=impl))(p, u, jcache)
    to = tssm.apply_ssm(q, T(u), tcfg, cache=tcache, impl=impl)
    _close(to, jo, tol)
    _close(tcache.conv, jcache.conv, tol_conv)
    # the JAX wrapper's pallas state is the bf16 reference's; the port's
    # is the kernel's f32 state (tests/test_torch_ssd.py states the drift)
    _close(tcache.state, jcache.state, tol if impl == "jnp"
           else TOLERANCES["ssd_bf16_reference"])
    # one decode step from the same (JAX) state on both sides
    tcache = tssm.SSMCache(T(jcache.conv), T(jcache.state))
    u1 = jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)), jnp.bfloat16)
    jo, jcache = jssm.apply_ssm(p, u1, cfg, cache=jcache, impl=impl)
    to = tssm.apply_ssm(q, T(u1), tcfg, cache=tcache, impl=impl)
    _close(to, jo, tol)
    _close(tcache.state, jcache.state, tol)
    # right-padded prefill: lanes of 40 and 7 real tokens in a 40 bucket
    lens = np.array([40, 7])
    jcache = jssm.SSMCache.zeros(cfg, 2)
    tcache = tssm.SSMCache.zeros(tcfg, 2)
    jo, jcache = jax.jit(lambda p, u, c, l: jssm.apply_ssm(
        p, u, cfg, cache=c, impl=impl, true_lens=l))(
            p, u, jcache, jnp.asarray(lens))
    to = tssm.apply_ssm(q, T(u), tcfg, cache=tcache, impl=impl,
                        true_lens=torch.from_numpy(lens))
    _close(to[1, :7], jo[1, :7], tol)
    _close(tcache.conv, jcache.conv, tol_conv)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_bucketed_prefill_equals_exact_length(bf16_params, setting):
    """The dt-mask identity on the port: a lane right-padded to its bucket
    with true_lens leaves the same state, conv window and last-position
    logits as an exact-length prefill of that lane, bit for bit."""
    _, _, tp = bf16_params
    tm = Model(t_reduced(t_get_arch(ARCH)), device="cpu", **SETTINGS[setting])
    rng = np.random.default_rng(2)
    lens = [9, 17, 2]
    toks = np.zeros((3, 32), np.int64)
    for g, n in enumerate(lens):
        toks[g, :n] = rng.integers(0, 256, n)
    cache = tm.init_cache(3, 64)
    logits, cache = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                               cache=cache,
                               true_lens=torch.tensor(lens))
    for g, n in enumerate(lens):
        one = tm.init_cache(1, 64)
        last, one = tm.prefill(tp, {"tokens": torch.from_numpy(
            toks[g:g + 1, :n])}, one)
        assert torch.equal(logits[g, n - 1], last[0])
        big, small = cache["layers"]["ssm"], one["layers"]["ssm"]
        assert torch.equal(big.state[:, g], small.state[:, 0])
        assert torch.equal(big.conv[:, g], small.conv[:, 0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_model_logits_match_jax(setting, dtype):
    """Prefill then 6 decode steps against the JAX Model with the same
    settings (JAX's Pallas kernels in interpret mode, the port's plain
    versions), on bridged parameters."""
    cfg = reduced(get_arch(ARCH))
    jm = JaxModel(cfg, **SETTINGS[setting])
    tm = Model(t_reduced(t_get_arch(ARCH)), device="cpu", **SETTINGS[setting])
    jp = jm.init(jax.random.PRNGKey(0))
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jdt, tdt = jnp.float32, torch.float32
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tol = TOLERANCES["logits_bf16" if dtype == "bfloat16" else "logits_f32"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                 jm.init_cache(2, 64, dtype=jdt))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, 64, dtype=tdt))
    scale = float(np.abs(np.asarray(jl, np.float32)).max())
    _close(tl, jl, tol, scale)
    tok = np.asarray(jl, np.float32).argmax(-1)
    decode = jax.jit(jm.decode_step)
    for s in range(6):
        pos = np.array([40 + s, 40 + s])
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl, tol, scale)
        tok = np.asarray(jl, np.float32).argmax(-1)     # same inputs both


def _prompts(vocab):
    """tests/test_serve_matrix.py::_parity's prompts."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (4, 9, 6, 17, 12)]


def _serve(engine, prompts, max_new=3, cls=Request):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _jax_margin(jm, jp, prompt, prefix):
    seq = jnp.asarray(np.concatenate([prompt, prefix]).astype(np.int32))
    logits, _ = jm.forward(jp, {"tokens": seq[None]})
    last = np.asarray(logits[0, -1], np.float32)
    top2 = np.sort(last)[-2:]
    return float(top2[1] - top2[0]), float(np.abs(last).max())


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_serve_engine_matches_jax_reference(bf16_params, setting):
    """ServeEngine (bucketed prefill with true_lens, fused decode), dense
    and paged, against JAX's per-token ReferenceEngine of the same model:
    equal tokens, or a difference only after a near tie."""
    cfg, jp, tp = bf16_params
    jm = JaxModel(cfg, **SETTINGS[setting])
    tm = Model(t_reduced(t_get_arch(ARCH)), device="cpu", **SETTINGS[setting])
    prompts = _prompts(cfg.vocab)
    ref = _serve(JaxReferenceEngine(jm, jp, slots=2, max_len=32,
                                    jit_prefill=True), prompts,
                 cls=JaxRequest)
    dense = _serve(ServeEngine(tm, tp, slots=2, max_len=32), prompts)
    paged_eng = ServeEngine(tm, tp, slots=2, max_len=32, paged=True,
                            page_size=8)
    paged = _serve(paged_eng, prompts)
    assert paged == dense
    paged_eng._pool.assert_drained()
    tol = TOLERANCES["token_margin"]
    for p, a, b in zip(prompts, dense, ref):
        assert len(a) == len(b) == 3
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            margin, top = _jax_margin(jm, jp, p, np.asarray(b[:j]))
            assert margin <= tol.atol * top, (p, a, b, margin, top)


def test_port_reference_engine_serves_ssm_cache(bf16_params):
    """The port's per-token oracle over an SSMCache (exact-length prefill
    into a 1-lane cache, then _write_lane) gives the ServeEngine's tokens:
    its bucketed prefill equals an exact-length one bit for bit (above) and
    decode is the same arithmetic lane by lane."""
    cfg, _, tp = bf16_params
    tm = Model(t_reduced(t_get_arch(ARCH)), device="cpu", use_pallas=True,
               ssd_impl="pallas")
    prompts = _prompts(cfg.vocab)
    ref = _serve(ReferenceEngine(tm, tp, slots=2, max_len=32), prompts,
                 max_new=5)
    assert _serve(ServeEngine(tm, tp, slots=2, max_len=32), prompts,
                  max_new=5) == ref


def test_paged_engine_keeps_ssm_state_lane_resident(bf16_params):
    """paged=True accepts the ssm family as the reference does: nothing is
    paged, the state is reported as resident_lane_bytes, and the pool's
    reservations still drain."""
    cfg, _, tp = bf16_params
    tcfg = t_reduced(t_get_arch(ARCH))
    tm = Model(tcfg, device="cpu", use_pallas=True, ssd_impl="pallas")
    eng = ServeEngine(tm, tp, slots=2, max_len=32, paged=True, page_size=8)
    _serve(eng, _prompts(cfg.vocab))
    stats = eng.paged_kv_stats()
    s = tcfg.ssm
    di, H = s.d_inner(tcfg.d_model), s.n_heads(tcfg.d_model)
    lane = 2 * tcfg.n_layers * ((s.conv_kernel - 1) * (di + 2 * s.d_state)
                                + H * s.head_dim * s.d_state)
    assert stats["resident_lane_bytes"] == 2 * lane
    assert stats["kv_bytes_per_token"] == 0 and stats["mapped_bytes"] == 0
    assert eng.cache["layers"]["ssm"].lane_bytes() == lane
    eng._pool.assert_drained()


def test_segments_and_bucketing_cover_the_ported_families():
    assert segments(t_reduced(t_get_arch(ARCH)))[0].kind == "ssm"
    assert segments(t_reduced(t_get_arch("dbrx-132b")))[0].kind == "moe"
    audio = t_reduced(t_get_arch("whisper-small"))
    assert [(s.kind, s.n) for s in segments(audio)] == [("crossdec", 2)]
    vlm = t_reduced(t_get_arch("llama-3.2-vision-90b"))
    assert [(s.kind, s.n) for s in segments(vlm)] == [("vlm", 1)]
    assert Model(vlm, device="cpu").bucketed_prefill_ok is False
    with pytest.raises(ValueError, match="ssd_impl"):
        Model(t_reduced(t_get_arch(ARCH)), device="cpu", ssd_impl="cuda")
    # a cut of the same config keeps its schema
    cut = dataclasses.replace(t_reduced(t_get_arch(ARCH)), n_layers=1)
    assert Model(cut, device="cpu").schema()["layers"]["ssm"]["D"].shape == \
        (1, 8)
