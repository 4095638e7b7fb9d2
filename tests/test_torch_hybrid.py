"""The port's hybrid family (hymba) against the JAX package, on the CPU.

reduced(hymba-1.5b): 2 layers, d 64, 4 heads over 2 KV heads of 16, an
8-head Mamba-2 mixer (P 16, N 16, chunk 32) beside the attention in every
layer, window 32, layer 0 global: segments glob0 | swa_tail, one layer
each (the reference keeps them unstacked; bridge.model_params_from_jax
stacks them). Parameters come from the JAX Model, inputs from numpy seeds.

* RingKVCache against the reference's: append_token across the wrap and
  positions() bit for bit; the bucketed gather (true_lens) and the
  exact-length roll of apply_gqa in f32, ring contents at
  `elementwise_f32` and lengths, positions and the zero slots exact;
* Model logits with use_pallas and ssd_impl both off and both on, in bf16
  (`logits_bf16`) and f32 (`logits_f32`): a 40-token prefill (its ring
  wraps) and 6 decode steps, each writing over the oldest slot, as in
  tests/test_torch_ssm.py. (Past that, f32 logits of this model drift
  from an f64 run by up to 2e-5 in JAX and 4e-5 in the port, near the
  tolerance's 1e-5 x max|logit|: random weights give large scores.)
* a bucketed prefill's rings, SSM state, conv window and last logits equal
  an exact-length prefill's, bit for bit;
* served tokens of the port's ServeEngine, dense and paged, against JAX's
  ReferenceEngine (margin rule, `token_margin`) and equal to the port's
  own ReferenceEngine, with prompts of 5, 33 and 47 tokens at max_len 64:
  the 33- and 47-token prompts wrap the ring in prefill, the 5-token one
  in decode; the pool drains;
* the paged engine's prefill transient keeps the engine's ring width while
  its dense KV spans only the bucket's pages;
* on the card (`gpu`): graphed equal to eager across the wrap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import attention as jatt
from repro.models import transformer as jtr
from repro.models.model import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.reference import ReferenceEngine as JaxReferenceEngine
from repro_torch import TOLERANCES
from repro_torch.bridge import model_params_from_jax, params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import attention as tatt
from repro_torch.models import transformer as ttr
from repro_torch.models.model import Model
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.reference import ReferenceEngine

ARCH = "hymba-1.5b"
T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)
SETTINGS = {"einsum": dict(use_pallas=False, ssd_impl="jnp"),
            "kernels": dict(use_pallas=True, ssd_impl="pallas")}
SERVE_LENS = (5, 33, 47)


def _tcfg():
    return t_reduced(t_get_arch(ARCH))


def _close(got: torch.Tensor, ref, tol, scale=None):
    """Within tol; with a scale (max |ref| of the logits) atol is relative
    to it, as in tests/test_torch_model.py."""
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    err = (got.float() - ref_t).abs()
    atol = tol.atol * (scale if scale is not None else 1.0)
    assert bool((err <= atol + tol.rtol * ref_t.abs()).all()), (
        f"max_abs_err {float(err.max())} ({tol})")


@pytest.fixture(scope="module")
def bf16_params():
    cfg = reduced(get_arch(ARCH))
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tm = Model(_tcfg(), device="cpu")
    return cfg, jp, model_params_from_jax(tm, jax.tree.map(np.asarray, jp))


# --------------------------------------------------------------------------
# the ring cache
# --------------------------------------------------------------------------

def test_ring_append_and_positions_match_reference():
    """Three lanes at lengths 0, 5 and 30 of a 8-slot ring take 12 decode
    writes each: every lane wraps, the first from empty. Contents, lengths
    and positions() bit for bit after every write."""
    rng = np.random.default_rng(0)
    B, W, H, D = 3, 8, 2, 4
    k0 = rng.standard_normal((B, W, H, D)).astype(np.float32)
    v0 = rng.standard_normal((B, W, H, D)).astype(np.float32)
    lens = np.array([0, 5, 30], np.int32)
    jring = jatt.RingKVCache(jnp.asarray(k0), jnp.asarray(v0),
                             jnp.asarray(lens))
    tring = tatt.RingKVCache(torch.from_numpy(k0.copy()),
                             torch.from_numpy(v0.copy()),
                             torch.from_numpy(lens.astype(np.int64)))
    assert torch.equal(tring.positions(), T(jring.positions()).long())
    for _ in range(12):
        kn = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        vn = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        jring = jring.append_token(jnp.asarray(kn), jnp.asarray(vn))
        tring.append_token(torch.from_numpy(kn), torch.from_numpy(vn))
        assert torch.equal(tring.k, T(jring.k))
        assert torch.equal(tring.v, T(jring.v))
        assert tring.length.tolist() == np.asarray(jring.length).tolist()
        assert torch.equal(tring.positions(), T(jring.positions()).long())


@pytest.mark.parametrize("mode", ["bucketed", "exact"])
def test_ring_prefill_matches_reference(bf16_params, mode):
    """apply_gqa of the window layer over a ring cache, in f32: bucketed
    (lanes of 40, 7, 32 and 33 real tokens in a 48 bucket: a wrapped lane,
    a short one, one of exactly W, one past it by one) gathers each lane's
    last-window real tokens into slot p % W; exact-length (S = 40, 20 and
    32) keeps the last W tokens rolled by S % W. Ring contents at
    elementwise_f32, the never-written slots exactly zero, lengths and
    positions() exact."""
    cfg, jp, _ = bf16_params
    tcfg = _tcfg()
    W = cfg.sliding_window
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp["swa_tail"])
    p = jp32["attn"]
    q = params_from_jax(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(1)
    tol = TOLERANCES["elementwise_f32"]
    if mode == "bucketed":
        runs = [(np.array([40, 7, 32, 33]), 48)]
    else:
        runs = [(None, S) for S in (40, 20, 32)]
    for lens, S in runs:
        B = 4 if lens is not None else 1
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        pos = np.arange(S)
        jc = jatt.RingKVCache.zeros(B, W, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, jnp.float32)
        tc = tatt.RingKVCache.zeros(B, W, tcfg.n_kv_heads,
                                    tcfg.resolved_head_dim, torch.float32)
        jl = None if lens is None else jnp.asarray(lens, jnp.int32)
        tl = None if lens is None else torch.from_numpy(lens)
        _, jc = jtr.apply_gqa(p, jnp.asarray(x), cfg,
                              positions=jnp.asarray(pos), window=W,
                              cache=jc, true_lens=jl)
        ttr.apply_gqa(q, torch.from_numpy(x), tcfg,
                      positions=torch.from_numpy(pos), window=W, cache=tc,
                      true_lens=tl)
        rows = lens if lens is not None else [S]
        _close(tc.k, jc.k, tol)
        _close(tc.v, jc.v, tol)
        zero = T(jc.k) == 0
        assert torch.equal(tc.k == 0, zero) and bool(zero.any()) == (
            min(rows) < W)
        assert tc.length.tolist() == np.asarray(jc.length).tolist()
        assert torch.equal(tc.positions(), T(jc.positions()).long())


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_segments_and_caches_of_the_hybrid_family():
    """Full hymba splits at its global layers 0, 15 and 31; reduced hymba
    is glob0 | swa_tail. A window segment caches a ring of min(window,
    ring_len) slots, a global one a KVCache (paged when asked), both
    beside an SSMCache."""
    full = ttr.segments(t_get_arch(ARCH))
    assert [(s.name, s.n, s.window) for s in full] == [
        ("glob0", 1, None), ("swa1", 14, 1024), ("glob1", 1, None),
        ("swa2", 15, 1024), ("glob2", 1, None)]
    assert {s.kind for s in full} == {"hybrid"}
    tm = Model(_tcfg(), device="cpu")
    assert [(s.name, s.n, s.window) for s in tm.segs] == [
        ("glob0", 1, None), ("swa_tail", 1, 32)]
    cache = tm.init_cache(2, 24, ring_len=64)
    assert isinstance(cache["glob0"]["attn"], tatt.KVCache)
    ring = cache["swa_tail"]["attn"]
    assert isinstance(ring, tatt.RingKVCache) and ring.window == 32
    assert tuple(ring.k.shape) == (1, 2, 32, 2, 16)
    assert tm.init_cache(2, 24)["swa_tail"]["attn"].window == 24
    paged = tm.init_cache(2, 64, page_size=8, kv_pages=10)
    assert isinstance(paged["glob0"]["attn"], tatt.PagedKVCache)
    assert isinstance(paged["swa_tail"]["attn"], tatt.RingKVCache)
    assert all(set(node) == {"attn", "ssm"} for node in paged.values())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_model_logits_match_jax(setting, dtype):
    """Prefill of 40 tokens (past the window of 32) then 6 decode steps
    against the JAX Model with the same settings (JAX's Pallas kernels in
    interpret mode, the port's plain versions), on bridged parameters."""
    cfg = reduced(get_arch(ARCH))
    jm = JaxModel(cfg, **SETTINGS[setting])
    tm = Model(_tcfg(), device="cpu", **SETTINGS[setting])
    jp = jm.init(jax.random.PRNGKey(0))
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jdt, tdt = jnp.float32, torch.float32
    tp = model_params_from_jax(tm, jax.tree.map(np.asarray, jp))
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
    assert tc["swa_tail"]["attn"].length.tolist() == [[46, 46]]


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_bucketed_prefill_equals_exact_length(bf16_params, setting):
    """Lanes of 40, 7 and 32 tokens right-padded to 64 with true_lens leave
    the same ring (contents and length), SSM state, conv window and
    last-position logits as an exact-length prefill of each lane, bit for
    bit; the global layer's KV agrees on the real positions (its length is
    the engine's fixup, _fix_lengths)."""
    _, _, tp = bf16_params
    tm = Model(_tcfg(), device="cpu", **SETTINGS[setting])
    rng = np.random.default_rng(2)
    lens = [40, 7, 32]
    toks = np.zeros((3, 64), np.int64)
    for g, n in enumerate(lens):
        toks[g, :n] = rng.integers(0, 256, n)
    cache = tm.init_cache(3, 64)
    logits, cache = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                               cache=cache, true_lens=torch.tensor(lens))
    for g, n in enumerate(lens):
        one = tm.init_cache(1, 64)
        last, one = tm.prefill(tp, {"tokens": torch.from_numpy(
            toks[g:g + 1, :n])}, one)
        assert torch.equal(logits[g, n - 1], last[0])
        ring, ring1 = cache["swa_tail"]["attn"], one["swa_tail"]["attn"]
        for a, b in ((ring.k, ring1.k), (ring.v, ring1.v),
                     (ring.length, ring1.length)):
            assert torch.equal(a[:, g], b[:, 0])
        kv, kv1 = cache["glob0"]["attn"], one["glob0"]["attn"]
        assert torch.equal(kv.k[:, g, :n], kv1.k[:, 0, :n])
        for name in ("glob0", "swa_tail"):
            big, small = cache[name]["ssm"], one[name]["ssm"]
            assert torch.equal(big.state[:, g], small.state[:, 0])
            assert torch.equal(big.conv[:, g], small.conv[:, 0])


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in SERVE_LENS]


def _serve(engine, prompts, max_new=30, cls=Request):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def test_serve_engine_matches_jax_reference(bf16_params):
    """ServeEngine (bucketed prefill: the ring gather; fused decode), dense
    and paged, against JAX's per-token ReferenceEngine of the same model
    with the pod GEMM and the SSD kernel on: equal tokens, or a difference
    only after a near tie; and equal to the port's own ReferenceEngine
    (exact-length prefill: the ring roll)."""
    cfg, jp, tp = bf16_params
    jm = JaxModel(cfg, **SETTINGS["kernels"])
    tm = Model(_tcfg(), device="cpu", **SETTINGS["kernels"])
    prompts = _prompts(cfg.vocab)
    ref = _serve(JaxReferenceEngine(jm, jp, slots=2, max_len=64,
                                    jit_prefill=True), prompts,
                 cls=JaxRequest)
    dense = _serve(ServeEngine(tm, tp, slots=2, max_len=64), prompts)
    paged_eng = ServeEngine(tm, tp, slots=2, max_len=64, paged=True,
                            page_size=8)
    assert _serve(paged_eng, prompts) == dense
    paged_eng._pool.assert_drained()
    assert _serve(ReferenceEngine(tm, tp, slots=2, max_len=64),
                  prompts) == dense
    # budgets clamp at max_len: 30 tokens, the 47-token prompt 18
    assert [len(o) for o in dense] == [30, 30, 18]
    tol = TOLERANCES["token_margin"]
    for p, a, b in zip(prompts, dense, ref):
        assert len(a) == len(b)
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = jnp.asarray(np.concatenate([p, b[:j]]).astype(np.int32))
            logits, _ = jm.forward(jp, {"tokens": seq[None]})
            last = np.asarray(logits[0, -1], np.float32)
            top2 = np.sort(last)[-2:]
            assert top2[1] - top2[0] <= tol.atol * np.abs(last).max(), \
                (p, a, b)


def test_paged_transient_keeps_the_engine_ring_width(bf16_params):
    """The paged engine's bucket-8 transient spans one page of dense KV
    but a ring of the engine's 32 slots, so each lane's ring copies into
    its slot whole; the rings count in resident_lane_bytes."""
    _, _, tp = bf16_params
    tm = Model(_tcfg(), device="cpu")
    eng = ServeEngine(tm, tp, slots=2, max_len=64, paged=True, page_size=8)
    _serve(eng, [np.arange(5), np.arange(6)], max_new=3)
    lane = eng._lane_caches[8]
    assert lane["swa_tail"]["attn"].window == \
        eng.cache["swa_tail"]["attn"].window == 32
    assert lane["glob0"]["attn"].k.shape[2] == 8
    ring = eng.cache["swa_tail"]["attn"]
    ssm = sum(eng.cache[s]["ssm"].lane_bytes() * 2 for s in eng.cache)
    assert eng.paged_kv_stats()["resident_lane_bytes"] == \
        ssm + ring.k.nbytes + ring.v.nbytes
    eng._pool.assert_drained()


# --------------------------------------------------------------------------
# on the card: real graphs
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graphed_equals_eager_across_the_ring_wrap(cuda_device, monkeypatch,
                                                   paged):
    """reduced hymba on the card (flash, SSD and pod-GEMM kernels), prompts
    that wrap the 32-slot ring in prefill and in decode, through an eager
    engine and a graphed one: equal tokens and every host read (first
    tokens, packed decode chunks) bit for bit, and the second pass of the
    graphed one a replay of every prefill and decode chunk."""
    model = Model(_tcfg(), attention_impl="pallas", ssd_impl="pallas",
                  use_pallas=True)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    kw = dict(slots=4, max_len=128, decode_chunk=8)
    if paged:
        kw.update(paged=True, page_size=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n)
               for n in (5, 60, 33, 100, 17)]

    def run(engine):
        reads = []

        def to_host(t):
            out = real(t)
            reads.append(out.copy())
            return out
        real = engine_mod.to_host
        monkeypatch.setattr(engine_mod, "to_host", to_host)
        tokens = _serve(engine, prompts, max_new=24)
        monkeypatch.setattr(engine_mod, "to_host", real)
        return tokens, reads

    eager = run(ServeEngine(model, params, eager=True, **kw))
    eng = ServeEngine(model, params, **kw)
    for _ in range(2):
        graphed = run(eng)
        assert graphed[0] == eager[0]
        assert len(graphed[1]) == len(eager[1])
        assert all(np.array_equal(a, b)
                   for a, b in zip(graphed[1], eager[1]))
    assert eng.stats["graphs"] == eng.prefill_compiles + eng.decode_compiles
