"""The port's multi-head latent attention and deepseek-v2 against the JAX
package, on the CPU.

reduced(deepseek-v2-236b): 2 layers (segments dense0 | moe, one layer
each: the reference keeps them unstacked, bridge.model_params_from_jax
stacks them), d 64, 4 heads, MLA at kv_lora 32, q_lora 48, qk_nope 16,
qk_rope 8, v 16; 4 experts of d_ff 32, top 2, 1 shared expert; the first
layer's MLP d_ff 128. Parameters come from the JAX Model, inputs from
numpy seeds.

* the bridge carries every MLA leaf name for name and stacks both
  one-layer segments;
* `apply_mla` against JAX's: a 12-token prefill (K and V decompressed
  through kv_b) and the absorbed decode over caches of mixed per-lane
  lengths, f32 at `logits_f32` and bf16 at `logits_bf16` (atol relative
  to max |ref|), the latent rows it appends and the lengths;
* `MLACache.append` bit-equal to JAX's, a clamped start past max_len
  included;
* Model logits, a 12-token prefill and 3 decode steps, use_pallas off and
  on (JAX's Pallas kernels in interpret mode, the port's plain versions),
  f32 and bf16;
* served tokens (use_pallas on): the port's ServeEngine against JAX's
  ServeEngine and the port's ReferenceEngine against JAX's (at decode the
  batch is one routing group, so engines are compared with the engine
  that feeds the same dead lanes; a difference only after a near tie,
  `token_margin`);
* the paged cache refused with the reference's messages;
* the launcher serves reduced deepseek on the CPU;
* on the card (`gpu`): the reduced forward against its CPU plain version,
  7 pod-GEMM and 3 grouped launches a forward.
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
from repro.models import transformer as jtr
from repro.models.model import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.reference import ReferenceEngine as JaxReferenceEngine
from repro_torch import TOLERANCES
from repro_torch.bridge import model_params_from_jax, params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.kernels.systolic_gemm.systolic_gemm import (
    grouped_systolic_gemm_cuda, systolic_gemm_cuda)
from repro_torch.models import transformer as ttr
from repro_torch.models.model import Model
from repro_torch.models.transformer import segments
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.reference import ReferenceEngine

ARCH = "deepseek-v2-236b"
ROOT = Path(__file__).resolve().parents[1]
T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": "logits_f32", "bfloat16": "logits_bf16"}


def _close(got: torch.Tensor, ref, tol, scale: float):
    """Within tol, atol relative to `scale` (max |ref|)."""
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    err = (got.float() - ref_t).abs()
    assert bool((err <= tol.atol * scale + tol.rtol * ref_t.abs()).all()), (
        f"max_abs_err {float(err.max())} of max|ref| {scale} ({tol})")


def _scale(ref) -> float:
    return float(np.abs(np.asarray(ref, np.float32)).max())


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

def test_segments_schema_and_bridge(bridged):
    """deepseek-v2's segments are the reference's, at full depth and
    reduced; the MLA schema has the reference's leaves and shapes; the
    bridge stacks both one-layer segments and carries every leaf."""
    cfg, tcfg, jps, tps = bridged
    full = [(s.name, s.kind, s.n) for s in segments(t_get_arch(ARCH))]
    assert full == [("dense0", "dense", 1), ("moe", "moe", 59)]
    assert full == [(s.name, s.kind, s.n)
                    for s in jtr.segments(get_arch(ARCH))]
    assert [(s.name, s.kind, s.n) for s in segments(tcfg)] == \
        [("dense0", "dense", 1), ("moe", "moe", 1)]
    jsch = JaxModel(get_arch(ARCH)).schema()["moe"]["attn"]
    tsch = Model(t_get_arch(ARCH), device="cpu").schema()["moe"]["attn"]
    assert {k: v.shape for k, v in tsch.items()} == \
        {k: v.shape for k, v in jsch.items()}
    assert set(tsch) == {"q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm",
                         "kv_b", "o"}
    jp, tp = jps["bfloat16"], tps["bfloat16"]
    sch = Model(tcfg, device="cpu").schema()

    def walk(j, t, s, path):
        if isinstance(j, dict):
            assert set(j) == set(t) == set(s), path
            for k in j:
                walk(j[k], t[k], s[k], path + (k,))
            return
        stacked = path[0] in ("dense0", "moe")
        shape = ((1,) if stacked else ()) + tuple(j.shape)
        assert tuple(t.shape) == shape == tuple(s.shape), path
        assert torch.equal(t.reshape(j.shape), T(j)), path
    walk(jp, tp, sch, ())


# --------------------------------------------------------------------------
# the latent cache and apply_mla
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 3])
def test_mla_cache_append_bit_equal_to_jax(s):
    """Per-lane appends at lengths 0, 9 and past the end (14 + s > 16:
    the start clamps to max_len - s), bit for bit in bf16."""
    rng = np.random.default_rng(s)
    B, S_max, R, r = 3, 16, 32, 8
    lengths = np.array([0, 9, 14], np.int32)
    c0 = rng.standard_normal((B, S_max, R)).astype(np.float32)
    k0 = rng.standard_normal((B, S_max, r)).astype(np.float32)
    cn = rng.standard_normal((B, s, R)).astype(np.float32)
    kn = rng.standard_normal((B, s, r)).astype(np.float32)
    bf = jnp.bfloat16
    jc = jtr.MLACache(jnp.asarray(c0, bf), jnp.asarray(k0, bf),
                      jnp.asarray(lengths))
    jc = jc.append(jnp.asarray(cn, bf), jnp.asarray(kn, bf))
    tc = ttr.MLACache(T(jnp.asarray(c0, bf)), T(jnp.asarray(k0, bf)),
                      torch.from_numpy(lengths).long())
    tc.append(T(jnp.asarray(cn, bf)), T(jnp.asarray(kn, bf)))
    assert torch.equal(tc.c_kv, T(jc.c_kv))
    assert torch.equal(tc.k_rope, T(jc.k_rope))
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == \
        (lengths + s).tolist()
    # a stacked cache's layer() is a view: writes land in the stack
    st = ttr.MLACache.zeros(B, S_max, R, r, layers=2)
    st.layer(1).append(tc.c_kv[:, :s], tc.k_rope[:, :s])
    assert torch.equal(st.c_kv[1, :, :s], tc.c_kv[:, :s])
    assert st.length.tolist() == [[0] * B, [s] * B]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_mla_matches_jax(bridged, mode, dtype):
    """The moe layer's MLA on its own: prefill writes its latent into an
    empty cache; decode runs over a cache whose lanes hold 5 and 11
    positions (the rest random, masked), one token each."""
    cfg, tcfg, jps, tps = bridged
    jdt, tdt = DTYPES[dtype]
    jp = jps[dtype]["moe"]["attn"]
    tp = {k: v[0] for k, v in tps[dtype]["moe"]["attn"].items()}
    m = cfg.mla
    rng = np.random.default_rng(4)
    B, S_max = 2, 16
    if mode == "prefill":
        S, lengths = 12, np.zeros(B, np.int32)
        c0 = np.zeros((B, S_max, m.kv_lora_rank), np.float32)
        k0 = np.zeros((B, S_max, m.qk_rope_head_dim), np.float32)
        jpos, tpos = jnp.arange(S), torch.arange(S)
    else:
        S, lengths = 1, np.array([5, 11], np.int32)
        c0 = rng.standard_normal((B, S_max, m.kv_lora_rank))
        k0 = rng.standard_normal((B, S_max, m.qk_rope_head_dim))
        jpos = jnp.asarray(lengths)[:, None]
        tpos = torch.from_numpy(lengths).long()[:, None]
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), jdt)
    jc = jtr.MLACache(jnp.asarray(c0, jdt), jnp.asarray(k0, jdt),
                      jnp.asarray(lengths))
    tc = ttr.MLACache(T(jc.c_kv), T(jc.k_rope),
                      torch.from_numpy(lengths).long())
    ref, jc = jtr.apply_mla(jp, x, cfg, positions=jpos, cache=jc)
    got = ttr.apply_mla(tp, T(x), tcfg, positions=tpos, cache=tc)
    assert got.dtype == tdt
    tol = TOLERANCES[TOL[dtype]]
    _close(got, ref, tol, _scale(ref))
    assert tc.length.tolist() == np.asarray(jc.length).tolist()
    for a, b in ((tc.c_kv, jc.c_kv), (tc.k_rope, jc.k_rope)):
        _close(a, b, tol, _scale(b))
    if mode == "prefill":        # no cache: the same output, none written
        assert torch.equal(ttr.apply_mla(tp, T(x), tcfg, positions=tpos),
                           got)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "kernels"])
def test_model_logits_match_jax(bridged, use_pallas, dtype):
    """A 12-token prefill of 2 lanes, then 3 decode steps, against the JAX
    Model on the same parameters: the dense0 layer's MLP, the shared
    expert and the head on the pod GEMM and the routed experts on the
    grouped GEMM when use_pallas (JAX's kernels in interpret mode), MLA on
    einsums either way."""
    cfg, tcfg, jps, tps = bridged
    jdt, tdt = DTYPES[dtype]
    jp, tp = jps[dtype], tps[dtype]
    jm = JaxModel(cfg, use_pallas=use_pallas)
    tm = Model(tcfg, use_pallas=use_pallas, device="cpu")
    tol = TOLERANCES[TOL[dtype]]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 12))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                 jm.init_cache(2, 32, dtype=jdt))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, 32, dtype=tdt))
    scale = _scale(jl)
    _close(tl, jl, tol, scale)
    tok = np.asarray(jl, np.float32).argmax(-1)
    decode = jax.jit(jm.decode_step)
    for s in range(3):
        pos = np.array([12 + s, 12 + s])
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl, tol, scale)
        tok = np.asarray(jl, np.float32).argmax(-1)     # same inputs both
    assert tc["moe"]["attn"].length.tolist() == [[15, 15]]


def test_paged_mla_cache_refused_as_the_reference():
    """deepseek-v2 is a moe model: no bucketed prefill, so no paging; an
    MLA config of a bucketed family is refused for its latent cache. Both
    messages are the reference's."""
    for family in ("moe", "dense"):
        cfg = dataclasses.replace(reduced(get_arch(ARCH)), family=family)
        tcfg = dataclasses.replace(t_reduced(t_get_arch(ARCH)),
                                   family=family)
        with pytest.raises(ValueError) as jerr:
            JaxModel(cfg).init_cache(2, 32, page_size=8, kv_pages=8)
        with pytest.raises(ValueError) as terr:
            Model(tcfg, device="cpu").init_cache(2, 32, page_size=8,
                                                 kv_pages=8)
        assert str(terr.value) == str(jerr.value)
        assert ("MLA" in str(terr.value)) == (family == "dense")
    tm = Model(t_reduced(t_get_arch(ARCH)), device="cpu")
    with pytest.raises(ValueError, match="bucketed"):
        ServeEngine(tm, {}, slots=2, max_len=32, paged=True, page_size=8)
    cache = tm.init_cache(2, 32)
    assert {k: type(v["attn"]).__name__ for k, v in cache.items()} == \
        {"dense0": "MLACache", "moe": "MLACache"}
    assert tuple(cache["moe"]["attn"].c_kv.shape) == (1, 2, 32, 32)
    assert tuple(cache["moe"]["attn"].k_rope.shape) == (1, 2, 32, 8)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _prompts(vocab):
    """The first three of tests/test_serve_matrix.py::_parity's prompts
    (each prompt length costs the JAX ServeEngine one compile of its
    interpreted Pallas kernels)."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (4, 9, 6, 17, 12)][:3]


def _serve(engine, prompts, max_new=4, cls=Request):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def test_serve_engines_match_jax_engines(bridged):
    """Port ServeEngine vs JAX ServeEngine and port ReferenceEngine vs JAX
    ReferenceEngine (slots 2, max_len 32, 4 new tokens, use_pallas on):
    equal tokens, or a first difference after a near tie of the
    reference's logits."""
    cfg, tcfg, jps, tps = bridged
    jp, tp = jps["bfloat16"], tps["bfloat16"]
    jm = JaxModel(cfg, use_pallas=True)
    tm = Model(tcfg, use_pallas=True, device="cpu")
    prompts = _prompts(cfg.vocab)
    tol = TOLERANCES["token_margin"]
    pairs = [(JaxServeEngine(jm, jp, slots=2, max_len=32),
              ServeEngine(tm, tp, slots=2, max_len=32)),
             (JaxReferenceEngine(jm, jp, slots=2, max_len=32),
              ReferenceEngine(tm, tp, slots=2, max_len=32))]
    for jeng, teng in pairs:
        ref = _serve(jeng, prompts, cls=JaxRequest)
        got = _serve(teng, prompts)
        for p, a, b in zip(prompts, got, ref):
            assert len(a) == len(b) == 4
            if a != b:
                j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                seq = jnp.asarray(np.concatenate([p, b[:j]]).astype(np.int32))
                logits, _ = jm.forward(jp, {"tokens": seq[None]})
                last = np.asarray(logits[0, -1], np.float32)
                top2 = np.sort(last)[-2:]
                assert top2[1] - top2[0] <= tol.atol * np.abs(last).max(), \
                    (p, a, b)


def test_serve_launcher_serves_deepseek_on_the_cpu():
    """python -m repro_torch.launch.serve --arch deepseek-v2-236b
    --reduced --device cpu: every request done with its tokens."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "4", "--max-new",
         "5"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == \
        [f"req {i}" for i in range(4)]
    for ln in lines[:4]:
        assert "]  [" not in ln, ln         # a request not done: its state
        assert len(ln.split("->")[1].strip(" []").split(",")) == 5
    assert lines[4].startswith("4 requests, 20 tokens")


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
def test_reduced_forward_on_card_launches_the_pod_kernels(cuda_device,
                                                          bridged):
    """Reduced deepseek's forward on CUDA tensors (use_pallas) against the
    same forward on the CPU (plain versions) within logits_bf16: 7 pod
    GEMMs a forward (the dense layer's gate, up and down, the shared
    expert's three, the head) and 3 grouped (the routed experts)."""
    _, tcfg, _, tps = bridged
    tp = tps["bfloat16"]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab, (2, 12)))
    ref, _ = Model(tcfg, use_pallas=True, device="cpu").forward(
        tp, {"tokens": toks})
    card = Model(tcfg, use_pallas=True, device=cuda_device)
    tp_card = _to(tp, cuda_device)
    n0, g0 = systolic_gemm_cuda.launches, grouped_systolic_gemm_cuda.launches
    got, _ = card.forward(tp_card, {"tokens": toks.to(cuda_device)})
    torch.cuda.synchronize()
    assert systolic_gemm_cuda.launches - n0 == 7
    assert grouped_systolic_gemm_cuda.launches - g0 == 3
    _close(got.cpu(), ref.float().numpy(), TOLERANCES["logits_bf16"],
           float(ref.float().abs().max()))
