"""The dense archs beyond granite-8b (yi-6b, minitron-8b, nemotron-4-340b)
against the JAX package, at their reduced() size on the CPU.

yi-6b is llama-shaped (gated SiLU MLP); minitron-8b and nemotron-4-340b
use the ungated relu2 MLP, whose activation runs in up's epilogue on the
pod GEMM. For each arch: model logits of one prefill and 8 decode steps
against the JAX Model with use_pallas=True, in bf16
(TOLERANCES["logits_bf16"]) and with every parameter in f32
(TOLERANCES["logits_f32"]), also with the arch's own rope_theta (reduced()
keeps the default); served tokens of the port's ServeEngine, dense and
paged, against the JAX ReferenceEngine under the margin rule of
tests/test_torch_serve.py. One guarded engine (abft, SDC injected) on
reduced minitron, where relu2 runs after the raw guarded GEMM: every
injected element corrected and the tokens those of the clean engine.
Full width (head_dim 192 on flash's mma mainloop, rope_theta 5e6, vocab
256000) runs on the card (chip_smoke.py phase dense_archs).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models.model import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.reference import ReferenceEngine as JaxReferenceEngine
from repro_torch import TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models.model import Model
from repro_torch.serve.chaos import ChaosConfig, VirtualClock
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("yi-6b", "minitron-8b", "nemotron-4-340b")


def _cfgs(arch: str, own_theta: bool):
    cfg, tcfg = reduced(get_arch(arch)), t_reduced(t_get_arch(arch))
    if own_theta:
        cfg = dataclasses.replace(cfg, rope_theta=get_arch(arch).rope_theta)
        tcfg = dataclasses.replace(tcfg,
                                   rope_theta=t_get_arch(arch).rope_theta)
    return cfg, tcfg


def _close(got: torch.Tensor, ref, tol, scale):
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    err = (got.float() - ref_t).abs()
    assert got.shape == ref_t.shape
    assert bool((err <= tol.atol * scale + tol.rtol * ref_t.abs()).all()), (
        f"max_abs_err {float(err.max())} ({tol})")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,own_theta", [("bfloat16", False),
                                             ("float32", False),
                                             ("float32", True)])
def test_model_logits_match_jax(arch, dtype, own_theta):
    cfg, tcfg = _cfgs(arch, own_theta)
    jm = JaxModel(cfg, use_pallas=True)
    tm = Model(tcfg, use_pallas=True, device="cpu")
    assert tm.cfg.activation == cfg.activation
    jp = jm.init(jax.random.PRNGKey(0))
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jdt, tdt = jnp.float32, torch.float32
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tol = TOLERANCES["logits_bf16" if dtype == "bfloat16" else "logits_f32"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                 jm.init_cache(2, 16, dtype=jdt))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, 16, dtype=tdt))
    scale = float(np.abs(np.asarray(jl, np.float32)).max())
    _close(tl, jl, tol, scale)
    tok = np.asarray(jl, np.float32).argmax(-1)
    decode = jax.jit(jm.decode_step)
    for s in range(8):
        pos = np.array([8 + s, 8 + s])
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl, tol, scale)
        tok = np.asarray(jl, np.float32).argmax(-1)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (4, 9, 6, 17, 12)]


def _serve(engine, prompts, max_new=4, cls=Request):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=300)
    assert all(r.state == "done" for r in reqs), [r.state for r in reqs]
    return [list(r.out) for r in reqs]


@functools.lru_cache(maxsize=None)
def _served(arch: str):
    """The JAX pod-GEMM model, its parameters, the port's model with the
    same parameters, and the JAX ReferenceEngine's tokens."""
    cfg = reduced(get_arch(arch))
    jm = JaxModel(cfg, use_pallas=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(t_reduced(t_get_arch(arch)), use_pallas=True, device="cpu")
    ref = _serve(JaxReferenceEngine(jm, jp, slots=2, max_len=32,
                                    jit_prefill=True), _prompts(cfg.vocab),
                 cls=JaxRequest)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp)), ref


def _assert_margin_rule(jm, jp, prompts, got, ref):
    """Equal tokens, or a first difference where the reference's top-1
    minus top-2 logit is within TOLERANCES["token_margin"]."""
    tol = TOLERANCES["token_margin"]
    for p, a, b in zip(prompts, got, ref):
        assert len(a) == len(b)
        assert all(0 <= t < jm.cfg.vocab for t in a)
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = jnp.asarray(np.concatenate([p, np.asarray(b[:j], np.int32)]))
            logits, _ = jm.forward(jp, {"tokens": seq[None]})
            last = np.asarray(logits[0, -1], np.float32)
            top2 = np.sort(last)[-2:]
            assert top2[1] - top2[0] <= tol.atol * np.abs(last).max(), \
                (p, a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("paged", [False, True])
def test_served_tokens_match_jax_reference(arch, paged):
    jm, jp, tm, tp, ref = _served(arch)
    kw = dict(paged=True, page_size=8) if paged else {}
    prompts = _prompts(jm.cfg.vocab)
    got = _serve(ServeEngine(tm, tp, slots=2, max_len=32, decode_chunk=4,
                             **kw), prompts)
    _assert_margin_rule(jm, jp, prompts, got, ref)


def test_guarded_minitron_corrects_sdc_with_relu2_after_the_raw_gemm():
    """abft on reduced minitron with a single element injected per hit:
    the hit lands in layer 0's up (GEMM 4: q, k, v, o, up), whose relu2
    runs in the epilogue after the raw guarded GEMM; every hit is
    corrected, and the tokens are the clean guarded engine's and within
    the margin rule of the JAX ReferenceEngine."""
    jm, jp, tm, tp, ref = _served("minitron-8b")
    assert tm.cfg.activation == "relu2"
    prompts = _prompts(jm.cfg.vocab)

    def run(**kw):
        eng = ServeEngine(tm, tp, slots=2, max_len=32, decode_chunk=4,
                          guard="abft", clock=VirtualClock(), **kw)
        return eng, _serve(eng, prompts)
    _, clean = run()
    eng, got = run(chaos=ChaosConfig(seed=7, p_sdc=0.5, sdc_elems=1,
                                     sdc_target=4, transient_tries=1))
    assert eng._chaos.injected["sdc"] > 0
    assert eng.guard_events["corrected"] > 0
    assert eng.guard_events["uncorrectable"] == 0
    assert got == clean
    _assert_margin_rule(jm, jp, prompts, got, ref)
