"""The port's serving engines against the JAX ReferenceEngine.

Prompts of tests/test_serve_matrix.py (seed 7, lengths 4/9/6/17/12,
slots=2, max_len=32, max_new=3) on reduced(granite-8b) with bridged
parameters and the pod-GEMM backend on both sides. Tokens must agree; where
they differ, the reference's top-1 minus top-2 logit at the first differing
step must be below TOLERANCES["token_margin"] (a near tie that bf16
rounding in another framework may flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models.model import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.reference import ReferenceEngine as JaxReferenceEngine
from repro_torch import HOST_SYNCS, TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models.model import Model
from repro_torch.serve.engine import (InvalidRequest, Request, ServeEngine)
from repro_torch.serve.reference import ReferenceEngine


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_arch("granite-8b"))
    jm = JaxModel(cfg, use_pallas=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(t_reduced(t_get_arch("granite-8b")), use_pallas=True,
               device="cpu")
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _prompts(vocab):
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
    """Reference top-1 minus top-2 logit, and max |logit|, for the token
    after prompt + prefix (teacher-forced, exact length)."""
    seq = jnp.asarray(np.concatenate([prompt, prefix]).astype(np.int32))
    logits, _ = jm.forward(jp, {"tokens": seq[None]})
    last = np.asarray(logits[0, -1], np.float32)
    top2 = np.sort(last)[-2:]
    return float(top2[1] - top2[0]), float(np.abs(last).max())


def test_serve_engine_matches_jax_reference(models):
    jm, jp, tm, tp = models
    prompts = _prompts(jm.cfg.vocab)
    ref = _serve(JaxReferenceEngine(jm, jp, slots=2, max_len=32,
                                    jit_prefill=True), prompts,
                 cls=JaxRequest)
    got = _serve(ServeEngine(tm, tp, slots=2, max_len=32), prompts)
    tol = TOLERANCES["token_margin"]
    for p, a, b in zip(prompts, got, ref):
        assert len(a) == len(b) == 3
        assert all(0 <= t < jm.cfg.vocab for t in a)
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            margin, top = _jax_margin(jm, jp, p, np.asarray(b[:j]))
            assert margin <= tol.atol * top, (p, a, b, margin, top)


def test_serve_engine_equals_port_reference(models):
    _, _, tm, tp = models
    prompts = _prompts(tm.cfg.vocab)
    ref = ReferenceEngine(tm, tp, slots=2, max_len=32)
    plain = _serve(ref, prompts, max_new=6)
    assert _serve(ServeEngine(tm, tp, slots=2, max_len=32), prompts,
                  max_new=6) == plain
    assert all(len(m) == 6 for m in ref.margins.values())
    # eos: a request stops at the eos token, inclusive, in both engines
    eos = plain[1][2]
    got = _serve(ServeEngine(tm, tp, slots=2, max_len=32, eos_id=eos),
                 prompts, max_new=6)
    assert got == _serve(ReferenceEngine(tm, tp, slots=2, max_len=32,
                                         eos_id=eos), prompts, max_new=6)
    assert got[1] == plain[1][:3]


def test_one_host_sync_per_prefill_group_and_decode_chunk(models):
    _, _, tm, tp = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 9, 17, 12, 33, 7)]
    eng = ServeEngine(tm, tp, slots=2, max_len=64, decode_chunk=8)
    before = HOST_SYNCS.count
    out = _serve(eng, prompts, max_new=5)
    syncs = HOST_SYNCS.count - before
    st = eng.stats
    assert syncs == st["prefill_calls"] + st["chunks"]
    assert st["decode_steps"] > st["chunks"]          # chunks fuse steps
    assert syncs < sum(len(o) for o in out)           # not once per token


def test_freed_lane_decodes_past_max_len_inertly(models):
    """A lane that finished keeps decoding inertly to the end of its chunk
    and in later chunks: its cache length runs past max_len, and its writes
    clamp onto the last slot as in the reference. Nothing raises, and the
    live lane's tokens are the oracles'."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab, 12, dtype=np.int32),
               rng.integers(0, tm.cfg.vocab, 2, dtype=np.int32)]
    budgets = (2, 14)

    def serve(engine, cls):
        reqs = [cls(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        for r in reqs:
            engine.submit(r)
        engine.run_to_completion(max_steps=100)
        return [r.out for r in reqs]

    eng = ServeEngine(tm, tp, slots=2, max_len=16, decode_chunk=8)
    got = serve(eng, Request)
    assert [len(o) for o in got] == [2, 14]
    assert int(eng.cache["layers"]["attn"].length[0, 0]) > 16
    assert got == serve(ReferenceEngine(tm, tp, slots=2, max_len=16),
                        Request)
    ref = serve(JaxReferenceEngine(jm, jp, slots=2, max_len=16,
                                   jit_prefill=True), JaxRequest)
    tol = TOLERANCES["token_margin"]
    for p, a, b in zip(prompts, got, ref):
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            margin, top = _jax_margin(jm, jp, p, np.asarray(b[:j]))
            assert margin <= tol.atol * top, (a, b, margin, top)


def test_invalid_requests_raise_at_submit(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, slots=2, max_len=16)
    for bad, field in ((Request(0, np.zeros(0, np.int32)), "prompt"),
                       (Request(1, np.zeros(17, np.int32)), "prompt"),
                       (Request(2, np.zeros(3, np.int32), max_new_tokens=0),
                        "max_new_tokens")):
        with pytest.raises(InvalidRequest) as err:
            eng.submit(bad)
        assert err.value.field == field
    assert not eng.queue


def test_bucketing_bounds_prefill_shapes(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, slots=4, max_len=64)
    assert [eng._bucket(n) for n in (1, 8, 9, 33, 64)] == [8, 8, 16, 64, 64]
    prompts = [np.arange(n) % tm.cfg.vocab for n in (5, 6, 7, 20)]
    _serve(eng, prompts, max_new=2)
    # the three bucket-8 prompts share one prefill, the bucket-32 one its own
    assert eng.stats["prefill_calls"] == 2
    assert torch.all(eng.cache["layers"]["attn"].length[:, 3] >= 20)
