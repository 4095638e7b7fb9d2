"""The serve engine's compiled-step cache (repro_torch/serve/graphs.py and
the runners of serve/engine.py) against the JAX engine's jit caches.

On the CPU the step runners run their bodies eagerly through the same
static buffers a CUDA graph captures, so these tests check the code that
is captured: the static-buffer rewrite of bucketed prefill and decode, the
slot routing on the device (-1 marks a pad lane), and the reset of a
bucket's static lane cache. The compile-count gates of
tests/test_serving.py are ported as runner counts and held against the JAX
engine's own counts on the same prompts (reduced() configs, slots 2,
max_len 64), with the tokens under the margin rule of
tests/test_torch_serve.py. The tests marked gpu capture and replay real
graphs on the card: replay bit-equal to eager, launch counters moved by
exactly the capture's change, no allocation on a second pass over captured
shapes, and a capture that fails raises.
"""

import gc
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models.model import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models.model import Model
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graphs
from repro_torch.serve.engine import Request, ServeEngine

LENGTHS = (3, 4, 5, 7, 9, 12, 17, 25, 31, 33, 48)      # 11 distinct


def _bridged(arch, **model_kw):
    """The JAX model and params of reduced(arch), and the port's model on
    the CPU with the same parameters."""
    cfg = reduced(get_arch(arch))
    jm = JaxModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(t_reduced(t_get_arch(arch)), device="cpu", **model_kw)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def granite():
    return _bridged("granite-8b")


@pytest.fixture(scope="module")
def mamba2():
    return _bridged("mamba2-370m")


def _serve(engine, prompts, max_new, cls=Request):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=500)
    assert all(r.done for r in reqs), [r.state for r in reqs]
    return [list(r.out) for r in reqs]


def _assert_tokens_near(jm, jp, prompts, got, ref):
    """Equal tokens, or a first difference where the reference's top-1
    minus top-2 logit is below TOLERANCES["token_margin"] (a near tie that
    rounding in another framework may flip)."""
    tol = TOLERANCES["token_margin"]
    for p, a, b in zip(prompts, got, ref):
        assert len(a) == len(b)
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = np.concatenate([p, np.asarray(b[:j])]).astype(np.int32)
            logits, _ = jm.forward(jp, {"tokens": jnp.asarray(seq)[None]})
            last = np.asarray(logits[0, -1], np.float32)
            top2 = np.sort(last)[-2:]
            assert top2[1] - top2[0] <= tol.atol * np.abs(last).max(), \
                (p, a, b)


def _compile_gate(models, lengths, max_new, **kw):
    """Serve one prompt per length through the JAX engine and the port's;
    returns both engines after holding the tokens to each other."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab, n, dtype=np.int32)
               for n in lengths]
    jeng = JaxServeEngine(jm, jp, slots=2, max_len=64, **kw)
    teng = ServeEngine(tm, tp, slots=2, max_len=64, **kw)
    ref = _serve(jeng, prompts, max_new, cls=JaxRequest)
    got = _serve(teng, prompts, max_new)
    _assert_tokens_near(jm, jp, prompts, got, ref)
    return jeng, teng


# --------------------------------------------------------------------------
# compile-count gates (tests/test_serving.py), as runner counts
# --------------------------------------------------------------------------

def test_prefill_compile_count_bounded(granite):
    jeng, teng = _compile_gate(granite, LENGTHS, max_new=2)
    # one runner per pow2 bucket, never one per prompt length, and as
    # many as the JAX engine's jit cache holds on the same prompts
    assert teng.prefill_compiles == jeng.prefill_compiles
    assert teng.prefill_compiles <= teng.max_prefill_compiles == \
        int(math.log2(64))
    assert teng.prefill_compiles < len(set(LENGTHS))
    assert teng.prefill_compiles == len(teng._buckets_seen)
    assert teng._buckets_seen == jeng._buckets_seen


def test_decode_chunk_compile_count_bounded(granite):
    jeng, teng = _compile_gate(granite, [4 + i for i in range(6)],
                               max_new=11, decode_chunk=8)
    # pow2-floored chunks: at most log2(decode_chunk) + 1 runners, the
    # same chunk lengths the JAX engine compiled
    assert teng.decode_compiles <= int(math.log2(8)) + 1
    assert teng.decode_compiles == jeng._decode_fn._cache_size()
    assert set(teng._decode_runners) <= {1, 2, 4, 8}


@pytest.mark.parametrize("arch", ["mamba2-370m"])
def test_stateful_prefill_compile_count_bounded(mamba2, arch):
    """The SSM family rides the bucketed path (masked state updates): one
    runner per bucket, as the JAX engine's jit cache."""
    jeng, teng = _compile_gate(mamba2, LENGTHS, max_new=2)
    assert teng.bucketed and jeng.bucketed
    assert teng.prefill_compiles == jeng.prefill_compiles
    assert teng.prefill_compiles <= int(math.log2(64))
    assert teng.prefill_compiles < len(set(LENGTHS))
    assert teng.prefill_compiles == len(teng._buckets_seen)


def test_exact_length_prefill_counts_distinct_lengths():
    """dbrx prefills exact-length (padding would take expert capacity):
    one shape per prompt length, counted as the JAX engine counts it, and
    no prefill runner; decode still runs through the chunk runners."""
    models = _bridged("dbrx-132b")
    jeng, teng = _compile_gate(models, (3, 5, 5, 9), max_new=3)
    assert not teng.bucketed and not jeng.bucketed
    assert teng.prefill_compiles == jeng.prefill_compiles == 3
    assert teng._buckets_seen == jeng._buckets_seen == {3, 5, 9}
    assert not teng._prefill_runners and teng.decode_compiles >= 1


# --------------------------------------------------------------------------
# the static buffers: slot routing and the lane cache's reset
# --------------------------------------------------------------------------

def test_copy_lanes_routes_real_lanes_and_drops_pad_lanes():
    """Lane g goes to slot slot_ids[g]; a pad lane (-1) writes nothing
    that survives, and the other slots keep what they held."""
    L, B = 2, 4
    src = engine_mod.KVCache.zeros(B, 3, 1, 2, torch.float32, layers=L)
    dst = engine_mod.KVCache.zeros(B, 3, 1, 2, torch.float32, layers=L)
    for t in (src.k, src.v, dst.k, dst.v):
        t.copy_(torch.randn(t.shape))
    src.length.copy_(torch.arange(L * B).reshape(L, B) + 10)
    before = [t.clone() for t in (dst.k, dst.v, dst.length)]
    engine_mod._copy_lanes(dst, src, torch.tensor([2, 0, -1, -1]))
    for got, old, new in zip((dst.k, dst.v, dst.length), before,
                             (src.k, src.v, src.length)):
        assert torch.equal(got[:, 2], new[:, 0])
        assert torch.equal(got[:, 0], new[:, 1])
        assert torch.equal(got[:, [1, 3]], old[:, [1, 3]])


def _poison(lane_cache: dict) -> None:
    for node in lane_cache.values():
        for c in node.values():
            for t in engine_mod._lane_tensors(c):
                t.fill_(float("nan") if t.is_floating_point() else 7)


@pytest.mark.parametrize("arch,paged", [("granite-8b", False),
                                        ("granite-8b", True),
                                        ("mamba2-370m", False)],
                         ids=["granite-dense", "granite-paged", "mamba2"])
def test_bucket_runner_resets_its_static_lane_cache(granite, mamba2, arch,
                                                    paged):
    """Two prefill groups through one bucket's runner, the second with
    shorter prompts, and the bucket's static lane cache poisoned (NaN, and
    lengths 7) in between: the runner must reset it, or the first group's
    KV past the second's lengths, its conv window and SSM state, or the
    poison, leak in. Both groups give the tokens of a fresh engine, as
    does the JAX engine (margin rule)."""
    jm, jp, tm, tp = granite if arch == "granite-8b" else mamba2
    kw = dict(slots=2, max_len=64, decode_chunk=4)
    if paged:
        kw.update(paged=True, page_size=8)
    rng = np.random.default_rng(3)
    groups = [[rng.integers(0, jm.cfg.vocab, n, dtype=np.int32)
               for n in lens] for lens in ((15, 13), (9, 10))]
    eng = ServeEngine(tm, tp, **kw)
    out = [_serve(eng, groups[0], 4)]
    assert list(eng._lane_caches) == [16]
    _poison(eng._lane_caches[16])
    out.append(_serve(eng, groups[1], 4))
    assert eng.prefill_compiles == 1 and list(eng._lane_caches) == [16]
    for prompts, got in zip(groups, out):
        assert got == _serve(ServeEngine(tm, tp, **kw), prompts, 4)
        ref = _serve(JaxServeEngine(jm, jp, **kw), prompts, 4,
                     cls=JaxRequest)
        _assert_tokens_near(jm, jp, prompts, got, ref)


def test_engine_is_freed_without_the_cycle_collector(granite):
    """The runners' bodies hold the model, weights and caches, never the
    engine: dropping the last reference to an engine frees it (and its
    graphs and pool, on the card) at once, not at some later collection."""
    _, _, tm, tp = granite
    eng = ServeEngine(tm, tp, slots=2, max_len=64, paged=True, page_size=8)
    _serve(eng, [np.arange(5), np.arange(20)], 3)
    assert eng._prefill_runners and eng._decode_runners
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_cpu_engine_captures_nothing(granite):
    _, _, tm, tp = granite
    eng = ServeEngine(tm, tp, slots=2, max_len=64)
    _serve(eng, [np.arange(5), np.arange(9)], 3)
    st = eng.stats
    assert eng._graphs is None and eng.graph_pool_bytes() == 0
    assert (st["graphs"], st["capture_s"], st["capture_prefills"],
            st["capture_steps"]) == (0, 0.0, 0, 0)
    assert all(r.graph is None for r in eng._decode_runners.values())


# --------------------------------------------------------------------------
# on the card: real graphs
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


CARD_MODELS = {
    "granite": dict(arch="granite-8b", model=dict(use_pallas=True)),
    "granite-paged": dict(arch="granite-8b",
                          model=dict(attention_impl="pallas",
                                     use_pallas=True),
                          engine=dict(paged=True, page_size=16)),
    "mamba2": dict(arch="mamba2-370m",
                   model=dict(ssd_impl="pallas", use_pallas=True)),
}


def _card_setup(name):
    spec = CARD_MODELS[name]
    model = Model(t_reduced(t_get_arch(spec["arch"])), **spec["model"])
    params = model.init(torch.Generator("cuda").manual_seed(0))
    kw = dict(slots=4, max_len=128, decode_chunk=8, **spec.get("engine", {}))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in
               (5, 60, 17, 9, 33, 100, 3)]
    return model, params, kw, prompts


def _recorded_run(monkeypatch, engine, prompts):
    """Serve prompts; returns (tokens, every host read, launch counts)."""
    reads = []

    def to_host(t):
        out = real(t)
        reads.append(out.copy())
        return out
    real = engine_mod.to_host
    monkeypatch.setattr(engine_mod, "to_host", to_host)
    before = graphs.launch_counts()
    tokens = _serve(engine, prompts, 12)
    torch.cuda.synchronize()
    counts = graphs._counts_since(before)
    monkeypatch.setattr(engine_mod, "to_host", real)
    return tokens, reads, counts


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_MODELS))
def test_replay_is_bit_equal_to_eager(cuda_device, monkeypatch, name):
    """The same requests through an eager engine and a graphed one: equal
    tokens, every host read (first tokens, packed decode chunks) equal bit
    for bit, equal launch counts by kernel and mainloop; graphs within the
    bounds, and every call but the first of each shape a replay."""
    model, params, kw, prompts = _card_setup(name)
    eager = _recorded_run(monkeypatch, ServeEngine(model, params, eager=True,
                                                   **kw), prompts)
    eng = ServeEngine(model, params, **kw)
    graphed = _recorded_run(monkeypatch, eng, prompts)
    assert graphed[0] == eager[0]
    assert len(graphed[1]) == len(eager[1])
    assert all(np.array_equal(a, b) for a, b in zip(graphed[1], eager[1]))
    assert graphed[2] == eager[2] and sum(n for n, _ in graphed[2]) > 0
    st = eng.stats
    assert st["graphs"] == eng.prefill_compiles + eng.decode_compiles
    assert eng.prefill_compiles <= eng.max_prefill_compiles
    assert eng.decode_compiles <= int(math.log2(8)) + 1
    assert st["capture_prefills"] == eng.prefill_compiles
    assert st["chunks"] > eng.decode_compiles      # some chunks replayed
    assert st["capture_s"] > 0 and eng.graph_pool_bytes() > 0


@pytest.mark.gpu
def test_replay_moves_counters_by_the_captures_change(cuda_device):
    """A runner's replay adds exactly the launches its capture recorded
    (and the capture itself adds none): the served launch gates keep their
    meaning under graphs."""
    model, params, kw, prompts = _card_setup("granite")
    eng = ServeEngine(model, params, **kw)
    _serve(eng, prompts[:2], 3)
    runner = next(iter(eng._decode_runners.values()))
    delta = runner._delta
    assert delta[0][0] > 0                  # the pod GEMM ran in the body
    before = graphs.launch_counts()
    for _ in range(3):
        runner()
    torch.cuda.synchronize()
    assert graphs._counts_since(before) == [
        (3 * n, {k: 3 * v for k, v in m.items()}) for n, m in delta]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_MODELS))
def test_second_pass_over_captured_shapes_allocates_nothing(cuda_device,
                                                            name):
    model, params, kw, prompts = _card_setup(name)
    eng = ServeEngine(model, params, **kw)
    first = _serve(eng, prompts, 12)
    graphs_after_first = eng.stats["graphs"]
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert _serve(eng, prompts, 12) == first
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs
    assert eng.stats["graphs"] == graphs_after_first


@pytest.mark.gpu
def test_runner_keeps_the_workspace_it_captured_alive(cuda_device):
    """A pool made for the device an engine names ("cuda", no index)
    holds the split-K workspace and counters a graph writes, so a larger
    shape that grows the workspace afterwards frees neither, and the
    replay still equals an eager call. (The workspaces are keyed by a
    tensor's device, "cuda:0".)"""
    from repro_torch.kernels.systolic_gemm import systolic_gemm as sg
    g = torch.Generator("cuda").manual_seed(0)
    w = torch.randn((4096, 4096), generator=g, device="cuda").to(
        torch.bfloat16)
    x = torch.randn((64, 4096), generator=g, device="cuda").to(
        torch.bfloat16)
    assert sg.nn_plan(4, 4096, 4096, torch.bfloat16, True).splits > 1
    sg._SPLITK_SCRATCH.clear()
    runner = graphs.StepRunner(lambda x: sg.systolic_gemm_cuda(x, w),
                               {"x": x[:4].clone()},
                               graphs.GraphPool(torch.device("cuda")))
    runner()                                    # warm-up and capture
    held = runner._held
    assert held and all(a is b for a, b in
                        zip(held, sg.workspaces(x.device)))
    sg.systolic_gemm_cuda(x, w)                 # M = 64 grows the workspace
    assert sg.workspaces(x.device)[0] is not held[0]
    torch.cuda.empty_cache()
    got = runner().clone()
    torch.cuda.synchronize()
    assert torch.equal(got, sg.systolic_gemm_cuda(x[:4].contiguous(), w))


@pytest.mark.gpu
def test_capture_of_a_host_read_raises(cuda_device):
    """A body that reads the device from the host cannot be captured: the
    runner raises and keeps no graph; it never runs eager instead. (Last
    in this file: a failed capture may leave the stream unusable.)"""
    x = torch.arange(4.0, device=cuda_device)
    runner = graphs.StepRunner(lambda x: x * x.sum().item(), {"x": x},
                               graphs.GraphPool(cuda_device))
    with pytest.raises(RuntimeError):
        runner()
    assert runner.graph is None
