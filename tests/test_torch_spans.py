"""The serve engine's detail spans and decode attention's timed regions
(serve/engine.py's docstring, obs/spans.py) on the CPU.

A tracer that asks for detail gets profiler ranges, the serve.* child
spans with their parents, one serve.queue span per admitted request and
decode spans that carry attention_ms and attention_regions; its tokens and
host syncs are the untraced engine's. With tracer=None, or a tracer that
does not ask (ServeTraceRecorder), no range is opened, no region entered
and no runner keeps a region, and the spans and metrics are those the
engine gives without detail. This file imports no JAX: the spans' parity
with the JAX engine is tests/test_torch_admission.py.
"""

import numpy as np
import pytest
import torch

import repro_torch.serve.engine as engine_mod
from repro_torch import HOST_SYNCS
from repro_torch.configs import get_arch, reduced
from repro_torch.models.model import Model
from repro_torch.obs import spans
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.chaos import ChaosConfig, VirtualClock
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.graphs import StepRunner
from repro_torch.tenancy.trace import ServeTraceRecorder

ENGINES = {"bucketed": {},
           "exact": {"prefill_buckets": False},
           "paged": {"paged": True, "page_size": 8}}
ORIGINAL_ARGS = {"prefill": {"bucket", "lanes", "tokens", "rids"},
                 "decode": {"steps", "lanes", "tokens", "live_end"}}


class DetailRecorder(ServeTraceRecorder):
    """A ServeTraceRecorder that asks the engine for detail."""
    detail = True


class TickingClock(VirtualClock):
    """A VirtualClock that moves 1 ms at each read, so that a span opened
    inside another ends strictly inside it and a region takes time."""

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


@pytest.fixture(scope="module")
def model():
    m = Model(reduced(get_arch("granite-8b")), use_pallas=True,
              device="cpu")
    return m, m.init(torch.Generator("cpu").manual_seed(0))


def _serve(model, tracer=None, clock=None, metrics=None, **kw):
    """Seven requests, two of them queued behind the four slots; returns
    the engine, the requests and the host syncs made."""
    m, p = model
    eng = ServeEngine(m, p, slots=4, max_len=64, decode_chunk=4,
                      tracer=tracer, clock=clock, metrics=metrics,
                      **{**dict(ENGINES["bucketed"]), **kw})
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, m.cfg.vocab, n),
                    max_new_tokens=k)
            for i, (n, k) in enumerate([(5, 9), (12, 6), (3, 11), (20, 5),
                                        (7, 8), (9, 3), (16, 7)])]
    before = HOST_SYNCS.count
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=200)
    assert all(r.state == "done" for r in reqs)
    return eng, reqs, HOST_SYNCS.count - before


def _counting(monkeypatch):
    """Count the profiler ranges the engine opens and the regions entered."""
    seen = {"ranges": 0, "regions": 0}
    rf, region = engine_mod.record_function, spans.RegionRecorder.region

    def counted_rf(*a, **k):
        seen["ranges"] += 1
        return rf(*a, **k)

    def counted_region(self, name):
        seen["regions"] += 1
        return region(self, name)
    monkeypatch.setattr(engine_mod, "record_function", counted_rf)
    monkeypatch.setattr(spans.RegionRecorder, "region", counted_region)
    return seen


def _encloses(outer, inner) -> bool:
    return outer.ts <= inner.ts and \
        inner.ts + inner.dur <= outer.ts + outer.dur


@pytest.mark.parametrize("kind", list(ENGINES))
def test_detail_spans_nest_and_time_decode_attention(model, kind,
                                                     monkeypatch):
    seen = _counting(monkeypatch)
    rec = DetailRecorder()
    eng, reqs, syncs = _serve(model, rec, TickingClock(), **ENGINES[kind])
    bare, bare_reqs, bare_syncs = _serve(model, **ENGINES[kind])
    assert [r.out for r in reqs] == [r.out for r in bare_reqs]
    assert syncs == bare_syncs
    got = rec.spans
    engine_spans = [s for s in got if s.name != "serve.queue"]
    assert seen["ranges"] == len(engine_spans) > 0
    assert seen["regions"] > 0
    names = {s.name.split("/")[0] for s in got}
    assert {"serve.step", "serve.admit", "serve.copy_in", "serve.launch",
            "serve.read", "serve.retire", "serve.queue", "prefill",
            "decode"} <= names
    for s in got:
        if not s.name.startswith("serve.") or s.name == "serve.queue":
            continue
        if s.name == "serve.step":
            assert s.args["parent"] is None
            continue
        assert any(p.name == s.args["parent"] and _encloses(p, s)
                   for p in got), s
    # one queue wait per request: submit to the start of its prefill
    queue = {s.args["rid"]: s for s in got if s.name == "serve.queue"}
    assert sorted(queue) == [r.rid for r in reqs]
    for r in reqs:
        q = queue[r.rid]
        pre = [s for s in got if s.name.startswith("prefill/")
               and r.rid in s.args["rids"]]
        assert len(pre) == 1 and q.args["parent"] == pre[0].name
        assert q.ts == pytest.approx(r._submit_t - eng._t0)
        assert q.ts + q.dur == pytest.approx(pre[0].ts)
    admits = [s for s in got if s.name == "serve.admit"]
    assert sum(s.args["admitted"] for s in admits) == len(reqs)
    runners = {s.args["runner"] for s in got if s.name == "serve.launch"}
    assert any(k.startswith("decode_chunk") for k in runners)
    assert any(k.startswith("prefill_") for k in runners)
    decode = [s for s in got if s.name.startswith("decode/")]
    layers = model[0].cfg.n_layers
    for s in decode:
        assert 0 < s.args["attention_ms"] <= 1e3 * s.dur
        assert s.args["attention_regions"] == layers * s.args["steps"]


@pytest.mark.parametrize("tracer", [None, ServeTraceRecorder])
def test_without_detail_no_range_and_no_region(model, tracer, monkeypatch):
    """The engine's spans and metrics without detail, and with a tracer
    that asks for it the same spans (less the detail) and metrics."""
    seen = _counting(monkeypatch)
    rec = tracer() if tracer is not None else None
    metrics = MetricsRegistry()
    eng, reqs, syncs = _serve(model, rec, VirtualClock(), metrics)
    assert seen == {"ranges": 0, "regions": 0}
    assert eng._regions is None
    runners = list(eng._prefill_runners.values()) + \
        list(eng._decode_runners.values())
    assert runners and all(not r.regions for r in runners)
    detail, detail_metrics = DetailRecorder(), MetricsRegistry()
    _, detail_reqs, detail_syncs = _serve(model, detail, VirtualClock(),
                                          detail_metrics)
    assert [r.out for r in reqs] == [r.out for r in detail_reqs]
    assert syncs == detail_syncs
    assert metrics.dumps() == detail_metrics.dumps()
    if rec is None:
        return
    assert len(rec.spans) == syncs            # one span per device call
    for s in rec.spans:
        assert set(s.args) == ORIGINAL_ARGS[s.cat], s
    kept = [(s.name, s.ts, s.dur, s.cat,
             {k: v for k, v in s.args.items() if k in ORIGINAL_ARGS[s.cat]})
            for s in detail.spans if s.cat in ORIGINAL_ARGS]
    assert kept == [(s.name, s.ts, s.dur, s.cat, s.args) for s in rec.spans]


def test_detail_under_chaos_retries(model):
    """Transient faults retried under detail: the chaos-free tokens, one
    decode span per chunk with its regions, every span's parent open."""
    chaos = ChaosConfig(seed=4, p_fault=0.3)
    rec = DetailRecorder()
    eng, reqs, _ = _serve(model, rec, TickingClock(), chaos=chaos)
    _, bare, _ = _serve(model)
    assert eng._chaos.injected["faults"] > 0
    assert [r.out for r in reqs] == [r.out for r in bare]
    decode = [s for s in rec.spans if s.name.startswith("decode/")]
    assert len(decode) == eng.stats["chunks"]
    assert all(s.args["attention_regions"] ==
               model[0].cfg.n_layers * s.args["steps"] for s in decode)
    assert eng._open == []


def test_region_records_only_under_a_current_recorder():
    clock = TickingClock()
    assert spans.region("decode_attention") is spans._NOTHING
    spans.replayed([("graph", 0.0, 1.0)])          # no recorder: dropped
    rec = spans.RegionRecorder("cpu", clock)
    with rec.recording():
        assert spans.current() is rec
        with spans.region("decode_attention"):
            pass
        spans.replayed([("decode_attention", 1.0, 1.004)])
    assert spans.current() is None
    pairs = rec.take()
    assert [p[0] for p in pairs] == ["decode_attention"] * 2
    assert pairs[0][2] - pairs[0][1] == pytest.approx(1e-3)
    assert spans.elapsed_ms(pairs) == pytest.approx(5.0)
    assert rec.take() == []


def test_runner_load_then_launch_is_one_call():
    """A runner's load and launch, apart, do what one call does (the
    detail path times them as serve.copy_in and serve.launch)."""
    buf = torch.zeros(3)
    runner = StepRunner(lambda x: x * 2, {"x": buf}, name="decode_chunk2")
    assert runner.name == "decode_chunk2" and not runner.captures
    whole = runner(x=np.arange(3.0)).clone()
    runner.load(x=np.arange(3.0))
    assert torch.equal(buf, torch.arange(3.0))
    assert torch.equal(runner.launch(), whole)
    assert torch.equal(whole, torch.tensor([0.0, 2.0, 4.0]))
