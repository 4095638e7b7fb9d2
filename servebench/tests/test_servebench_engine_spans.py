"""The readers of the engine's detail spans (engine_spans.py) on synthetic
spans and a synthetic Chrome trace, and all three on a small cell's
traced run on the CPU."""

from __future__ import annotations

import json

import pytest

from servebench import engine_spans as es
from servebench import load as ld
from servebench import readers, trace

from ._cells import small_cell, use_virtual_clock


def _ctx(spans, dev=None, host=None, trace_window=(10.0, 15.0)):
    lo = ld.Load(served=[], steps=[], t_load=0.0, t_open=10.0,
                 t_close=20.0, trace_window=trace_window)
    return readers.Context({}, {}, lo, spans, {}, dev, host)


def test_queue_wait_is_the_mean_of_waits_ending_in_the_window():
    spans = [ld.Span("serve.queue", 11.5, 12.0, {"rid": 0}),   # 0.5 s
             ld.Span("serve.queue", 8.4, 19.9, {"rid": 1}),    # 11.5 s
             ld.Span("serve.queue", 9.0, 10.0, {"rid": 2}),    # at the open
             ld.Span("serve.queue", 24.0, 25.0, {"rid": 3}),   # after
             ld.Span("prefill/bucket8", 12.0, 12.5, {"rids": [0]})]
    assert es.queue_wait_ms(_ctx(spans)) == pytest.approx(6000.0)
    assert es.queue_wait_ms(_ctx(spans[2:])) is None


def test_decode_attention_per_step_over_the_window():
    spans = [ld.Span("decode/chunk8", 11.0, 11.4,
                     {"steps": 8, "attention_ms": 80.0}),
             ld.Span("decode/chunk4", 12.0, 12.2,
                     {"steps": 4, "attention_ms": 44.0}),
             ld.Span("decode/chunk8", 19.9, 20.3,              # past close
                     {"steps": 8, "attention_ms": 1e3}),
             ld.Span("serve.read", 11.3, 11.4, {"parent": "decode/chunk8"})]
    assert es.decode_attention_ms(_ctx(spans)) == pytest.approx(124 / 12)
    # a program whose engine gives no detail: nothing to read
    bare = [ld.Span("decode/chunk8", 11.0, 11.4, {"steps": 8})]
    assert es.decode_attention_ms(_ctx(bare)) is None


def test_engine_idle_counts_only_gaps_under_engine_ranges(tmp_path):
    """Device ops 0-30 and 20-40 overlap (busy once); idle 40-50 lies under
    serve.launch inside decode/chunk8, 50-60 under serve.read, 60-70 only
    under the harness's step annotation, 80-100 under no host event."""
    ev = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 30, "name": "k1"},
          {"ph": "X", "cat": "kernel", "ts": 20, "dur": 20, "name": "k2"},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 70, "dur": 10,
           "name": "Memcpy DtoH"},
          {"ph": "X", "cat": "kernel", "ts": 100, "dur": 5, "name": "k3"},
          {"ph": "X", "cat": "user_annotation", "ts": 0, "dur": 70,
           "name": "servebench.step"},
          {"ph": "X", "cat": "user_annotation", "ts": 0, "dur": 60,
           "name": "decode/chunk8"},
          {"ph": "X", "cat": "user_annotation", "ts": 35, "dur": 15,
           "name": "serve.launch"},
          {"ph": "X", "cat": "user_annotation", "ts": 50, "dur": 10,
           "name": "serve.read"},
          {"ph": "X", "cat": "cuda_runtime", "ts": 41, "dur": 2,
           "name": "cudaGraphLaunch"}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    dev, host = trace.read(p)
    assert es.engine_idle_us(dev, host) == [(40.0, 60.0)]
    ctx = _ctx([], dev, host, trace_window=(0.0, 1e-4))      # 100 us
    assert es.engine_idle_share(ctx) == pytest.approx(20.0)
    assert es.idle_by_range(dev, host) == pytest.approx(
        {"serve.launch in decode/chunk8": 10e-6,
         "serve.read in decode/chunk8": 10e-6})
    # no engine range: nothing to read
    assert es.engine_idle_share(_ctx([], dev, [h for h in host if
                                               h.name == "servebench.step"],
                                     trace_window=(0.0, 1e-4))) is None


def test_trace_run_reads_all_three(monkeypatch):
    """A small cell traced with DetailRecorder on the CPU: queue waits and
    decode attention read from the engine's spans, the engine's ranges
    found in the profiler's trace. The CPU trace holds no device op, so
    engine_idle_share reads the ranges against one planted kernel."""
    use_virtual_clock(monkeypatch.setattr)
    import time
    cell = small_cell("granite-8b", ("decode_step_ms.decode",))
    out, ctx = es.traced_run(cell, seed=2**31 + 5, seconds=1.0,
                             device="cpu", t_start=time.perf_counter())
    assert out["per_layer"]["decode_step_ms.decode"] > 0
    assert es.queue_wait_ms(ctx) > 0
    dec = es.decode_attention_ms(ctx)
    assert 0 < dec < out["per_layer"]["decode_step_ms.decode"]
    ranges = es.engine_ranges(ctx.host)
    names = {o.name.split("/")[0] for o in ranges}
    assert {"serve.step", "serve.admit", "serve.launch", "serve.read",
            "decode"} <= names
    assert ctx.dev == [] and es.engine_idle_share(ctx) is None
    first = min(o.ts for o in ranges)
    ctx.dev = [trace.Op("k", first, 1.0, "kernel")]
    assert 0 < es.engine_idle_share(ctx)
    acc = es.account(ctx)
    assert acc["captures"] == []                 # the CPU captures nothing
    assert acc["ttft_ms"]["queue"]["n"] > 0
    assert acc["engine_idle_s"]


def test_unprofiled_run_keeps_the_spans(monkeypatch):
    """--profile 0: the detail spans and the end-to-end metrics, no
    trace."""
    use_virtual_clock(monkeypatch.setattr)
    import time
    cell = small_cell("granite-8b", ("decode_step_ms.decode",))
    out, ctx = es.traced_run(cell, seed=7, seconds=1.0, device="cpu",
                             t_start=time.perf_counter(), profile=False)
    assert ctx.host is None and ctx.traced is None and "busy_s" not in out
    assert out["end_to_end"]["ttft_p95_ms"] > 0
    assert es.queue_wait_ms(ctx) > 0 and es.decode_attention_ms(ctx) > 0
    assert es.engine_idle_share(ctx) is None
    assert "engine_idle_s" not in es.account(ctx)
