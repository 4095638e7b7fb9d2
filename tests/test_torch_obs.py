"""The port's copies of the framework-free modules the serving controls
need (repro_torch/{core,tenancy,obs,train}, serve/{admission,chaos}.py)
against the reference modules on the same inputs, and the port's serve
launcher (repro_torch/launch/serve.py) on the CPU.

A copy is the reference file with one header line: that is checked text
for text. Then the behaviour on the same inputs: the wave-model latency
prediction on granite-8b's full config at three design points (one with
faulty pods), the GEMM lowering of a request and of a recorded timeline,
metrics percentiles and snapshots, the Chrome-trace export, and the drift
rows and effective-TOPS summary of one recorded reduced run of the port's
engine.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.obs import drift as jdrift
from repro.obs import export as jexport
from repro.obs.metrics import MetricsRegistry as JaxMetrics
from repro.obs.metrics import percentile as jpercentile
from repro.serve.admission import WaveLatencyPredictor as JaxPredictor
from repro.tenancy import planner as jplanner
from repro.tenancy import trace as jtrace
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model
from repro_torch.obs import drift as tdrift
from repro_torch.obs import export as texport
from repro_torch.obs.metrics import MetricsRegistry, percentile
from repro_torch.serve.admission import WaveLatencyPredictor
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tenancy import planner as tplanner
from repro_torch.tenancy import trace as ttrace

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["core/__init__.py", "core/arrays.py", "core/interconnect.py",
          "core/tiling.py", "core/scheduler.py", "core/simulator.py",
          "core/dse.py", "core/workloads.py", "tenancy/mix.py",
          "tenancy/planner.py", "tenancy/trace.py", "obs/__init__.py",
          "obs/metrics.py", "obs/export.py", "obs/drift.py",
          "train/fault.py", "serve/chaos.py", "serve/admission.py"]
DESIGNS = [((32, 32, "butterfly-2", 64), 0), ((16, 16, "benes", 128), 0),
           ((32, 32, "butterfly-2", 64), 16)]


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_reference_text(path):
    port = (ROOT / "src/repro_torch" / path).read_text().splitlines()
    ref = (ROOT / "src/repro" / path).read_text().splitlines()
    assert port[0] == f"# Copy of src/repro/{path} (the port imports " \
                      "nothing of repro)."
    assert port[1:] == ref


def _gemm_rows(gemms):
    return [dataclasses.astuple(g) for g in gemms]


@pytest.mark.parametrize("design,faulty", DESIGNS)
def test_wave_model_prediction_equals_the_reference(design, faulty):
    """granite-8b at its full config: predict_latency_s over
    request_gemms, and the predictor's cached model_seconds."""
    jcfg, tcfg = get_arch("granite-8b"), t_get_arch("granite-8b")
    jp = JaxPredictor(jcfg, design, faulty_pods=faulty)
    tp = WaveLatencyPredictor(tcfg, design, faulty_pods=faulty)
    for prompt, new in ((200, 16), (9, 6), (1500, 16)):
        jg = jtrace.request_gemms(jcfg, prompt, new)
        tg = ttrace.request_gemms(tcfg, prompt, new)
        assert _gemm_rows(tg) == _gemm_rows(jg)
        want = jplanner.predict_latency_s(jg, design, faulty_pods=faulty)
        assert tplanner.predict_latency_s(tg, design,
                                          faulty_pods=faulty) == want
        assert tp.model_seconds(prompt, new) == jp.model_seconds(prompt, new)
    assert list(tp._cache) == list(jp._cache)


@pytest.fixture(scope="module")
def recorded():
    """One recorded reduced run of the port's engine: its recorder and
    metrics, and the config both sides lower it with."""
    tcfg = t_reduced(t_get_arch("granite-8b"))
    model = Model(tcfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    metrics, tracer = MetricsRegistry(), ttrace.ServeTraceRecorder()
    eng = ServeEngine(model, params, slots=2, max_len=32, metrics=metrics,
                      tracer=tracer)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab, n),
                    max_new_tokens=4) for i, n in enumerate((5, 9, 17))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=200)
    assert all(r.state == "done" for r in reqs)
    return tracer, metrics, tcfg


def _jax_recorder(tracer):
    rec = jtrace.ServeTraceRecorder()
    rec.events = list(tracer.events)
    rec.spans = [jexport.Span(s.name, s.ts, s.dur, s.cat, dict(s.args))
                 for s in tracer.spans]
    return rec


def test_trace_lowering_equals_the_reference(recorded):
    tracer, _, tcfg = recorded
    jcfg, jrec = reduced(get_arch("granite-8b")), _jax_recorder(tracer)
    assert tracer.num_prefills == 3 and tracer.num_decode_steps > 0
    for kw in ({}, {"kinds": ("decode",)}, {"include_lm_head": True},
               {"kinds": ("prefill",), "max_events": 2,
                "include_attention": False}):
        assert _gemm_rows(ttrace.trace_to_gemms(tracer, tcfg, **kw)) == \
            _gemm_rows(jtrace.trace_to_gemms(jrec, jcfg, **kw))


def test_drift_and_effective_tops_equal_the_reference(recorded):
    tracer, metrics, tcfg = recorded
    jcfg, jrec = reduced(get_arch("granite-8b")), _jax_recorder(tracer)
    tsink, jsink = MetricsRegistry(), JaxMetrics()
    got = tdrift.drift_report(tracer, tcfg, metrics=tsink)
    want = jdrift.drift_report(jrec, jcfg, metrics=jsink)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert [r.phase for r in got] == ["prefill", "decode"]
    assert tsink.dumps() == jsink.dumps()
    # the engine's metrics, copied into a reference registry series by
    # series; no kernel gauges on either side, so tile_util is 1
    jmetrics = JaxMetrics()
    for (kind, name, labels), m in metrics._series.items():
        if kind != "histogram":
            getattr(jmetrics, kind)(name, **dict(labels)).value = m.value
    got = tdrift.effective_tops_summary(tracer, tcfg, metrics,
                                        kernel_metrics=MetricsRegistry())
    want = jdrift.effective_tops_summary(jrec, jcfg, jmetrics,
                                         kernel_metrics=JaxMetrics())
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert {r.phase for r in got} == {"prefill", "decode"}
    assert all(r.tile_utilization == 1.0 and r.effective_tops > 0
               for r in got)


def test_metrics_and_chrome_trace_equal_the_reference():
    rng = np.random.default_rng(3)
    xs = list(rng.normal(100.0, 30.0, 20_000))
    for q in (0, 10, 50, 90, 99, 100):
        assert percentile(xs, q) == jpercentile(xs, q)
    regs = (MetricsRegistry(), JaxMetrics())
    for reg in regs:
        reg.counter("serve.prefill.calls", path="bucketed").inc(3)
        reg.gauge("serve.queue_depth").set(2)
        h = reg.histogram("serve.decode.token_wait_us")
        for i, x in enumerate(xs):       # past max_samples: decimation
            h.record(x, n=1 + i % 3)
    assert regs[0].dumps(indent=1) == regs[1].dumps(indent=1)
    assert regs[0].snapshot() == regs[1].snapshot()
    spans = [("prefill/bucket8", 0.5, 0.25, "prefill", {"lanes": 2}),
             ("decode/chunk4", 0.75, 0.125, "decode", {"tokens": 8})]
    got = texport.to_chrome_trace([texport.Span(*s) for s in spans])
    assert got == jexport.to_chrome_trace([jexport.Span(*s)
                                           for s in spans])
    assert texport.to_chrome_trace([]) == jexport.to_chrome_trace([])


def test_serve_launcher_on_the_cpu(tmp_path):
    """The launcher with --device cpu: every request reported, the
    admission line, the metrics snapshot, and a trace with one span per
    device call (the decode chunks the snapshot counts plus the prefill
    calls)."""
    trace = tmp_path / "trace.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-8b", "--reduced", "--device", "cpu", "--requests", "4",
         "--metrics", "--trace-out", str(trace), "--policy", "edf",
         "--deadline", "5", "--chaos-seed", "1"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == \
        [f"req {i}" for i in range(4)]
    assert "ms/tok on CPU)" in lines[4]
    assert lines[5].startswith("admission[edf]: ")
    assert lines[6] == "metrics snapshot:"
    end = lines.index("}", 7)
    snap = json.loads("\n".join(lines[7:end + 1]))
    doc = json.loads(trace.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    calls = snap["counters"]["serve.decode.chunks"] + sum(
        v for k, v in snap["counters"].items()
        if k.startswith("serve.prefill.calls"))
    assert len(spans) == calls
    assert lines[end + 1] == f"wrote {len(spans)} spans to {trace} " \
                             "(open in ui.perfetto.dev)"


def test_serve_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "granite-8b", "--reduced"])
