"""Decode attention timed inside the CUDA graph, on the card (tests marked
gpu; they skip without one).

granite-8b at full width and two layers serves one request set through
three engines: graphed with a tracer that asks for detail, eager with the
same tracer, graphed without a tracer. The graphed engine's attention_ms
over the set's second pass (every call a replay) is within 10% of the
eager engine's; the traced engine makes the untraced one's host syncs and
tokens; only the traced graphs hold regions. An eager region's events
also time the card's waits for the host to enqueue the region's
operations wherever the host falls behind, so the set keeps the card
behind: 64 lanes over a 4096-slot cache (at the reasoning cell's 16
lanes the eager engine is host-bound, and its regions read ~1.6 times
the graph's), and each eager decode chunk starts behind a ~0.1 s spin
on the card, so the host has queued the chunk's operations before the
card reaches them (on a slower host 64 lanes alone read 1.23 times the
graph's). This file imports no JAX: the CPU side is
tests/test_torch_spans.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import HOST_SYNCS
from repro_torch.configs import get_arch
from repro_torch.models.model import Model
import repro_torch.serve.engine as engine_mod
from repro_torch.obs import spans
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tenancy.trace import ServeTraceRecorder


SPIN_CYCLES = 200_000_000     # ~0.1 s of the H100's clock


class DetailRecorder(ServeTraceRecorder):
    detail = True


def _behind_spin(body):
    """A decode body whose chunk starts behind a spin on the card."""
    @functools.wraps(body)
    def run(*args, **kw):
        torch.cuda._sleep(SPIN_CYCLES)
        return body(*args, **kw)
    return run


@pytest.fixture(scope="module")
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and events have no CPU "
                    "mode)")
    cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=2)
    model = Model(cfg, attention_impl="pallas", use_pallas=True,
                  device="cuda")
    return model, model.init(torch.Generator("cuda").manual_seed(0))


def _serve_twice(model, params, tracer, eager: bool):
    """The same 64 requests twice through one engine: (tokens, host syncs,
    spans) of the second pass, and the engine."""
    eng = ServeEngine(model, params, slots=64, max_len=4096, decode_chunk=8,
                      tracer=tracer, eager=eager)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, int(n))
               for n in rng.integers(100, 240, 64)]
    for _ in range(2):
        n_spans = len(tracer.spans) if tracer is not None else 0
        reqs = [Request(rid=i, prompt=p, max_new_tokens=40)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        before = HOST_SYNCS.count
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_steps=500)
        syncs = HOST_SYNCS.count - before
        assert all(r.state == "done" for r in reqs)
    got = tracer.spans[n_spans:] if tracer is not None else []
    return [r.out for r in reqs], syncs, got, eng


@pytest.mark.gpu
def test_graphed_attention_time_matches_eager(cuda_model, monkeypatch):
    model, params = cuda_model
    graphed = _serve_twice(model, params, DetailRecorder(), eager=False)
    with monkeypatch.context() as m:
        m.setattr(engine_mod, "_decode_body",
                  _behind_spin(engine_mod._decode_body))
        eager = _serve_twice(model, params, DetailRecorder(), eager=True)
    bare = _serve_twice(model, params, None, eager=False)
    tokens, syncs, got, eng = graphed
    assert (tokens, syncs) == bare[:2]
    ms = {}
    for label, (_, _, sp, _) in (("graphed", graphed), ("eager", eager)):
        decode = [s for s in sp if s.name.startswith("decode/")]
        assert decode and all(s.args["attention_regions"] ==
                              2 * s.args["steps"] for s in decode)
        assert all(0 < s.args["attention_ms"] <= 1e3 * s.dur
                   for s in decode)
        ms[label] = sum(s.args["attention_ms"] for s in decode)
    steps = sum(s.args["steps"] for s in got if s.name.startswith("decode/"))
    print(f"attention_ms over the second pass ({steps} decode steps): "
          f"graphed {ms['graphed']:.3f}, eager {ms['eager']:.3f} "
          f"({torch.cuda.get_device_name()})")
    assert abs(ms["graphed"] / ms["eager"] - 1) < 0.10, ms
    assert not any("serve.capture" in s.name for s in got)
    for n, runner in eng._decode_runners.items():
        assert len(runner.regions) == 2 * n
    # the driver's reading of the last replay's pairs is torch's
    pairs = eng._decode_runners[8].regions
    assert spans.elapsed_ms(pairs) == pytest.approx(
        sum(a.elapsed_time(b) for _, a, b in pairs), rel=1e-6)
    untraced = bare[3]
    assert all(not r.regions for r in list(untraced._decode_runners.values())
               + list(untraced._prefill_runners.values()))
