"""The port's serving controls (repro_torch/serve/{admission,chaos}.py and
the controlled ServeEngine) against the JAX package's.

Each scenario of tests/test_admission.py runs through the JAX ServeEngine
and the port's on reduced(granite-8b) with the same parameters
(bridge.model_params_from_jax), in f32 with f32 caches, each engine under
its own VirtualClock with a metrics registry and a trace recorder on.
Time then moves only by the chaos injector's stalls and the retries'
backoff, so two engines that make the same decisions read the same times:
per request (state, reason, tokens), the admission counts,
slo_attainment, the slo-aware calibration, the final virtual time, the
tracer's events and spans and the metrics snapshot must all be equal.

Then the zero-cost gates: the defaults give the tokens, host syncs and
runners of an engine built without the new arguments (one sync per
prefill group and decode chunk, tokens equal to the per-token
ReferenceEngine, runner counts equal to the JAX engine's jit caches), and
metrics and tracer on add no sync and no runner. The test marked gpu
retries injected faults on the card: the same runners and graphs replay,
and the tokens are the chaos-free run's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models.model import Model as JaxModel
from repro.obs.metrics import MetricsRegistry as JaxMetrics
from repro.serve import admission as jadm
from repro.serve import chaos as jchaos
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.tenancy.trace import ServeTraceRecorder as JaxRecorder
from repro_torch import HOST_SYNCS
from repro_torch.bridge import model_params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models.model import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import admission as tadm
from repro_torch.serve import chaos as tchaos
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.reference import ReferenceEngine
from repro_torch.tenancy.trace import ServeTraceRecorder


class _JaxF32(JaxModel):
    """The reference model with f32 caches (the engines build theirs with
    init_cache's bf16 default, which f32 activations cannot write)."""

    def init_cache(self, *args, dtype=jnp.float32, **kw):
        return super().init_cache(*args, dtype=dtype, **kw)


class _PortF32(Model):
    def init_cache(self, *args, dtype=torch.float32, **kw):
        return super().init_cache(*args, dtype=dtype, **kw)


@pytest.fixture(scope="module")
def models():
    """reduced(granite-8b), JAX and port, in f32 with the same parameters
    (the reference init, cast)."""
    jm = _JaxF32(reduced(get_arch("granite-8b")))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    tm = _PortF32(t_reduced(t_get_arch("granite-8b")), device="cpu")
    return jm, tm, (jp, model_params_from_jax(tm, jax.tree.map(np.asarray,
                                                               jp)))


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n, dtype=np.int32)


def _overload_requests(vocab):
    """tests/test_admission.py's overload: 12 prompts of 5-8 tokens, 6 new
    tokens each, deadlines 0.8 and 7.0 s alternating."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(12):
        p = rng.integers(0, vocab, int(rng.integers(5, 9)), dtype=np.int32)
        out.append(dict(rid=i, prompt=p, max_new_tokens=6,
                        deadline_s=0.8 if i % 2 else 7.0))
    return out


def _overload(policy):
    return dict(engine=dict(slots=2, max_len=64, decode_chunk=8),
                admission=dict(policy=policy),
                chaos=dict(seed=0, service_seconds=0.05),
                requests=_overload_requests)


# Each scenario: engine arguments, the AdmissionConfig's and ChaosConfig's
# fields (each side builds its own), the requests (from the vocabulary),
# and what must show in the run (so a scenario cannot pass vacuously).
SCENARIOS = {
    "queued-expiry": dict(
        engine=dict(slots=1, max_len=32), admission=dict(policy="edf"),
        chaos=dict(seed=0, service_seconds=0.2),
        requests=lambda v: [dict(rid=i, prompt=_prompt(v, 4, i),
                                 max_new_tokens=4, deadline_s=0.5)
                            for i in range(6)],
        shows=("expired", "queued-past-deadline")),
    "running-expiry": dict(
        engine=dict(slots=1, max_len=64, decode_chunk=4),
        admission=dict(policy="edf"),
        chaos=dict(seed=0, service_seconds=0.3),
        requests=lambda v: [dict(rid=0, prompt=_prompt(v, 4, 0),
                                 max_new_tokens=32, deadline_s=0.5)],
        shows=("expired", "deadline-exceeded")),
    "queue-full": dict(
        engine=dict(slots=1, max_len=32), admission=dict(max_queue=2),
        requests=lambda v: [dict(rid=i, prompt=_prompt(v, 4, i),
                                 max_new_tokens=2) for i in range(5)],
        shows=("rejected", "queue-full")),
    "slo-aware-degrades": dict(
        engine=dict(slots=1, max_len=64),
        admission=dict(policy="slo-aware", overload_queue_per_slot=2.0),
        chaos=dict(seed=0, service_seconds=0.01),
        requests=lambda v: [dict(rid=i, prompt=_prompt(v, 4, i),
                                 max_new_tokens=9) for i in range(8)],
        shows="degraded"),
    "overload-fifo": _overload("fifo"),
    "overload-edf": _overload("edf"),
    "overload-slo-aware": _overload("slo-aware"),
    "faults-heal": dict(
        engine=dict(slots=2, max_len=32, max_retries=3, backoff_s=1e-3),
        chaos=dict(seed=1, p_fault=0.4, transient_tries=2),
        requests=lambda v: [
            dict(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(
                np.random.default_rng(5).integers(0, v, n, dtype=np.int32)
                for n in (4, 7, 5, 9))],
        shows="faults"),
    "retries-exhausted": dict(
        engine=dict(slots=2, max_len=32, max_retries=1),
        chaos=dict(seed=1, p_fault=0.4, transient_tries=5),
        requests=lambda v: [dict(rid=i, prompt=_prompt(v, 4 + i, i),
                                 max_new_tokens=3) for i in range(6)],
        shows=("rejected", "device-fault")),
    "slow-chunks": dict(
        engine=dict(slots=2, max_len=64, decode_chunk=8),
        chaos=dict(seed=2, p_slow=0.8, slow_factor=6.0,
                   service_seconds=0.01),
        patience=1,
        requests=lambda v: [dict(rid=i, prompt=_prompt(v, 5, i),
                                 max_new_tokens=16) for i in range(2)],
        shows="chunk-cap"),
    "paged-page-exhaustion": dict(
        engine=dict(slots=4, max_len=64, decode_chunk=4, paged=True,
                    page_size=8, kv_pages=8),
        admission=dict(policy="slo-aware"),
        chaos=dict(seed=0, service_seconds=0.05),
        requests=lambda v: [dict(rid=i, prompt=_prompt(v, 20, i),
                                 max_new_tokens=8, deadline_s=1.0)
                            for i in range(10)],
        shows=("rejected", "shed-page-exhaustion")),
    "exact-length-prefill": dict(
        engine=dict(slots=2, max_len=32, prefill_buckets=False),
        admission=dict(policy="edf"),
        chaos=dict(seed=1, p_fault=0.4, transient_tries=2,
                   service_seconds=0.05),
        requests=lambda v: [dict(rid=i, prompt=_prompt(v, n, i),
                                 max_new_tokens=5,
                                 deadline_s=0.4 if i % 2 else 5.0)
                            for i, n in enumerate((4, 9, 6, 11, 7))],
        shows="exact"),
}

SIDES = {
    "jax": (JaxServeEngine, JaxRequest, jadm.AdmissionConfig,
            jchaos.ChaosConfig, jchaos.VirtualClock, JaxMetrics,
            JaxRecorder),
    "port": (ServeEngine, Request, tadm.AdmissionConfig, tchaos.ChaosConfig,
             tchaos.VirtualClock, MetricsRegistry, ServeTraceRecorder),
}


def _serve(side, models, sc):
    """One scenario through one side's engine: every request terminal and
    no slot held; returns what the two sides must agree on."""
    jm, tm, params = models
    engine_cls, req_cls, adm_cls, chaos_cls, clock_cls, metrics_cls, \
        rec_cls = SIDES[side]
    model = jm if side == "jax" else tm
    p = params[0 if side == "jax" else 1]
    clock, metrics, tracer = clock_cls(), metrics_cls(), rec_cls()
    kw = dict(sc["engine"])
    if "admission" in sc:
        kw["admission"] = adm_cls(**sc["admission"])
    if "chaos" in sc:
        kw["chaos"] = chaos_cls(**sc["chaos"])
    eng = engine_cls(model, p, clock=clock, metrics=metrics, tracer=tracer,
                     **kw)
    if "patience" in sc:
        eng._slow_detect.patience = sc["patience"]
    reqs = [req_cls(**r) for r in sc["requests"](tm.cfg.vocab)]
    caps = []
    for r in reqs:
        eng.submit(r)
    for _ in range(2000):
        if not eng.queue and not any(eng.active):
            break
        eng.step()
        caps.append(eng._chunk_cap)
    assert not eng.queue and not any(eng.active), "slot leak at drain"
    assert all(r.state in ("done", "rejected", "expired") for r in reqs)
    if eng._pool is not None:
        eng._pool.assert_drained()
    return {"requests": [(r.rid, r.state, r.reason, [int(t) for t in r.out])
                         for r in reqs],
            "counts": dict(eng.admission.counts),
            "slo_attainment": eng.admission.slo_attainment,
            # the slo-aware calibration (wall over model seconds), fed
            # only by retires whose compile epoch did not move
            "kappa": eng.admission._calibration.value,
            "clock": clock.t,
            "events": list(tracer.events),
            "spans": [(s.name, s.ts, s.dur, s.cat, s.args)
                      for s in tracer.spans],
            "metrics": metrics.dumps(),
            "injected": None if eng._chaos is None
            else dict(eng._chaos.injected),
            "chunk_caps": caps, "bucketed": eng.bucketed}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controls_agree_with_the_reference(models, name):
    sc = SCENARIOS[name]
    ref = _serve("jax", models, sc)
    got = _serve("port", models, sc)
    for key in ("requests", "counts", "slo_attainment", "kappa", "clock",
                "events", "spans", "metrics", "injected", "chunk_caps"):
        assert got[key] == ref[key], (name, key)
    shows = sc.get("shows")
    states = {(state, reason) for _, state, reason, _ in got["requests"]}
    if isinstance(shows, tuple):
        assert shows in states, states
    elif shows == "degraded":
        assert got["counts"]["degraded"] > 0 and got["kappa"] is not None
    elif shows == "faults":
        assert got["injected"]["faults"] > 0 and got["clock"] > 0
        assert all(s == "done" for _, s, _, _ in got["requests"])
    elif shows == "chunk-cap":
        assert got["injected"]["slow"] > 0
        assert any(c is not None for c in got["chunk_caps"])
    elif shows == "exact":
        assert not got["bucketed"] and got["injected"]["faults"] > 0


def test_overload_ordering_edf_and_slo_aware_beat_fifo(models):
    """tests/test_admission.py's acceptance on the port alone."""
    att = {}
    for policy in ("fifo", "edf", "slo-aware"):
        att[policy] = _serve("port", models, _overload(policy))[
            "slo_attainment"]
    assert att["edf"] > att["fifo"] and att["slo-aware"] > att["fifo"], att


def _counted(engine, prompts, max_new=5):
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    before = HOST_SYNCS.count
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=500)
    assert all(r.state == "done" for r in reqs)
    return ([r.out for r in reqs], HOST_SYNCS.count - before,
            (getattr(engine, "prefill_compiles", None),
             getattr(engine, "decode_compiles", None)))


def test_defaults_are_free(models):
    """The defaults (fifo, unbounded queue, no deadlines, no chaos, no
    metrics, no tracer) spelled out give the tokens, host syncs and runners
    of an engine built without them: one sync per prefill group and decode
    chunk, tokens equal to the per-token ReferenceEngine, runners equal to
    the JAX engine's jit cache sizes. Metrics and tracer on add no sync and
    no runner."""
    jm, tm, params = models
    jp, tp = params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, n, dtype=np.int32)
               for n in (5, 9, 17, 12, 33, 7)]
    kw = dict(slots=2, max_len=64, decode_chunk=8)
    bare = ServeEngine(tm, tp, **kw)
    runs = {"bare": _counted(bare, prompts)}
    runs["defaults"] = _counted(ServeEngine(
        tm, tp, admission=tadm.AdmissionConfig(policy="fifo"), chaos=None,
        clock=None, max_retries=3, backoff_s=1e-3, prefill_buckets=True,
        **kw), prompts)
    metrics, tracer = MetricsRegistry(), ServeTraceRecorder()
    runs["instrumented"] = _counted(ServeEngine(
        tm, tp, metrics=metrics, tracer=tracer, **kw), prompts)
    assert runs["defaults"] == runs["bare"]
    assert runs["instrumented"] == runs["bare"]
    tokens, syncs, runners = runs["bare"]
    assert syncs == bare.stats["prefill_calls"] + bare.stats["chunks"]
    assert len(tracer.spans) == syncs       # one span per device call
    assert metrics.value("serve.decode.chunks") == bare.stats["chunks"]
    ref = ReferenceEngine(tm, tp, slots=2, max_len=64)
    assert _counted(ref, prompts)[0] == tokens
    jeng = JaxServeEngine(jm, jp, **kw)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_to_completion(max_steps=500)
    assert [r.out for r in jreqs] == tokens
    assert runners == (jeng._prefill_fn._cache_size(),
                       jeng._decode_fn._cache_size())


def test_chunk_lengths_stay_in_the_pow2_runner_set(models):
    """Deadline-aware sizing and the slow-chunk cap pick chunk lengths
    from the pow2 set: decode runners stay within log2(decode_chunk) + 1."""
    jm, tm, params = models
    for name in ("running-expiry", "slow-chunks", "overload-slo-aware"):
        sc = SCENARIOS[name]
        eng = ServeEngine(tm, params[1], clock=tchaos.VirtualClock(),
                          chaos=tchaos.ChaosConfig(**sc["chaos"]),
                          admission=sc.get("admission", {}).get("policy"),
                          **sc["engine"])
        for r in sc["requests"](tm.cfg.vocab):
            eng.submit(Request(**r))
        eng.run_to_completion(max_steps=2000)
        assert eng.decode_compiles <= int(math.log2(eng.decode_chunk)) + 1
        assert all(n & (n - 1) == 0 for n in eng._decode_runners)


def test_wedged_engine_raises_serve_stalled_with_states(models):
    _, tm, params = models
    eng = ServeEngine(tm, params[1], slots=1, max_len=32)
    eng.submit(Request(rid=7, prompt=_prompt(tm.cfg.vocab, 4, 0),
                       max_new_tokens=4))
    eng._admit = lambda: None          # wedge: admission never runs
    with pytest.raises(tadm.ServeStalled) as err:
        eng.run_to_completion(max_steps=5)
    assert err.value.pending == {7: "queued"} and err.value.max_steps == 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_chaos_retries_replay_the_same_runners(cuda_device):
    """Injected faults on the card: a retry re-copies the same inputs into
    the same runner, so decode runners and graphs equal the chaos-free
    engine's and the tokens are its tokens."""
    model = Model(t_reduced(t_get_arch("granite-8b")), use_pallas=True)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n)
               for n in (5, 60, 17, 9, 33, 100, 3)]
    kw = dict(slots=4, max_len=128, decode_chunk=8)
    runs = {}
    for name, chaos in (("clean", None),
                        ("chaos", tchaos.ChaosConfig(seed=3, p_fault=0.3,
                                                     p_slow=0.3))):
        eng = ServeEngine(model, params, chaos=chaos, max_retries=3, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_steps=500)
        torch.cuda.synchronize()
        assert all(r.state == "done" for r in reqs)
        runs[name] = ([r.out for r in reqs], eng.prefill_compiles,
                      eng.decode_compiles, eng.stats["graphs"])
        if chaos is not None:
            assert eng._chaos.injected["faults"] > 0
    assert runs["chaos"] == runs["clean"]
