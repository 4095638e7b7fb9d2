"""The port's SDC guard (repro_torch/kernels/systolic_gemm/guard.py and
ServeEngine(guard=)) against the JAX package's.

On numpy inputs made from a seed: abft_verify on one shared c_aug with
planted corruptions (the verdicts, the located element and the repaired
block equal to the reference's), the checksum augmentation bit-equal,
the guarded GEMM against the fused epilogue for every activation, the
probe's certain detection of one element and its miss bound, the
injection's distinct rows and columns, and the guarded GEMMs of one
prefill and one decode step counted as the reference counts them. Then
the engine on reduced(granite-8b) after tests/test_sdc.py: guard "off"
is the unguarded engine; abft with SDC injected is token-exact against
the JAX ReferenceEngine; two corrupted elements end sdc-uncorrectable
without a leak, dense and paged; probe heals through retries; the
guard's events and the injector's counts equal the JAX guarded engine's
under the same ChaosConfig and VirtualClock. The restore of a guarded
decode retry: reduced mamba2 and hymba under probe with SDC give the
clean run's tokens, and fail without the restore; so does reduced
deepseek-v2, whose MLA latent lengths the retry restores. The guarded
kernel and guarded graphs on the card: tests/test_torch_guard_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.kernels.systolic_gemm import guard as jguard
from repro.models.model import Model as JaxModel
from repro.serve import chaos as jchaos
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.reference import ReferenceEngine as JaxReferenceEngine
from repro_torch import HOST_SYNCS, TOLERANCES
from repro_torch.bridge import model_params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.kernels.systolic_gemm import guard as tguard
from repro_torch.kernels.systolic_gemm import ops as tops
from repro_torch.models.model import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.chaos import ChaosConfig, VirtualClock
from repro_torch.serve.engine import Request, ServeEngine

RTOL = 1.0 / 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# abft_verify on one c_aug, both packages
# --------------------------------------------------------------------------

def _c_aug(m=12, k=16, n=10, seed=3):
    """x, w (f32, from a seed) and their augmented product, computed once
    in f64 and rounded to f32: the same numbers go to both packages."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    xa = np.concatenate([x, x.sum(0, keepdims=True)], 0).astype(np.float64)
    wa = np.concatenate([w, w.sum(1, keepdims=True)], 1).astype(np.float64)
    return x, w, (xa @ wa).astype(np.float32)


# (name, [(row, col, delta)]): one data element, two elements on distinct
# rows and columns, the checksum row only, and no corruption
PLANTS = {
    "clean": [],
    "one": [(5, 7, 1e4)],
    "two": [(2, 3, 1e4), (3, 4, -3e3)],
    "checksum_row": [(12, 4, 1e4)],
}


@pytest.mark.parametrize("plant", list(PLANTS))
def test_abft_verify_equals_the_reference(plant):
    x, w, c_aug = _c_aug()
    bad = c_aug.copy()
    for r, c, d in PLANTS[plant]:
        bad[r, c] += np.float32(d)
    j_out, j_rep = jguard.abft_verify(jnp.asarray(bad), jnp.asarray(x),
                                      jnp.asarray(w), rtol=RTOL)
    t_out, t_rep = tguard.abft_verify(_t(bad), _t(x), _t(w), rtol=RTOL)
    # row and col name the argmax residuals: they locate a planted hit on
    # their side and are float noise otherwise (a checksum-row hit moves
    # the column residuals only)
    located = {"clean": (), "one": ("row", "col"), "two": ("row", "col"),
               "checksum_row": ("col",)}[plant]
    for key in ("detected", "corrected", "uncorrected") + located:
        assert int(t_rep[key]) == int(j_rep[key]), key
    j_out, t_out = np.asarray(j_out), t_out.numpy()
    off = np.ones(j_out.shape, bool)
    if int(j_rep["corrected"]) and plant == "one":
        r, c = int(j_rep["row"]), int(j_rep["col"])
        off[r, c] = False
        assert abs(t_out[r, c] - j_out[r, c]) <= 1e-5 * np.abs(j_out).max()
        assert abs(t_out[r, c] - c_aug[r, c]) <= 1e-5 * np.abs(j_out).max()
    np.testing.assert_array_equal(t_out[off], j_out[off])
    expect = {"clean": (0, 0, 0), "one": (1, 1, 0), "two": (1, 0, 1),
              "checksum_row": (1, 1, 0)}[plant]
    assert (int(t_rep["detected"]), int(t_rep["corrected"]),
            int(t_rep["uncorrected"])) == expect


@pytest.mark.parametrize("seed", range(6))
def test_abft_transposed_single_corruption_located_and_repaired(seed):
    """The NT layout (w [N, K], augment_wt): a single element anywhere is
    located and repaired to the clean value, as the reference does."""
    rng = np.random.default_rng(seed)
    m, k, n = (int(v) for v in rng.integers(2, 24, 3))
    x = _t(rng.standard_normal((m, k)).astype(np.float32))
    wt = _t(rng.standard_normal((n, k)).astype(np.float32))
    c_aug = tguard.augment_x(x).double() @ tguard.augment_wt(wt).double().t()
    c_aug = c_aug.float()
    r, c = int(rng.integers(m)), int(rng.integers(n))
    bad = c_aug.clone()
    bad[r, c] += 1e4
    out, rep = tguard.abft_verify(bad, x, wt, rtol=RTOL, transpose=True)
    j_out, j_rep = jguard.abft_verify(jnp.asarray(bad.numpy()),
                                      jnp.asarray(x.numpy()),
                                      jnp.asarray(wt.numpy()), rtol=RTOL,
                                      transpose=True)
    assert (int(rep["row"]), int(rep["col"])) == (r, c) == (
        int(j_rep["row"]), int(j_rep["col"]))
    assert int(rep["corrected"]) == int(j_rep["corrected"]) == 1
    np.testing.assert_allclose(out.numpy(), c_aug[:m, :n].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert tguard.tile_of(r, c, 8, 8) == jguard.tile_of(r, c, 8, 8)


# --------------------------------------------------------------------------
# augment, guarded_gemm, PodGuard
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_augment_bit_equal_to_the_reference(dtype, seed):
    """The augmented operands in the served dtype, bf16, bit for bit. In
    f32 the checksums are f32 sums whose order of summation each framework
    picks for itself, so there the data part is bit-equal and each
    checksum within f32 rounding of the reference's (the guard's rtol is
    1/64)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((9, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    for jf, tf, a, data in (
            (jguard.augment_x, tguard.augment_x, x, np.s_[:-1, :]),
            (jguard.augment_w, tguard.augment_w, w, np.s_[:, :-1]),
            (jguard.augment_wt, tguard.augment_wt, w.T.copy(),
             np.s_[:-1, :])):
        ja = np.asarray(jf(jnp.asarray(a, jdt)).astype(jnp.float32))
        ta = tf(_t(a).to(tdt)).float().numpy()
        assert ta.shape == ja.shape
        if dtype == "bfloat16":
            np.testing.assert_array_equal(ta, ja)
            continue
        np.testing.assert_array_equal(ta[data], ja[data])
        np.testing.assert_allclose(ta, ja, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["abft", "probe"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu",
                                        "relu2"])
@pytest.mark.parametrize("transpose", [False, True])
def test_guarded_gemm_matches_the_fused_epilogue(mode, activation,
                                                 transpose):
    """The guarded GEMM (raw GEMM, verdict, then the epilogue) against
    the fused pod GEMM on clean bf16 inputs, every activation, within
    gemm_bf16_f32out; no verdict is raised."""
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((8, 64)).astype(np.float32)).bfloat16()
    w = _t(rng.standard_normal((64, 24)).astype(np.float32)).bfloat16()
    scale = _t(rng.standard_normal(24).astype(np.float32))
    bias = _t(rng.standard_normal(24).astype(np.float32))
    wl = w.t().contiguous() if transpose else w
    fused = (tops.systolic_gemm_t if transpose else tops.systolic_gemm)(
        x, wl, scale, bias, activation=activation)
    with tguard.GuardTape(tguard.PodGuard(mode=mode)) as tape:
        got = tguard.guarded_gemm(x, wl, scale, bias,
                                  guard=tguard.PodGuard(mode=mode),
                                  activation=activation, transpose=transpose)
    corr, unc = tape.totals()
    assert tape.gemms == 1 and int(corr) == 0 and int(unc) == 0
    tol = TOLERANCES["gemm_bf16_f32out"]
    assert tol.ok(got, fused), tol.excess(got, fused)


def test_guarded_gemm_rejects_int8_under_abft():
    x = torch.ones((4, 8), dtype=torch.int8)
    w = torch.ones((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        tguard.guarded_gemm(x, w, guard=tguard.PodGuard(mode="abft"))
    with pytest.raises(ValueError, match="int8"):
        jguard.guarded_gemm(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                            guard=jguard.PodGuard(mode="abft"),
                            interpret=True)
    out = tguard.guarded_gemm(x, w, guard=tguard.PodGuard(mode="probe"))
    assert torch.equal(out, torch.full((4, 4), 8.0))
    with pytest.raises(ValueError, match="guard off"):
        tguard.guarded_gemm(x.float(), w.float(), guard=tguard.PodGuard())


@pytest.mark.parametrize("args", [
    dict(mode="bogus"), dict(rtol=2.0), dict(rtol=0.0), dict(probes=0),
    dict(mode="abft", rtol=0.5, probes=3), dict()])
def test_pod_guard_validates_as_the_reference(args):
    def outcome(cls):
        try:
            g = cls(**args)
        except Exception as err:            # noqa: BLE001
            return type(err).__name__
        return (g.mode, g.rtol, g.probes, g.probe_seed)
    assert outcome(tguard.PodGuard) == outcome(jguard.PodGuard)
    assert tguard.MODES == jguard.MODES
    assert tguard.MAX_SDC_ELEMS == jguard.MAX_SDC_ELEMS


@pytest.mark.parametrize("value", [None, "abft", "probe", "off", 42])
def test_as_guard_as_the_reference(value):
    def outcome(fn, cls):
        v = cls(mode="probe") if value == "probe" else value
        try:
            return fn(v).mode
        except TypeError:
            return "TypeError"
    assert outcome(tguard.as_guard, tguard.PodGuard) == \
        outcome(jguard.as_guard, jguard.PodGuard)


# --------------------------------------------------------------------------
# probes and injection
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_probe_single_corruption_always_detected(seed):
    rng = np.random.default_rng(seed)
    m, k, n = (int(v) for v in rng.integers(2, 24, 3))
    x, w, c_aug = _c_aug(m, k, n, seed)
    c = _t(c_aug[:m, :n])
    x, w = _t(x), _t(w)
    for transpose in (False, True):
        wl = w.t().contiguous() if transpose else w
        assert int(tguard.freivalds_detect(c, x, wl, probes=1, seed=seed,
                                           rtol=RTOL,
                                           transpose=transpose)) == 0
        bad = c.clone()
        bad[int(rng.integers(m)), int(rng.integers(n))] += 1e4
        assert int(tguard.freivalds_detect(bad, x, wl, probes=1, seed=seed,
                                           rtol=RTOL,
                                           transpose=transpose)) == 1


def test_probe_adversarial_miss_rate_obeys_documented_bound():
    """+delta and -delta on one row escape a probe iff the Rademacher
    vector agrees at both columns (p = 1/2 a probe): over seeds the miss
    rate respects <= 2**-probes with sampling slack, and more probes
    shrink it, as in the reference's test."""
    x, w, c_aug = _c_aug(8, 16, 12, 0)
    c = _t(c_aug[:8, :12]).clone()
    c[3, 2] += 1e4
    c[3, 9] -= 1e4
    trials = 200
    misses = {p: sum(int(tguard.freivalds_detect(
        c, _t(x), _t(w), probes=p, seed=s, rtol=RTOL)) == 0
        for s in range(trials)) / trials for p in (1, 3)}
    assert misses[1] <= 0.5 + 0.12
    assert misses[3] <= 0.125 + 0.08
    assert misses[3] < misses[1]


@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
def test_probe_tolerance_at_full_width_as_the_reference(n):
    """The probe's tolerance is rtol (max|c| + 1) sqrt(N), and a lone
    element moved by delta dominates max|c|: it is caught only where
    rtol sqrt(N) (1 + (c + 1) / delta) < 1, about N < 4096 at rtol 1/64,
    in both packages alike.
    At granite's q (N = 4096) and mamba2's head (N = 50280) a lone hit on
    a positive element passes undetected (the chip's guard phases report
    it)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    w = (rng.standard_normal((8, n)) / 8).astype(np.float32)
    c = (x.astype(np.float64) @ w).astype(np.float32)
    r, col = np.unravel_index(np.argmax(c), c.shape)   # a positive element
    c[r, col] += np.float32(1e4)
    j = int(jguard.freivalds_detect(jnp.asarray(c), jnp.asarray(x),
                                    jnp.asarray(w), probes=1, seed=0,
                                    rtol=RTOL))
    t = int(tguard.freivalds_detect(_t(c), _t(x), _t(w), probes=1, seed=0,
                                    rtol=RTOL))
    assert t == j == (1 if n < 4096 else 0)


@pytest.mark.parametrize("seed", [0, 123, 99991, (1 << 31) - 1])
def test_inject_sdc_hits_distinct_rows_and_cols(seed):
    c = torch.zeros((6, 5))
    out = tguard.inject_sdc(c.clone(), 0, torch.tensor([0, seed, 2]), 1e4,
                            6, 5).numpy()
    rows, cols = np.nonzero(out)
    assert len(rows) == 2 and rows[0] != rows[1] and cols[0] != cols[1]
    assert np.all(out[rows, cols] == 1e4)
    one = tguard.inject_sdc(c.clone(), 0, torch.tensor([0, seed, 1]), 1e4,
                            6, 5).numpy()
    assert np.count_nonzero(one) == 1
    # disarmed plans and index misses are exact no-ops
    assert not tguard.inject_sdc(c.clone(), 0, torch.tensor([-1, seed, 2]),
                                 1e4, 6, 5).any()
    assert not tguard.inject_sdc(c.clone(), 1, torch.tensor([0, seed, 2]),
                                 1e4, 6, 5).any()


# --------------------------------------------------------------------------
# the guarded GEMM count of one prefill and one decode step
# --------------------------------------------------------------------------

def _bridged(arch, jax_kw=None, **model_kw):
    cfg = reduced(get_arch(arch))
    jm = JaxModel(cfg, **(jax_kw or {}))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(t_reduced(t_get_arch(arch)), device="cpu", **model_kw)
    return jm, jp, tm, model_params_from_jax(tm, jax.tree.map(np.asarray,
                                                              jp))


def _jax_gemms(jm, jp, fn):
    """Guarded GEMMs the reference registers in one traced call (traced
    only: eval_shape runs no kernel)."""
    with jguard.GuardTape(jguard.PodGuard(mode="probe")) as tape:
        jax.eval_shape(fn, jp)
    return tape.gemms


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-370m", "hymba-1.5b",
                                  "dbrx-132b", "deepseek-v2-236b"])
def test_gemm_count_per_forward_equals_the_reference(arch):
    jm, jp, tm, tp = _bridged(arch, jax_kw=dict(use_pallas=True),
                              use_pallas=True)
    B, S = 2, 8
    toks = np.arange(B * S, dtype=np.int32).reshape(B, S) % jm.cfg.vocab
    j_pre = _jax_gemms(jm, jp, lambda p: jm.forward(
        p, {"tokens": jnp.asarray(toks)}, cache=jm.init_cache(B, 16)))
    j_dec = _jax_gemms(jm, jp, lambda p: jm.decode_step(
        p, jnp.asarray(toks[:, 0]), jm.init_cache(B, 16),
        jnp.full((B,), 3, jnp.int32)))
    guard = tguard.PodGuard(mode="probe")
    with tguard.GuardTape(guard) as t_pre:
        tm.forward(tp, {"tokens": torch.from_numpy(toks).long()},
                   cache=tm.init_cache(B, 16))
    with tguard.GuardTape(guard) as t_dec:
        tm.decode_step(tp, torch.from_numpy(toks[:, 0]).long(),
                       tm.init_cache(B, 16), torch.full((B,), 3))
    assert (t_pre.gemms, t_dec.gemms) == (j_pre, j_dec)
    assert j_pre > 0


# --------------------------------------------------------------------------
# the engine on reduced granite (tests/test_sdc.py's requests and chaos)
# --------------------------------------------------------------------------

def _reqs(cls=Request, n=4, max_new=6):
    return [cls(rid=i, prompt=[1 + i, 2, 3 + i], max_new_tokens=max_new)
            for i in range(n)]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=500)
    assert all(s is None for s in eng.active), "slot leak"
    return {r.rid: (r.state, r.reason, list(r.out)) for r in reqs}


@pytest.fixture(scope="module")
def granite():
    """reduced(granite-8b): the JAX pod-GEMM model and its parameters, the
    JAX ReferenceEngine(Model(cfg)) oracle of tests/test_sdc.py, and the
    port's pod-GEMM model with the same parameters."""
    jm, jp, tm, tp = _bridged("granite-8b", jax_kw=dict(use_pallas=True),
                              use_pallas=True)
    oracle = _drain(JaxReferenceEngine(JaxModel(jm.cfg), jp, slots=4,
                                       max_len=64), _reqs(JaxRequest))
    return jm, jp, tm, tp, oracle


class _CountingPlain:
    """Counts the pod GEMM's plain-version calls (the CPU's launches)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        for name in ("systolic_gemm_ref", "systolic_gemm_t_ref"):
            real = getattr(tops, name)

            def counted(*a, _real=real, **k):
                self.calls += 1
                return _real(*a, **k)
            monkeypatch.setattr(tops, name, counted)


def test_guard_off_is_the_unguarded_engine(granite, monkeypatch):
    """guard="off" changes nothing: tokens, every host read, runner
    counts, runner inputs, host syncs and the pod GEMM's calls."""
    _, _, tm, tp, _ = granite
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 9, 17, 12)]
    runs = {}
    for name, kw in (("bare", {}), ("off", {"guard": "off"}),
                     ("none", {"guard": None})):
        reads = []
        real = engine_mod.to_host

        def to_host(t, _real=real):
            out = _real(t)
            reads.append(out.copy())
            return out
        monkeypatch.setattr(engine_mod, "to_host", to_host)
        counter = _CountingPlain(monkeypatch)
        eng = ServeEngine(tm, tp, slots=2, max_len=64, **kw)
        s0 = HOST_SYNCS.count
        reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        _drain(eng, reqs)
        runs[name] = ([r.out for r in reqs], eng.prefill_compiles,
                      eng.decode_compiles, HOST_SYNCS.count - s0,
                      counter.calls, sorted(
                          k for r in list(eng._prefill_runners.values()) +
                          list(eng._decode_runners.values())
                          for k in r.inputs))
        monkeypatch.setattr(engine_mod, "to_host", real)
        runs[name] += (reads,)
    bare = runs.pop("bare")
    for name, run in runs.items():
        assert run[:-1] == bare[:-1], name
        assert all(np.array_equal(a, b) for a, b in zip(run[-1], bare[-1]))
    assert "sdc" not in bare[5]


def test_abft_corrects_injected_sdc_token_exact(granite):
    """Single-element SDC under abft: detected, corrected inside the
    step, and the tokens equal the JAX ReferenceEngine's."""
    _, _, tm, tp, oracle = granite
    metrics = MetricsRegistry()
    chaos = ChaosConfig(seed=7, p_sdc=0.6, sdc_elems=1, transient_tries=1)
    eng = ServeEngine(tm, tp, slots=4, max_len=64, guard="abft",
                      chaos=chaos, clock=VirtualClock(), max_retries=3,
                      metrics=metrics)
    states = _drain(eng, _reqs())
    assert eng._chaos.injected["sdc"] > 0
    assert eng.guard_events["corrected"] > 0
    assert eng.guard_events["uncorrectable"] == 0
    assert metrics.counter("serve.guard.corrected").value == \
        eng.guard_events["corrected"]
    for rid, (state, _, out) in states.items():
        assert state == "done" and out == oracle[rid][2]
    assert all("sdc" in r.inputs for r in eng._decode_runners.values())


def test_restart_repeats_the_run_of_a_new_engine(granite):
    """ServeEngine.restart resets the run (chaos draws, clock, guard
    events, metrics) and keeps the runners: the same chaos run again
    gives the same tokens, events and injections with no new runner. An
    engine that holds a request refuses it."""
    _, _, tm, tp, _ = granite

    def chaos():
        return ChaosConfig(seed=7, p_sdc=0.6, sdc_elems=1, transient_tries=1)

    def run(eng, metrics):
        return (_drain(eng, _reqs()), dict(eng.guard_events),
                dict(eng._chaos.injected),
                metrics.counter("serve.guard.corrected").value,
                eng.prefill_compiles, eng.decode_compiles)

    metrics = MetricsRegistry()
    eng = ServeEngine(tm, tp, slots=4, max_len=64, guard="abft",
                      chaos=chaos(), clock=VirtualClock(), metrics=metrics)
    first = run(eng, metrics)
    assert first[1]["corrected"] > 0
    metrics = MetricsRegistry()
    eng.restart(chaos=chaos(), clock=VirtualClock(), metrics=metrics)
    assert run(eng, metrics) == first
    eng.submit(_reqs(n=1)[0])
    with pytest.raises(RuntimeError, match="holds no request"):
        eng.restart()


@pytest.mark.parametrize("paged", [False, True])
def test_multi_element_sdc_exhausts_retries_no_leak(granite, paged):
    """Two corrupted elements defeat the location on every retry: the
    requests end sdc-uncorrectable, and no slot or page is held."""
    _, _, tm, tp, _ = granite
    metrics = MetricsRegistry()
    chaos = ChaosConfig(seed=7, p_sdc=0.9, sdc_elems=2, transient_tries=10)
    kw = dict(paged=True, page_size=16) if paged else {}
    eng = ServeEngine(tm, tp, slots=4, max_len=64, guard="abft",
                      chaos=chaos, clock=VirtualClock(), max_retries=1,
                      metrics=metrics, **kw)
    states = _drain(eng, _reqs())
    rejected = [rid for rid, (s, why, _) in states.items()
                if (s, why) == ("rejected", "sdc-uncorrectable")]
    assert rejected, states
    assert all(s in ("done", "rejected") for s, _, _ in states.values())
    assert eng.guard_events["uncorrectable"] > 0
    assert metrics.counter("serve.chaos.sdc_uncorrectable").value == \
        eng.guard_events["uncorrectable"]
    assert metrics.counter("serve.chaos.permanent_faults").value == 0
    if paged:
        assert eng._pool.pages_in_use == 0
        assert eng._pool.reserved_pages == 0


def test_probe_detects_then_retry_heals_token_exact(granite):
    _, _, tm, tp, oracle = granite
    chaos = ChaosConfig(seed=7, p_sdc=0.6, sdc_elems=1, transient_tries=1)
    eng = ServeEngine(tm, tp, slots=4, max_len=64, guard="probe",
                      chaos=chaos, clock=VirtualClock(), max_retries=3)
    states = _drain(eng, _reqs())
    assert eng._chaos.injected["sdc"] > 0
    assert eng.guard_events["uncorrectable"] == 0
    for rid, (state, _, out) in states.items():
        assert state == "done" and out == oracle[rid][2]


def test_guard_events_equal_the_jax_guarded_engine(granite):
    """The JAX guarded engine (Pallas interpret) and the port's under the
    same ChaosConfig and VirtualClock: guard events, the injector's
    counts, the final virtual time and the tokens are equal."""
    jm, jp, tm, tp, _ = granite
    kw = dict(seed=7, p_sdc=0.5, sdc_elems=1, transient_tries=1)
    jclock, tclock = jchaos.VirtualClock(), VirtualClock()
    jeng = JaxServeEngine(jm, jp, slots=4, max_len=64, guard="abft",
                          chaos=jchaos.ChaosConfig(**kw), clock=jclock,
                          max_retries=3)
    teng = ServeEngine(tm, tp, slots=4, max_len=64, guard="abft",
                       chaos=ChaosConfig(**kw), clock=tclock, max_retries=3)
    jst = _drain(jeng, _reqs(JaxRequest))
    tst = _drain(teng, _reqs())
    assert teng.guard_events == jeng.guard_events
    assert teng._chaos.injected == jeng._chaos.injected
    assert teng._chaos.injected["sdc"] > 0
    assert tclock() == jclock()
    assert tst == jst


# --------------------------------------------------------------------------
# the restore of a guarded decode retry (ssm, hybrid and MLA state)
# --------------------------------------------------------------------------

class _NoRestore(ServeEngine):
    """Planted control: a retried decode chunk starts from the state the
    failed attempt left (the SSM state stepped, the rings overwritten,
    the lengths advanced)."""

    def _restore_decode_state(self):
        pass


@pytest.fixture(scope="module", params=["mamba2-370m", "hymba-1.5b",
                                        "deepseek-v2-236b"])
def stateful(request):
    jm, jp, tm, tp = _bridged(request.param, use_pallas=True)
    return tm, tp


def test_decode_retry_restores_the_state_it_advanced(stateful):
    tm, tp = stateful
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 40, 9, 21)]

    def run(cls, **kw):
        eng = cls(tm, tp, slots=4, max_len=64, guard="probe",
                  clock=VirtualClock(), max_retries=3,
                  metrics=MetricsRegistry(), **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        states = _drain(eng, reqs)
        return eng, states
    _, clean = run(ServeEngine)
    chaos = ChaosConfig(seed=2, p_sdc=0.7, sdc_elems=1, transient_tries=1)
    eng, healed = run(ServeEngine, chaos=chaos)
    # decode chunks failed the probe and were retried
    assert eng.metrics.counter("serve.chaos.retries", kind="decode").value
    assert eng.guard_events["uncorrectable"] == 0
    assert healed == clean
    planted, broken = run(_NoRestore, chaos=chaos)
    assert planted._chaos.injected == eng._chaos.injected
    assert broken != clean
