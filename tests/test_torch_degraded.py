"""Degraded-pod operation on the port's copies of core/tiling.py,
core/scheduler.py, core/simulator.py and serve/admission.py, against the
JAX package's originals.

tests/test_sdc.py's degraded-pod tests, each run through both packages on
the same inputs: bank masking in the retiler, placement on healthy pods
only, predictions monotone in dead pods (batched and scalar paths, and
the analytical model against the slice scheduler), and the slo-aware
predictor pricing a degraded array. Every value must equal the
reference's, and every error the reference raises must be raised.
"""

import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.core import dse as jdse
from repro.core import scheduler as jsched
from repro.core import simulator as jsim
from repro.core import tiling as jtiling
from repro.serve import admission as jadm
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.core import dse as tdse
from repro_torch.core import scheduler as tsched
from repro_torch.core import simulator as tsim
from repro_torch.core import tiling as ttiling
from repro_torch.serve import admission as tadm

PACKAGES = {"jax": (jdse, jsched, jsim, jtiling),
            "torch": (tdse, tsched, tsim, ttiling)}


def _gemms(tiling):
    return [tiling.GemmSpec(128, 256, 512, gemm_id=0),
            tiling.GemmSpec(128, 512, 256, gemm_id=1, depends_on=(0,))]


def _accel(dse):
    return dse.build_accel(32, 32, "butterfly-2", 400.0, 16)


def _both(fn):
    """fn(dse, sched, sim, tiling) on both packages."""
    return {name: fn(*mods) for name, mods in PACKAGES.items()}


def _op_tuples(graph):
    return [(op.x_bank, op.w_bank, op.p_bank) for op in graph.ops]


@pytest.mark.parametrize("faulty", [None, (), (0, 3), (1, 2, 5, 9)])
def test_tiling_masks_faulty_banks_as_the_reference(faulty):
    def run(dse, sched, sim, tiling):
        kw = {} if faulty is None else {"faulty_banks": faulty}
        g = tiling.tile_workload(_gemms(tiling), _accel(dse).array,
                                 num_banks=16, **kw)
        return _op_tuples(g), len(g.ops)
    out = _both(run)
    assert out["torch"] == out["jax"]
    used = {b for t in out["torch"][0] for b in t}
    assert not used & set(faulty or ())


def test_tiling_refuses_all_banks_dead_as_the_reference():
    for dse, sched, sim, tiling in PACKAGES.values():
        with pytest.raises(ValueError):
            tiling.tile_workload(_gemms(tiling), _accel(dse).array,
                                 num_banks=4, faulty_banks=(0, 1, 2, 3))


def test_scheduler_places_only_on_healthy_pods_as_the_reference():
    def run(dse, sched, sim, tiling):
        accel = _accel(dse)
        graph = tiling.tile_workload(_gemms(tiling), accel.array,
                                     num_banks=16, faulty_banks=(1, 2))
        s = sched.SliceScheduler(16, 32, accel.array.pipeline_latency,
                                 faulty_pods=(1, 2)).schedule(graph)
        return sorted(s.assignments.items()), len(graph.ops)
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert not {p for _, (_, p) in out["torch"][0]} & {1, 2}
    for dse, sched, sim, tiling in PACKAGES.values():
        with pytest.raises(ValueError):
            sched.SliceScheduler(4, 32, 4, faulty_pods=(0, 1, 2, 3))
        with pytest.raises(ValueError):
            sched.SliceScheduler(4, 32, 4, faulty_pods=(7,))


def test_degraded_predictions_equal_the_reference():
    """analyze over 0-14 dead pods, analyze_batch over a design batch,
    analyze_scalar and simulate at 0, 4 and 8: equal cycle counts, and
    the reference's monotonicity and calibration band."""
    def run(dse, sched, sim, tiling):
        accel = _accel(dse)
        gemms = _gemms(tiling)
        cycles = [sim.analyze(gemms, accel, faulty_pods=f).total_cycles
                  for f in range(0, 15)]
        packed = sim.pack_workloads({"wl": gemms})
        design = sim.DesignVector.from_accel(accel).repeat(4)
        batch = sim.analyze_batch(packed, design,
                                  faulty_pods=np.array([0, 2, 6, 12]))
        col = [int(c) for c in batch.total_cycles[:, 0]]
        scalar = [sim.analyze_scalar(gemms, accel, faulty_pods=f)
                  .total_cycles for f in (0, 2, 6, 12)]
        band = [(sim.analyze(gemms, accel, faulty_pods=f).total_cycles,
                 sim.simulate(gemms, accel, faulty_pods=f).total_cycles)
                for f in (0, 4, 8)]
        with pytest.raises(ValueError):
            sim.analyze_batch(packed, sim.DesignVector.from_accel(accel),
                              faulty_pods=16)
        return cycles, col, scalar, band
    out = _both(run)
    assert out["torch"] == out["jax"]
    cycles, col, scalar, band = out["torch"]
    assert all(b >= a for a, b in zip(cycles, cycles[1:]))
    assert cycles[-1] > cycles[0]
    assert all(b >= a for a, b in zip(col, col[1:]))
    assert all(abs(s - c) <= 1 for s, c in zip(scalar, col))
    assert all(0.5 <= pred / real <= 2.0 for pred, real in band)


@pytest.mark.parametrize("faulty", [0, 3, 12])
def test_admission_predictor_prices_degraded_array_as_the_reference(faulty):
    design = (32, 32, "butterfly-2", 16)
    jp = jadm.WaveLatencyPredictor(reduced(get_arch("granite-8b")), design,
                                   faulty_pods=faulty)
    tp = tadm.WaveLatencyPredictor(t_reduced(t_get_arch("granite-8b")),
                                   design, faulty_pods=faulty)
    for prompt, new in ((64, 32), (8, 1), (200, 16)):
        assert tp.model_seconds(prompt, new) == jp.model_seconds(prompt, new)
    healthy = tadm.WaveLatencyPredictor(t_reduced(t_get_arch("granite-8b")),
                                        design, faulty_pods=0)
    if faulty >= 12:
        assert tp.model_seconds(64, 32) > healthy.model_seconds(64, 32)
    for adm in (jadm, tadm):
        with pytest.raises(ValueError):
            adm.AdmissionConfig(design=design, faulty_pods=16)
        adm.AdmissionConfig(design=design, faulty_pods=3)
