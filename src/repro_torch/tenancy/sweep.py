# Copy of src/repro/tenancy/sweep.py (the port imports nothing of repro).
"""Batched multi-tenancy sweeps (SOSA Fig 11 / §6.1 + tenant-mix DSE).

Two entry points, both riding the batched planner (tenancy/planner.py —
one `analyze_batch` call per policy over the whole grid):

  * `fig11_sweep` — the paper's co-scheduling experiment: ResNet + BERT
    merged vs back-to-back sequential across batch sizes and pod counts.
    The paper reports a 1.44x parallel-over-sequential gain on 256 pods
    (Fig 11); `TenancyPlan.parallel_gain` is that metric per cell.

  * `mix_dse` — tenant mixes as first-class design-space axes: for every
    mix in a `mix_grid`, find the pod granularity that maximizes
    co-scheduled effective TOPS @TDP (the multi-tenant counterpart of the
    Fig-5 single-tenancy sweep in core/dse.py).

benchmarks/multitenancy.py (Fig-11 numbers + slice-accurate oracle) and
benchmarks/tenancy.py (the mix DSE) print these as metric rows.
"""

from __future__ import annotations

from ..core.dse import Design
from ..core.workloads import (bert, densenet, inception_v3, resnet)
from .mix import Tenant, TenantMix, mix_grid
from .planner import TIME_MUX, TenancyPlan, plan_mixes

# the paper's Fig-11 pairing: a pod-saturating CNN stream co-scheduled
# with pod-starved BERT streams (replicas=2: two tenant request streams —
# BERT at batch 1 strands most of the pods, so a second stream is free)
_FIG11_PAIR = (
    ("resnet50", lambda b: resnet(50, 224, batch=b), 1),
    ("bert-medium", lambda b: bert("medium", 100, batch=b), 2),
)


def fig11_mixes(batches: tuple[int, ...] = (1, 2, 4, 8)) -> list[TenantMix]:
    """ResNet-50 + 2x BERT-medium co-schedules, one mix per batch size.
    The gain over sequential shrinks as batch grows — batching alone also
    recovers utilization — which is Fig 11's batch-scaling story."""
    return [
        TenantMix(
            name=f"resnet50+bert-medium@b{b}",
            tenants=tuple(Tenant(name=f"{n}@b{b}", gemms=tuple(f(b)),
                                 replicas=r)
                          for n, f, r in _FIG11_PAIR))
        for b in batches
    ]


def fig11_sweep(
    pods: tuple[int, ...] = (128, 256),
    batches: tuple[int, ...] = (1, 2, 4, 8),
    policy: str = TIME_MUX,
    tdp: float = 400.0,
) -> list[list[TenancyPlan]]:
    """The batched Fig-11 grid on the paper's 32x32 pod: plans indexed
    [pod-count][batch], `parallel_gain` being the figure's headline."""
    designs: list[Design] = [(32, 32, "butterfly-2", p) for p in pods]
    return plan_mixes(fig11_mixes(batches), designs, policy, tdp)


# granularities from the paper's Fig-5/Table-2 candidate set; isopower pod
# counts (None -> largest power of two under TDP, as everywhere else)
_DSE_GRAN = ((16, 16), (20, 20), (32, 32), (48, 48),
             (64, 64), (128, 128), (256, 256), (512, 512))


def dse_designs(interconnect: str = "butterfly-2") -> list[Design]:
    return [(r, c, interconnect, None) for r, c in _DSE_GRAN]


def default_mixes(batches: tuple[int, ...] = (1,)) -> list[TenantMix]:
    """All pairs over a 5-workload suite (10 mixes at batch 1) — the
    tenant-mix axis for the DSE grid."""
    factories = {
        "resnet50": lambda b: resnet(50, 224, batch=b),
        "densenet121": lambda b: densenet(121, 224, batch=b),
        "inception-v3": lambda b: inception_v3(299, batch=b),
        "bert-medium": lambda b: bert("medium", 100, batch=b),
        "bert-large": lambda b: bert("large", 100, batch=b),
    }
    return mix_grid(factories, batches=batches, pair_size=2)


def mix_dse(
    mixes: list[TenantMix] | None = None,
    designs: list[Design] | None = None,
    policy: str = TIME_MUX,
    tdp: float = 400.0,
) -> dict[str, TenancyPlan]:
    """Best pod granularity per tenant mix (co-scheduled effective TOPS
    @TDP): the whole (designs x mixes) grid is one planner call; returns
    mix name -> winning plan."""
    mixes = default_mixes() if mixes is None else mixes
    designs = dse_designs() if designs is None else designs
    grid = plan_mixes(mixes, designs, policy, tdp)
    best: dict[str, TenancyPlan] = {}
    for row in grid:
        for plan in row:
            cur = best.get(plan.mix)
            if cur is None or plan.effective_tops_at_tdp > \
                    cur.effective_tops_at_tdp:
                best[plan.mix] = plan
    return best
