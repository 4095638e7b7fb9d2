# Copy of src/repro/tenancy/mix.py (the port imports nothing of repro).
"""Declarative tenant-mix construction (SOSA §6.1 multi-tenancy).

A `Tenant` is one inference stream: a GEMM trace (anything from
core/workloads.py, or a serving trace recorded off serve/engine.py via
tenancy/trace.py), replicated `replicas` times, optionally carrying a
latency SLO. A `TenantMix` is a set of tenants co-scheduled on one
accelerator; `TenantMix.merged()` re-bases the streams' GEMM ids with
`core.simulator.merge_workloads` so they stay dependency-disjoint and
interleave freely — the source of the paper's Fig-11 gain.

`mix_grid` builds a whole design-space axis of mixes (workload suite x
batch x replicas x SLO), and `pack_mixes` packs their merged co-schedules
into one `PackedWorkloads`, so an entire (designs x tenant-mixes) grid is
ONE `analyze_batch` call (see tenancy/planner.py; the scalar
`merge_workloads` + `analyze` path stays as the oracle in
tests/test_tenancy.py and benchmarks/multitenancy.py).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable

import numpy as np

from ..core.simulator import PackedWorkloads, merge_workloads, pack_workloads
from ..core.tiling import GemmSpec, gemm_levels


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One co-scheduled inference stream (workload + QoS envelope)."""

    name: str
    gemms: tuple[GemmSpec, ...]
    replicas: int = 1                      # identical streams co-scheduled
    slo_latency_s: float | None = None     # per-inference latency target

    def __post_init__(self):
        if not self.gemms:
            raise ValueError(f"tenant {self.name!r} has an empty trace")
        if self.replicas < 1:
            raise ValueError(f"tenant {self.name!r}: replicas must be >= 1")

    @property
    def macs(self) -> int:
        """Total MACs of all replica streams (space-share partition weight)."""
        return self.replicas * sum(g.macs for g in self.gemms)

    @property
    def depth(self) -> int:
        """Topological depth of one stream (levels occupied in a merge —
        disjoint streams all start at level 0, see gemm_levels)."""
        return int(gemm_levels(list(self.gemms)).max()) + 1

    def streams(self) -> list[list[GemmSpec]]:
        return [list(self.gemms) for _ in range(self.replicas)]


@dataclasses.dataclass(frozen=True)
class TenantMix:
    """A named set of tenants sharing one accelerator."""

    name: str
    tenants: tuple[Tenant, ...]

    def __post_init__(self):
        if not self.tenants:
            raise ValueError(f"mix {self.name!r} has no tenants")

    @property
    def num_streams(self) -> int:
        return sum(t.replicas for t in self.tenants)

    @property
    def total_macs(self) -> int:
        return sum(t.macs for t in self.tenants)

    def merged(self) -> list[GemmSpec]:
        """The co-schedule: all replica streams merged dependency-disjoint."""
        streams: list[list[GemmSpec]] = []
        for t in self.tenants:
            streams.extend(t.streams())
        return merge_workloads(*streams)


def tenant(name: str, gemms: Iterable[GemmSpec], replicas: int = 1,
           slo_latency_s: float | None = None) -> Tenant:
    """Convenience constructor accepting any GemmSpec iterable."""
    return Tenant(name=name, gemms=tuple(gemms), replicas=replicas,
                  slo_latency_s=slo_latency_s)


def mix_grid(
    factories: dict[str, Callable[[int], list[GemmSpec]]],
    batches: tuple[int, ...] = (1,),
    replicas: tuple[int, ...] = (1,),
    pair_size: int = 2,
    slo_latency_s: float | None = None,
) -> list[TenantMix]:
    """The tenant-mix design-space axis: every `pair_size`-combination of
    the named workloads, at every batch and replica count.

    `factories` maps workload name -> (batch -> GemmSpec list), e.g.
    ``{"resnet50": lambda b: resnet(50, 224, batch=b), ...}``. All tenants
    of a mix share the batch/replica/SLO setting — per-tenant asymmetry is
    expressed by constructing TenantMix directly.
    """
    names = sorted(factories)
    if pair_size > len(names):
        raise ValueError(f"pair_size {pair_size} > {len(names)} workloads")
    mixes: list[TenantMix] = []
    for combo in itertools.combinations(names, pair_size):
        for b in batches:
            for r in replicas:
                # tenant names carry the batch — a tenant name must denote
                # ONE trace across all mixes (solo_workloads relies on it)
                ts = tuple(
                    Tenant(name=f"{n}@b{b}", gemms=tuple(factories[n](b)),
                           replicas=r, slo_latency_s=slo_latency_s)
                    for n in combo
                )
                tag = "+".join(combo)
                mixes.append(TenantMix(name=f"{tag}@b{b}x{r}", tenants=ts))
    return mixes


def pack_mixes(mixes: list[TenantMix]) -> PackedWorkloads:
    """Merged co-schedules of all mixes as one PackedWorkloads — the
    tenant-mix axis of the batched (designs x mixes) grid."""
    seen: set[str] = set()
    for m in mixes:
        if m.name in seen:
            raise ValueError(f"duplicate mix name {m.name!r}")
        seen.add(m.name)
    return pack_workloads({m.name: m.merged() for m in mixes})


def solo_workloads(mixes: list[TenantMix]) -> dict[str, list[GemmSpec]]:
    """Each distinct tenant's single-stream trace, keyed by tenant name —
    the solo baselines the planner needs for slowdown / sequential
    comparisons (packed alongside the mixes, still one analyze_batch)."""
    out: dict[str, list[GemmSpec]] = {}
    for m in mixes:
        for t in m.tenants:
            if t.name not in out:
                out[t.name] = list(t.gemms)
            else:
                prev = out[t.name]
                if len(prev) != len(t.gemms) or any(
                        (a.d1, a.d2, a.d3, a.gemm_id, a.depends_on)
                        != (b.d1, b.d2, b.d3, b.gemm_id, b.depends_on)
                        for a, b in zip(prev, t.gemms)):
                    raise ValueError(
                        f"tenant name {t.name!r} reused with a different "
                        "trace across mixes")
    return out


def tenant_depths(mix: TenantMix) -> np.ndarray:
    """(num_streams,) merged-trace completion level per replica stream, in
    merge order. Disjoint streams each start at level 0 of the merged
    co-schedule, so a stream completes when its own deepest level drains."""
    return np.array(
        [t.depth for t in mix.tenants for _ in range(t.replicas)],
        dtype=np.int64)
