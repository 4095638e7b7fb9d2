# Copy of src/repro/core/interconnect.py (the port imports nothing of repro).
"""Interconnection networks for multi-pod accelerators (SOSA §3.2, Table 1).

Implements:
  * a *functional* Butterfly-k router — destination-bit routing with k
    parallel expansion planes (Fig 6) and exact edge-conflict detection, used
    by the scheduler to admit or reject a slice's pod<->bank permutation;
  * analytical models (latency in stages/cycles, mW per byte-per-cycle,
    bisection, switch cost) of Butterfly-k / Benes / Crossbar / Mesh / H-tree
    used by the energy model and the interconnect benchmarks.

Cost model: multistage networks are built from 2x2 switches; a message
traverses `stages` of them. We charge energy per byte per switch-stage
(E_SW_PJ_PER_BYTE, calibrated so Butterfly-1 at N=256 lands on Table 1's
0.23 mW/B and Benes on 0.92 mW/B) and a crossbar O(N) per-byte cost matching
7.36 mW/B at N=256.
"""

from __future__ import annotations

import dataclasses
import math
import random

import numpy as np

# Calibration: Table 1 (N = 256 pods).
#   Butterfly-1: log2(256) = 8 stages  -> 0.23 mW/B  => ~0.0288 mW/B/stage
#   Benes: 2*log2(256)-1 = 15 stages, + copy network (multicast, [38])
#          ~log2(256)=8 stages => 23 stages -> 0.92 mW/B? 23*0.0288=0.66.
#          Benes switches are *rearrangeable* (wider datapath control);
#          we charge 1.4x per stage for the control overhead -> 0.92.
E_SW_MW_PER_BYTE_STAGE = 0.23 / 8.0
BENES_STAGE_FACTOR = 1.4
CROSSBAR_MW_PER_BYTE_AT_256 = 7.36


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class IcnSpec:
    name: str
    stages: int              # one-way traversal depth (cycles at 1 switch/cyc)
    mw_per_byte: float       # per byte-per-cycle moved, Table 1 units
    bisection: float         # fraction of N full-rate flows sustainable
    full_permutation: bool   # can route any permutation without blocking
    multicast: bool


def butterfly_paths_conflict(n_bits: int, s1: int, d1: int, s2: int, d2: int) -> bool:
    """Do the unique butterfly paths (s1->d1) and (s2->d2) share an edge?

    MSB-first destination routing: after stage t (t=1..n), the path of
    (s, d) sits at node whose label keeps s's low (n-t) bits and takes d's
    high t bits.  Two paths share the *edge into stage t* iff their node
    labels agree at both t-1 and t.
    """
    if (s1, d1) == (s2, d2):
        return True
    mask_all = (1 << n_bits) - 1
    for t in range(1, n_bits + 1):
        low = n_bits - t
        low_mask = (1 << low) - 1
        hi1 = (d1 >> low) << low
        hi2 = (d2 >> low) << low
        node1 = hi1 | (s1 & low_mask)
        node2 = hi2 | (s2 & low_mask)
        if node1 != node2:
            continue
        # same node entering stage t: they came along the same edge iff they
        # also coincided at stage t-1
        plow = low + 1
        plow_mask = (1 << plow) - 1 if plow <= n_bits else mask_all
        phi1 = (d1 >> plow) << plow if plow <= n_bits else 0
        phi2 = (d2 >> plow) << plow if plow <= n_bits else 0
        pnode1 = phi1 | (s1 & plow_mask)
        pnode2 = phi2 | (s2 & plow_mask)
        if pnode1 == pnode2:
            return True
    return False


class ButterflyRouter:
    """Butterfly-k (expansion-k) functional router over N = 2^n ports.

    Greedy plane assignment: each (src, dst) pair is placed on the first of
    the k planes where its unique path is edge-disjoint from paths already
    placed there. This is the paper's 'redundant switches and links
    facilitated by the expansion' (Fig 6): Butterfly-2 routes permutations a
    standard Butterfly cannot (e.g. the s3->d2 / s6->d3 example).
    """

    def __init__(self, num_ports: int, expansion: int = 2):
        if not _is_pow2(num_ports):
            raise ValueError(f"butterfly needs power-of-two ports, got {num_ports}")
        self.n = num_ports
        self.n_bits = int(math.log2(num_ports))
        self.expansion = expansion

    def _edges(self, s: int, d: int) -> list[tuple[int, int]]:
        """Edge list of the unique path as (stage, node-entering) labels."""
        out = []
        node_prev = s
        for t in range(1, self.n_bits + 1):
            low = self.n_bits - t
            node = ((d >> low) << low) | (s & ((1 << low) - 1))
            out.append((t, (node_prev << self.n_bits) | node))
            node_prev = node
        return out

    def new_planes(self) -> list[dict]:
        """Fresh per-plane edge-ownership state for try_place."""
        return [dict() for _ in range(self.expansion)]

    def try_place(self, planes: list[dict], s: int, d: int) -> bool:
        """Greedily commit (s -> d) to the first plane where its unique
        path is edge-disjoint from paths already placed there. Multicast
        (same src to many dsts) shares edges by definition (copies fork at
        switches), so identical-prefix edges from the same source do not
        conflict; distinct sources must be edge-disjoint. This one helper
        defines the placement semantics for both route() and the
        routed_fraction calibration (the scheduler's incremental probe/
        commit variant lives in scheduler._IncrementalButterfly)."""
        edges = self._edges(s, d)
        for plane in planes:
            if all(plane.get(e) in (None, s) for e in edges):
                for e in edges:
                    plane[e] = s
                return True
        return False

    def route(self, pairs: list[tuple[int, int]]) -> bool:
        """True iff all (src, dst) pairs route conflict-free on k planes."""
        planes = self.new_planes()
        return all(self.try_place(planes, s, d) for s, d in pairs)

    def spec(self) -> IcnSpec:
        return butterfly_spec(self.n, self.expansion)


def butterfly_spec(n: int, k: int) -> IcnSpec:
    stages = int(math.log2(n))
    return IcnSpec(
        name=f"butterfly-{k}",
        stages=stages,
        mw_per_byte=E_SW_MW_PER_BYTE_STAGE * stages * k,
        bisection=1.0 * k,
        full_permutation=False,  # k>=2 is near-full in practice (Table 1)
        multicast=k >= 2,
    )


def benes_spec(n: int, with_copy_network: bool = True) -> IcnSpec:
    """Benes (rearrangeably non-blocking); augmented with a copy network for
    multicast [38], at the price of extra stages (the paper's critique)."""
    stages = 2 * int(math.log2(n)) - 1
    if with_copy_network:
        stages += int(math.log2(n))
    return IcnSpec(
        name="benes",
        stages=stages,
        mw_per_byte=E_SW_MW_PER_BYTE_STAGE * BENES_STAGE_FACTOR * stages,
        bisection=1.0,
        full_permutation=True,
        multicast=with_copy_network,
    )


def crossbar_spec(n: int) -> IcnSpec:
    return IcnSpec(
        name="crossbar",
        stages=2,
        mw_per_byte=CROSSBAR_MW_PER_BYTE_AT_256 * (n / 256.0),
        bisection=1.0,
        full_permutation=True,
        multicast=True,
    )


def mesh_spec(n: int) -> IcnSpec:
    """2D mesh: sqrt(N) average hops, bisection sqrt(N)/N."""
    side = int(math.ceil(math.sqrt(n)))
    return IcnSpec(
        name="mesh",
        stages=side,                       # average-ish hop count
        mw_per_byte=E_SW_MW_PER_BYTE_STAGE * 2 * side,
        bisection=side / n,
        full_permutation=False,
        multicast=False,
    )


def htree_spec(n: int, replication: int = 1) -> IcnSpec:
    """H-tree: log-depth but root-bottlenecked (bisection 1/N per plane);
    scaled-up H-tree replicates it N times at N^2 cost (§3.2)."""
    stages = 2 * int(math.log2(n))
    return IcnSpec(
        name=f"htree-{replication}",
        stages=stages,
        mw_per_byte=E_SW_MW_PER_BYTE_STAGE * stages * replication,
        bisection=replication / n,
        full_permutation=False,
        multicast=True,
    )


def _floor_log2(n: np.ndarray) -> np.ndarray:
    """Exact floor(log2(n)) for positive int64 arrays (via frexp)."""
    _, e = np.frexp(np.asarray(n, dtype=np.int64).astype(np.float64))
    return (e - 1).astype(np.int64)


def icn_stage_mw_arrays(name: str, ports: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(stages, mW/byte-per-cycle) for one topology over an array of port
    counts — the vectorized counterpart of the *_spec constructors above,
    used by the batched DSE engine. Matches them element-for-element."""
    ports = np.asarray(ports, dtype=np.int64)
    if name.startswith("butterfly"):
        k = int(name.split("-")[1]) if "-" in name else 1
        stages = _floor_log2(ports)
        return stages, E_SW_MW_PER_BYTE_STAGE * stages * k
    if name == "benes":
        stages = (2 * _floor_log2(ports) - 1) + _floor_log2(ports)
        return stages, E_SW_MW_PER_BYTE_STAGE * BENES_STAGE_FACTOR * stages
    if name == "crossbar":
        stages = np.full_like(ports, 2)
        return stages, CROSSBAR_MW_PER_BYTE_AT_256 * (ports / 256.0)
    if name == "mesh":
        side = np.ceil(np.sqrt(ports)).astype(np.int64)
        return side, E_SW_MW_PER_BYTE_STAGE * 2 * side
    if name == "htree":  # 'htree-k' is rejected, as in the scalar path
        stages = 2 * _floor_log2(ports)
        return stages, E_SW_MW_PER_BYTE_STAGE * stages.astype(np.float64)
    raise ValueError(f"unknown interconnect: {name}")


def routed_fraction(kind: str, ports: int = 256, samples: int = 8,
                    candidates: int = 8, seed: int = 0) -> float:
    """Measured pod availability of a fabric under the scheduler's traffic.

    Greedily routes `samples` random full-permutation slices through the
    functional router, giving each source the same destination-search width the
    offline scheduler uses (`SliceScheduler` probes up to 8 pod candidates
    per op before bumping the slice). Returns the mean fraction of sources
    that found a conflict-free path — the functional counterpart of
    Table 1's busy-pods column, used to *calibrate* the analytical model's
    `_ICN_EFFICIENCY` instead of hardcoding the paper's ratio
    (simulator.icn_efficiency; regression-pinned to within 5% of Table 1
    in tests/test_tenancy.py).

    Full-permutation fabrics (Benes/Crossbar) route everything by
    construction and return 1.0 without sampling.
    """
    router = make_router(kind, ports)
    if isinstance(router, IdealRouter):
        return 1.0
    rng = random.Random(seed)
    total = 0.0
    for _ in range(samples):
        srcs = list(range(ports))
        dsts = list(range(ports))
        rng.shuffle(srcs)
        rng.shuffle(dsts)
        free = list(dsts)
        planes = router.new_planes()
        placed = 0
        for src in srcs:
            for a in range(min(candidates, len(free))):
                # same deterministic candidate rotation as the scheduler
                ci = (src + a * 37) % len(free)
                if router.try_place(planes, src, free[ci]):
                    free.pop(ci)
                    placed += 1
                    break
        total += placed / ports
    return total / samples


class IdealRouter:
    """Crossbar/Benes functional stand-in: admits any pod<->bank matching
    (both are full-permutation networks); used for Table 1 busy-pods."""

    def __init__(self, num_ports: int, spec: IcnSpec):
        self.n = num_ports
        self._spec = spec

    def route(self, pairs: list[tuple[int, int]]) -> bool:
        return True

    def spec(self) -> IcnSpec:
        return self._spec


def make_router(kind: str, num_ports: int):
    """Factory: 'butterfly-K' | 'benes' | 'crossbar'."""
    if kind.startswith("butterfly"):
        k = int(kind.split("-")[1]) if "-" in kind else 1
        return ButterflyRouter(num_ports, expansion=k)
    if kind == "benes":
        return IdealRouter(num_ports, benes_spec(num_ports))
    if kind == "crossbar":
        return IdealRouter(num_ports, crossbar_spec(num_ports))
    raise ValueError(f"unknown interconnect: {kind}")
