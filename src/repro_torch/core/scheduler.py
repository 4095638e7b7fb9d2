# Copy of src/repro/core/scheduler.py (the port imports nothing of repro).
"""SOSA offline scheduler (§4.2): tile ops -> (time slice, pod) assignments.

Faithful to the paper:
  * fixed time slices (the tile-op service time; r streaming cycles for the
    r x r partition, plus pipeline latency),
  * greedy earliest-slice placement in tile-op order,
  * three admission constraints per slice:
      (1) RAW dependencies between tile ops (psum chains, layer order),
      (2) single-ported SRAM banks — one tile per bank per network per slice,
          with *multicast* (many pods reading the same tile) allowed when the
          interconnect supports it,
      (3) the interconnect must route the slice's full bank<->pod pattern on
          each of the three networks (X, W, P) — checked with the functional
          Butterfly-k router (exact edge conflicts) or the ideal router for
          full-permutation fabrics (Benes / Crossbar).

Weight double buffering: the W tile for slice l is streamed during slice
l-1; we account its port/route in slice l, which applies identical pressure
shifted by one slice and keeps the search one-pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .interconnect import ButterflyRouter, IdealRouter, make_router
from .tiling import TileOp, TileOpGraph


class _IncrementalButterfly:
    """Incremental edge-conflict state for one butterfly plane set (a slice's
    network). probe() finds a feasible plane without mutating state;
    commit() applies it — so a failed multi-network admission leaves the
    slice untouched. O(log N) dict ops per attempt."""

    def __init__(self, router: ButterflyRouter):
        self.r = router
        self.planes: list[dict[tuple[int, int], int]] = [
            dict() for _ in range(router.expansion)
        ]

    def probe(self, s: int, d: int):
        edges = self.r._edges(s, d)
        for pi, plane in enumerate(self.planes):
            ok = True
            for e in edges:
                owner = plane.get(e)
                if owner is not None and owner != s:
                    ok = False
                    break
            if ok:
                return (pi, s, edges)
        return None

    def commit(self, plan) -> None:
        pi, s, edges = plan
        plane = self.planes[pi]
        for e in edges:
            plane[e] = s


class _IncrementalIdeal:
    def __init__(self, router: IdealRouter):
        pass

    def probe(self, s: int, d: int):
        return ()

    def commit(self, plan) -> None:
        pass


def _inc_router(router):
    if isinstance(router, ButterflyRouter):
        return _IncrementalButterfly(router)
    return _IncrementalIdeal(router)


@dataclasses.dataclass
class _SliceState:
    free_pods: list[int]                     # stack of available pod ids
    x_tile: dict[int, tuple]                 # bank -> tile key being read
    w_tile: dict[int, tuple]
    p_busy: set                              # banks with a psum access
    net_x: object = None
    net_w: object = None
    net_p: object = None


@dataclasses.dataclass
class Schedule:
    """Result: op -> (slice, pod), plus topology metadata for the metrics."""

    assignments: dict[int, tuple[int, int]]  # op_id -> (slice_idx, pod)
    num_slices: int
    num_pods: int
    slice_cycles: int                        # service cycles per slice
    routing_retries: int                     # slices skipped due to icn/banks

    def pods_busy_fraction(self) -> float:
        if self.num_slices == 0:
            return 0.0
        return len(self.assignments) / (self.num_slices * self.num_pods)


class SliceScheduler:
    def __init__(
        self,
        num_pods: int,
        array_rows: int,
        pipeline_latency: int,
        interconnect: str = "butterfly-2",
        num_banks: Optional[int] = None,
        faulty_pods: tuple[int, ...] = (),
    ):
        self.num_pods = num_pods
        self.num_banks = num_banks if num_banks is not None else num_pods
        # degraded-pod operation: dead pods are masked out of every slice's
        # free-pod pool (the fabric and bank count are physically unchanged,
        # so routing and ports keep full-machine geometry); busy/utilization
        # fractions keep the full-machine denominator.
        dead = set(faulty_pods)
        if any(p < 0 or p >= num_pods for p in dead):
            raise ValueError(f"faulty_pods {sorted(dead)} out of range "
                             f"for {num_pods} pods")
        self.healthy_pods = [p for p in range(num_pods) if p not in dead]
        if not self.healthy_pods:
            raise ValueError("all pods faulty: nothing to schedule onto")
        self.rows = array_rows
        # slice service time: r streaming cycles (the r x r partition makes
        # every full tile take exactly r cycles) + fill/drain latency.
        self.slice_cycles = array_rows + pipeline_latency
        self.icn_name = interconnect
        # routers are sized to max(pods, banks) ports (N-to-N fabric, §5)
        self.ports = max(self.num_pods, self.num_banks)
        # butterfly needs power-of-two ports
        p = 1
        while p < self.ports:
            p <<= 1
        self.ports = p
        self.router = make_router(interconnect, self.ports)

    def _new_slice(self) -> _SliceState:
        return _SliceState(
            free_pods=list(reversed(self.healthy_pods)),
            x_tile={}, w_tile={}, p_busy=set(),
            net_x=_inc_router(self.router),
            net_w=_inc_router(self.router),
            net_p=_inc_router(self.router),
        )

    def schedule(self, graph: TileOpGraph) -> Schedule:
        slices: list[_SliceState] = []
        placed: dict[int, tuple[int, int]] = {}
        retries = 0

        def ensure(l: int) -> _SliceState:
            while len(slices) <= l:
                slices.append(self._new_slice())
            return slices[l]

        for op in graph.ops:
            ready = 0
            for dep in op.depends_on:
                dslice = placed[dep][0]
                if dslice + 1 > ready:
                    ready = dslice + 1
            l = ready
            while True:
                st = ensure(l)
                # the paper's scheduler searches pod/bank combinations for
                # a routable assignment (§4.2); we try up to `search` pod
                # candidates, rotated by op id so destinations spread over
                # the butterfly's subtrees, before bumping the slice.
                placed_here = False
                search = min(8, len(st.free_pods))
                for a in range(search):
                    ci = (op.op_id + a * 37) % len(st.free_pods)
                    st.free_pods[-1], st.free_pods[ci] = \
                        st.free_pods[ci], st.free_pods[-1]
                    status = self._try_place(st, op)
                    if status == "ok":
                        pod = st.free_pods.pop()
                        placed[op.op_id] = (l, pod)
                        placed_here = True
                        break
                    if status == "bank":
                        break  # structural conflict: other pods won't help
                if placed_here:
                    break
                retries += 1
                l += 1

        return Schedule(
            assignments=placed,
            num_slices=len(slices),
            num_pods=self.num_pods,
            slice_cycles=self.slice_cycles,
            routing_retries=retries,
        )

    def _try_place(self, st: _SliceState, op: TileOp) -> str:
        """'ok' (committed), 'bank' (structural — retrying other pods is
        pointless), or 'route' (this pod's paths conflict)."""
        if not st.free_pods:
            return "bank"
        pod = st.free_pods[-1]

        xkey = (op.gemm_id, "x", op.i, op.j)
        wkey = (op.gemm_id, "w", op.j, op.l)

        # bank port checks (multicast: same tile from same bank is fine iff
        # the fabric multicasts; different tile on a single-ported bank is a
        # structural conflict)
        mc = getattr(self.router.spec(), "multicast", True)
        cur = st.x_tile.get(op.x_bank)
        if cur is not None and (cur != xkey or not mc):
            return "bank"
        curw = st.w_tile.get(op.w_bank)
        if curw is not None and (curw != wkey or not mc):
            return "bank"
        if op.p_bank in st.p_busy:
            return "bank"

        # interconnect admission: banks are sources on X/W, pods on P.
        # Multicast reuses the shared-prefix edges from the same source.
        # probe all three networks, commit only if all admit (no pollution).
        px = st.net_x.probe(op.x_bank % self.ports, pod % self.ports)
        if px is None:
            return "route"
        pw = st.net_w.probe(op.w_bank % self.ports, pod % self.ports)
        if pw is None:
            return "route"
        pp = st.net_p.probe(pod % self.ports, op.p_bank % self.ports)
        if pp is None:
            return "route"
        st.net_x.commit(px)
        st.net_w.commit(pw)
        st.net_p.commit(pp)

        st.x_tile[op.x_bank] = xkey
        st.w_tile[op.w_bank] = wkey
        st.p_busy.add(op.p_bank)
        return "ok"
