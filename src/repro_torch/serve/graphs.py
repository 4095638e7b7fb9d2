"""Step runners: the serve engine's compiled-step cache (counterpart of
the `jax.jit` caches of repro/serve/engine.py).

A `StepRunner` is one shape of one step (a prefill bucket, a decode chunk
length). It owns static input buffers, the static outputs of its body (a
Python callable over those buffers) and, on the card, one
`torch.cuda.CUDAGraph`. The caller copies a call's inputs into the buffers
in place; the body reads nothing else that changes between calls, except
state that is itself updated in place (the engine's caches, the page
table).

On the card the first call of a runner is its warm-up: the body runs
eagerly on the engine's capture stream (this is the call's real work, and
it sizes every kernel workspace for the shape), then the same body is
captured into the graph, which does not run it. Every later call replays
the graph. A capture that fails raises; nothing falls back to eager. On
the CPU (the tests) and without a pool (the engine's eager option) every
call runs the body eagerly through the same buffers, so the CPU tests
exercise exactly the code that is captured.

Four rules keep a replay equal to an eager call:

* Memory. All graphs of an engine share one pool (`GraphPool`): each
  replay's outputs are read at the host sync that follows it, before
  another graph runs, so no graph needs another's memory to survive.
* Workspaces. The pod GEMM's split-K scratch and the SSD workspace grow
  by replacing their tensor; their wrappers raise if that would happen
  during a capture, and a runner keeps a reference to the workspaces it
  captured, so a later, larger warm-up cannot free them under it.
* Launch counts. The kernel wrappers count their Python calls, which a
  replay does not make: the runner records each counter's change during
  capture, takes it back, and adds it on every replay, so the counts read
  as if every call ran eagerly.
* No graph dies during a capture. Destroying a graph (or freeing its
  pool) while another is captured invalidates that capture, so the cycle
  collector is paused during each capture; an engine holds no cycle, so
  one that is dropped frees its graphs at once (serve/engine.py).
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Optional

import torch

from ..kernels.flash_attention.flash_attention import flash_attention_cuda
from ..kernels.ssd import ssd as ssd_mod
from ..kernels.systolic_gemm import systolic_gemm as sg
from ..obs import spans

# the kernel wrappers whose `launches` / `mainloop_launches` a replay moves
COUNTED = (sg.systolic_gemm_cuda, sg.systolic_gemm_nt_cuda,
           sg.grouped_systolic_gemm_cuda, flash_attention_cuda,
           ssd_mod.ssd_cuda)


def launch_counts() -> list[tuple[int, dict]]:
    """Every counted wrapper's (launches, mainloop_launches), copied."""
    return [(f.launches, dict(f.mainloop_launches)) for f in COUNTED]


def _counts_since(before: list[tuple[int, dict]]) -> list[tuple[int, dict]]:
    return [(f.launches - n, {k: v - m.get(k, 0)
                              for k, v in f.mainloop_launches.items()})
            for f, (n, m) in zip(COUNTED, before)]


def _add_counts(delta: list[tuple[int, dict]], sign: int = 1) -> None:
    for f, (n, m) in zip(COUNTED, delta):
        f.launches += sign * n
        for k, v in m.items():
            f.mainloop_launches[k] += sign * v


class GraphPool:
    """What an engine's graphs share on one CUDA device: one memory pool,
    one capture stream (warm-ups run there too, so cuBLAS meets the same
    stream and workspace at warm-up and at capture), the graphs' count
    and the seconds their warm-up calls and captures took."""

    def __init__(self, device: torch.device):
        # the kernel wrappers key their workspaces by a tensor's device,
        # which names its index ("cuda:0"); an engine's device may not
        # ("cuda"), and under that key a runner would find no workspace
        # to keep alive, and a later growth would free one its graph uses
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs = 0
        self.capture_s = 0.0

    def held_bytes(self) -> int:
        """Device bytes the pool's segments hold now (its graphs' outputs
        and intermediates, shared across graphs)."""
        pool = tuple(self.handle)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


class StepRunner:
    """One shape's step: `body(**inputs)` over static input buffers.

    `inputs` are the buffers, allocated by the caller on the step's device
    (outside any pool). `pool` is the engine's GraphPool on the card, or
    None to run every call eagerly (the CPU, or the engine's eager
    option). `name` is the runner's key in the engine's spans
    (`decode_chunk8`).

    A capture made while a region recorder is current (obs/spans.py) keeps
    the regions it recorded, whose events are nodes of the graph, and each
    replay hands them to the recorder current then."""

    def __init__(self, body: Callable[..., Any], inputs: dict,
                 pool: Optional[GraphPool] = None, name: str = ""):
        self.body = body
        self.inputs = inputs
        self.pool = pool
        self.name = name
        self.regions: list[tuple] = []
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        self._delta: list[tuple[int, dict]] = []
        self._held: tuple = ()
        # wall seconds of the warm-up call, the capture and the graph's
        # instantiation (torch.cuda.graph instantiates on exit)
        self.seconds: dict[str, float] = {}

    @property
    def captures(self) -> bool:
        """True when the next call warms up and captures."""
        return self.pool is not None and self.graph is None

    def __call__(self, **feed) -> Any:
        """`load(**feed)`, then `launch()`."""
        self.load(**feed)
        return self.launch()

    def load(self, **feed) -> None:
        """Copy `feed` (host arrays or tensors) into the static buffers of
        the same names, in place."""
        for name, value in feed.items():
            buf = self.inputs[name]
            buf.copy_(torch.as_tensor(value).to(buf.dtype))

    def launch(self) -> Any:
        """Run the step over the static buffers: eagerly, as warm-up and
        capture, or as a replay. Returns the body's outputs (the static
        ones on a replay: read them before the next call)."""
        if self.graph is not None:
            self.graph.replay()
            _add_counts(self._delta)
            if self.regions:
                spans.replayed(self.regions)
            return self.out
        if self.pool is None:
            return self.body(**self.inputs)
        return self._warm_up_and_capture()

    def _warm_up_and_capture(self) -> Any:
        pool = self.pool
        t0 = time.perf_counter()
        side, main = pool.stream, torch.cuda.current_stream(pool.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.body(**self.inputs)       # the call's real work
        main.wait_stream(side)
        torch.cuda.synchronize(pool.device)
        t1 = time.perf_counter()
        before = launch_counts()
        rec = spans.current()
        warm = len(rec.pairs) if rec is not None else 0
        graph = torch.cuda.CUDAGraph()
        # destroying a graph while another is captured invalidates the
        # capture: no collection of unreachable ones runs during it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool.handle, stream=side):
                self.out = self.body(**self.inputs)
                t2 = time.perf_counter()
        finally:
            if collecting:
                gc.enable()
        self._delta = _counts_since(before)
        _add_counts(self._delta, -1)             # capture launched nothing
        if rec is not None:
            # the capture's regions have not run: the graph's, not the call's
            self.regions = rec.pairs[warm:]
            del rec.pairs[warm:]
        # the workspaces this graph writes stay alive with it
        self._held = (sg.workspaces(pool.device) +
                      ssd_mod.workspaces(pool.device))
        self.graph = graph
        t3 = time.perf_counter()
        self.seconds = {"warm_up": t1 - t0, "capture": t2 - t1,
                        "instantiate": t3 - t2}
        pool.graphs += 1
        pool.capture_s += t3 - t0
        return out
