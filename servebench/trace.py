"""The device trace of a `--trace 1` run: torch.profiler over the traced
steps, its Chrome trace read back, and the sums the readers need.

Device operations are the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
events. The device is busy for the union of their intervals, so two
kernels that overlap count once. An idle gap is named by what the host
was doing at its middle: the shortest host event (an operator, a CUDA
runtime call, or one of the harness's annotations) that covers it.
"""

from __future__ import annotations

import heapq
import dataclasses
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


@dataclasses.dataclass
class Op:
    name: str
    ts: float          # microseconds, the trace's clock
    dur: float
    cat: str
    grid: tuple = ()


class Profiler:
    """torch.profiler of CPU and CUDA activity, started and stopped by the
    load loop; `annotate(name)` marks a host region in the trace."""

    def __init__(self, path: Path, device):
        import torch
        self.path = path
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None

    def _sync(self) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        self._sync()
        self.prof.stop()

    def annotate(self, name: str):
        from torch.profiler import record_function
        return record_function(name)

    def export(self) -> Path:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        return self.path


def read(path: Path) -> tuple[list[Op], list[Op]]:
    """(device ops, host events) of a Chrome trace, each sorted by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            grid = tuple((e.get("args") or {}).get("grid") or ())
            dev.append(Op(e["name"], float(e["ts"]), float(e["dur"]), cat,
                          grid))
        elif cat in HOST_CATS:
            host.append(Op(e["name"], float(e["ts"]), float(e["dur"]), cat))
    dev.sort(key=lambda o: o.ts)
    host.sort(key=lambda o: o.ts)
    return dev, host


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(ops: list[Op]) -> float:
    return sum(b - a for a, b in union((o.ts, o.ts + o.dur) for o in ops))


def idle_gaps(ops: list[Op]) -> list[tuple[float, float]]:
    """The gaps between the busy intervals of `ops`, longest first."""
    u = union((o.ts, o.ts + o.dur) for o in ops)
    gaps = [(u[i][1], u[i + 1][0]) for i in range(len(u) - 1)]
    return sorted(gaps, key=lambda g: g[0] - g[1])


def host_at(host: list[Op], times: list[float]) -> list[str]:
    """For each time, the name of the shortest host event that covers it
    (one sweep over the events sorted by start; `host` is sorted so)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = ["(no host event)"] * len(times)
    heap: list = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(host) and host[j].ts <= t:
            o = host[j]
            heapq.heappush(heap, (o.dur, j, o.ts + o.dur, o.name))
            j += 1
        while heap and heap[0][2] < t:
            heapq.heappop(heap)
        if heap:
            out[i] = heap[0][3]
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list: `gemm_bf16_splitk<1, 128, false, __nv_bfloat16>`."""
    s = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(s)
    for i, c in enumerate(s):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            cut = i
            break
    s = s[:cut]
    if s.startswith("void "):
        s = s[5:]
    depth, start = 0, 0
    for i, c in enumerate(s):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == ":" and depth == 0:
            start = i + 1
    return s[start:].strip()[:120]


def breakdown(dev: list[Op], host: list[Op], top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, in seconds."""
    by_name: dict[str, float] = {}
    for o in dev:
        k = short_name(o.name)
        by_name[k] = by_name.get(k, 0.0) + o.dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps_by: dict[str, float] = {}
    gaps = idle_gaps(dev)
    for (a, b), k in zip(gaps, host_at(host, [(a + b) / 2
                                              for a, b in gaps])):
        gaps_by[k] = gaps_by.get(k, 0.0) + (b - a) / 1e6
    named = sorted(gaps_by.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in named]}
