"""What sets a dry-run cell's memory peak: the live tensors of rank 0 at
the peak of its full-depth step, traced as the dry-run traces it (fake
tensors over a fake group of 256 or 512 ranks, the production mesh),
grouped by the line of the port that made them, their shape and dtype:

    PYTHONPATH=src python scripts/dryrun_peak.py --arch yi-6b --shape train_4k
    ... [--multi-pod] [--top 12] [--device cpu]

Each line reads GiB, count, dtype, local shape and the innermost frame
of `repro_torch` (file:line function) that made the tensor; the step's
arguments (parameters, optimizer state, batch, cache) are one line. The
peak is the highest total this tracer saw (its storages, counted once;
within 64 MiB of it the live set is taken again), so it lands near
MemTracker's peak but is not held equal to it.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

_PKG = os.sep + "repro_torch" + os.sep
_SKIP = (os.sep + "parallel" + os.sep + "sharding.py",)
SNAP_STEP = 64 * 2 ** 20


def _site() -> str:
    """The innermost frame of the port's own code (not the sharding
    wrapper) on the Python stack."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if _PKG in name and not name.endswith(_SKIP):
            rel = name.split(_PKG, 1)[1]
            return f"{rel}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "(outside repro_torch)"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class PeakTracer(TorchDispatchMode):
    """The live storages of what runs under it (local ops: DTensor ops
    come back as local ones), with the site that made each, and the live
    set near the highest total."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, tuple] = {}
        self._refs: dict[int, weakref.ref] = {}
        self.current = self.peak = self._snapped = 0
        self.at_peak: list[tuple] = []

    def track(self, t: torch.Tensor, label: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        nb = st.nbytes()
        self.live[key] = (nb, label, tuple(t.shape), str(t.dtype))
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))
        self.current += nb
        if self.current > self.peak:
            self.peak = self.current
            if self.current >= self._snapped + SNAP_STEP or \
                    not self.at_peak:
                self._snapped = self.current
                self.at_peak = list(self.live.values())

    def _free(self, key: int) -> None:
        nb = self.live.pop(key)[0]
        self._refs.pop(key, None)
        self.current -= nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            site = None
            for t in _tensors(out):
                site = site or _site()
                self.track(t, site)
        return out


def trace(arch: str, shape: str, multi_pod: bool, device) -> PeakTracer:
    from torch._subclasses.fake_tensor import FakeTensorMode
    chips = 512 if multi_pod else 256
    with dryrun.fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        with FakeTensorMode(), dryrun._dtensor_patches():
            fn, args, _ = dryrun.build_cell(arch, shape, mesh, device=device)
            tracer = PeakTracer()
            for t in dryrun._local_tensors(args):
                tracer.track(t, "arguments")
            with tracer:
                fn(*args)
            return tracer


def report(tracer: PeakTracer, top: int) -> list[str]:
    groups: dict = collections.defaultdict(lambda: [0, 0])
    for nb, label, shape, dtype in tracer.at_peak:
        key = ("arguments", "", "") if label == "arguments" else \
            (label, dtype.replace("torch.", ""), str(list(shape)))
        groups[key][0] += nb
        groups[key][1] += 1
    rows = sorted(groups.items(), key=lambda kv: -kv[1][0])
    total = sum(nb for nb, *_ in tracer.at_peak)
    lines = [f"peak {tracer.peak / 2 ** 30:.2f} GiB; live set taken at "
             f"{total / 2 ** 30:.2f} GiB"]
    for (label, dtype, shape), (nb, n) in rows[:top]:
        lines.append(f"{nb / 2 ** 30:9.3f} GiB  x{n:<4d} {dtype:9s} "
                     f"{shape:24s} {label}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cpu",
                    help="device of the fake tensors: 'cpu' (default) or "
                         "the card")
    a = ap.parse_args(argv)
    tracer = trace(a.arch, a.shape, a.multi_pod, a.device)
    mesh = "multipod_2x16x16" if a.multi_pod else "pod_16x16"
    print(f"{a.arch} {a.shape} {mesh}")
    print("\n".join(report(tracer, a.top)))


if __name__ == "__main__":
    main()
