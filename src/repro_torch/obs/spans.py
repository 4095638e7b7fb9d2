"""Timed regions inside the serve engine's step runners (the port's own
module: the reference has no counterpart, and `obs/__init__.py` does not
export it).

`region(name)` marks a stretch of model code whose time a tracing serve
engine reports: decode attention in `models/transformer.py::apply_gqa`.
It does nothing unless a `RegionRecorder` is current, and only a serve
engine whose tracer asks for detail (serve/engine.py) makes one current,
around its runner calls. Training, the dry run's fake tensors and DTensor
never meet a recorder, and an engine that does not trace records nothing
and puts no event into any graph.

On the card a region records a pair of `torch.cuda.Event(enable_timing=
True, external=True)` on the current stream. Under stream capture the two
become event-record nodes of the graph, so every replay records them
again: a runner keeps the pairs its capture recorded and hands them to the
current recorder at each replay (serve/graphs.py). Once the host has read
the call's output the device has passed every end event, so `elapsed_ms`
reads their times without another sync, one driver call a pair
(`cuEventElapsedTime`; torch's `Event.elapsed_time` also queries both
events, three calls a pair). On the CPU a region reads the recorder's
clock (the engine's) at its two ends.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
from typing import Callable

import torch

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_region_recorder", default=None)
_NOTHING = contextlib.nullcontext()


class RegionRecorder:
    """Collects `(name, start, end)` of the regions entered while it is
    current: CUDA events on the card, `clock()` readings elsewhere."""

    def __init__(self, device, clock: Callable[[], float]):
        self.cuda = torch.device(device).type == "cuda"
        self.clock = clock
        self.pairs: list[tuple] = []

    def region(self, name: str) -> "_Region":
        return _Region(self, name)

    @contextlib.contextmanager
    def recording(self):
        """Make this recorder current for the block."""
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)

    def take(self) -> list[tuple]:
        """The pairs recorded since the last take, and forget them."""
        pairs, self.pairs = self.pairs, []
        return pairs


class _Region:
    __slots__ = ("rec", "name", "start")

    def __init__(self, rec: RegionRecorder, name: str):
        self.rec, self.name = rec, name

    def _stamp(self):
        if not self.rec.cuda:
            return self.rec.clock()
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    def __enter__(self):
        self.start = self._stamp()
        return self

    def __exit__(self, *exc):
        self.rec.pairs.append((self.name, self.start, self._stamp()))
        return False


def region(name: str):
    """A timed region under the current recorder; a null context when none
    is current."""
    rec = _CURRENT.get()
    return _NOTHING if rec is None else rec.region(name)


def current() -> RegionRecorder | None:
    return _CURRENT.get()


def replayed(pairs: list[tuple]) -> None:
    """A graph replay recorded `pairs` (its capture's) again: hand them to
    the current recorder, if any."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.pairs.extend(pairs)


@functools.cache
def _event_elapsed():
    """The CUDA driver's cuEventElapsedTime (a runtime event is a driver
    event)."""
    fn = ctypes.CDLL("libcuda.so.1").cuEventElapsedTime
    fn.argtypes = (ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                   ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return fn


def elapsed_ms(pairs: list[tuple]) -> float:
    """Milliseconds inside the regions `pairs`, summed: device time between
    each pair of events, which the device must have passed, or the clock's
    seconds between its readings."""
    total, ms = 0.0, ctypes.c_float()
    for _, a, b in pairs:
        if not isinstance(a, torch.cuda.Event):
            total += 1e3 * (b - a)
            continue
        err = _event_elapsed()(ctypes.byref(ms), a.cuda_event, b.cuda_event)
        if err:
            raise RuntimeError(f"cuEventElapsedTime failed: CUresult {err}")
        total += ms.value
    return total
