"""Batched serving engine (counterpart of repro/serve/engine.py with its
serving controls: admission policies, deadlines, chaos with retries,
metrics and the tracer; paging optional; the SDC guard optional).

The engine owns a fixed decode batch of `slots` lanes; requests queue,
prefill into free slots, and decode step-locked with the rest of the batch.

  * Bucketed prefill: prompts are right-padded to power-of-two buckets and
    queued requests of the head request's bucket share ONE prefill over a
    fixed [slots, bucket] batch. Padding is inert for the dense KV cache:
    causal masking keeps padded keys out of real rows, and the length
    fixup masks the padded cache slots until decode overwrites them. The
    SSM state takes the per-lane true lengths (dt-masked updates, a conv
    window gathered at the true length), and so does a sliding-window ring
    cache (each lane's last-window real tokens gathered into their ring
    slots), so padding is inert there too.
  * Exact-length prefill, for the families whose prefill padding is not
    inert (`Model.bucketed_prefill_ok` False: MoE, where padding tokens
    would take expert capacity from real ones, and the encoder-decoder
    and vision-language families, whose prompts carry frames or image
    embeddings), for every request with `extras`
    (per-request inputs that cannot join a shared bucket batch), or with
    prefill_buckets=False: one request per prefill, [1, S], into a fresh
    1-lane cache that is then copied into its slot. `bucketed` says which
    path an engine takes.
  * Encoder-decoder (whisper): `Request.extras` {"frames": [1, S_src,
    d_model]} is merged into the request's prefill batch, whose forward
    runs the encoder and writes each decoder layer's cross K/V into the
    lane cache (`src_len` rows: the engine's CrossKV width); the lane is
    then copied whole into its slot. Decode reads the cross K/V from the
    engine's static cache and runs no encoder, so a captured decode chunk
    reads them without a host copy. A paged engine refuses extras at
    submit.
  * Vision-language (llama-3.2-vision): `Request.extras` {"image_embeds":
    [1, n_image_tokens, d_model]} goes the same way: the prefill's
    forward adapts them (`img_adapter`) and writes every cross layer's
    K/V into the lane cache, whose CrossKV is n_image_tokens rows wide
    (`src_len` 0); the vlm's cache is flat (Model.init_cache), so the
    lane helpers below walk it as every other family's.
  * Fused decode: a chunk of n decode steps runs as a Python loop whose
    tokens, positions, budgets and alive masks stay on the device; nothing
    is read back inside the loop. A lane whose budget runs out keeps
    decoding inertly until the chunk ends. Chunk lengths are floored to
    powers of two.
  * Host syncs: exactly one counted read (runtime.to_host) per prefill
    group (one request, exact-length) and one per decode chunk.
  * Compiled steps (serve/graphs.py, the counterpart of the reference's
    jit caches): every bucketed prefill runs through one StepRunner per
    bucket and every decode chunk through one per chunk length. On the
    card each runner captures one CUDA graph at its first call and replays
    it after; the host copies a call's tokens, lengths, slots, positions,
    budgets and alive mask into the runner's static buffers first. The
    prefill's transient lane cache is static too, one per bucket, and the
    graph resets it before use; the lanes reach their slots through a
    device slot tensor (-1: pad lane), so nothing of a group is baked into
    a graph. Exact-length prefill stays eager (one shape per prompt
    length). `eager=True` runs the same runners eagerly on the card.
  * Paging (paged=True): the KV cache is a PagedKVCache over a shared pool
    of kv_pages pages, allocated host-side by serve/paging.PagePool at the
    syncs the engine already has. A request is admitted only when its
    worst-case page count reserves (else it waits queued; one larger than
    the whole pool is rejected `pages-exhausted` at submit); prefill runs
    over a dense transient lane cache and scatters whole pages into the
    pool; the transient spans only the bucket's pages, so a prefill
    allocates [slots, bucket] lanes, not [slots, max_len]. Each decode
    chunk maps the pages its appends reach and pushes the page table
    host->device when it changed. Every way a lane ends returns its pages
    (_release_slot). In-chunk recycling (on by default when paged) re-runs
    admission at the chunk's own sync, so a lane that died mid-chunk is
    handed to queued work without an idle chunk. Paging adds no host
    sync. SSM state and ring caches are fixed-size per lane and stay
    lane-resident: nothing of them is paged (paged_kv_stats reports them
    as resident_lane_bytes), and the transient's rings have the engine's
    width.

Overload and failure (serve/admission.py, serve/chaos.py), as in the
reference: every submitted request reaches exactly one terminal state,
`done`, `rejected` or `expired`; malformed requests raise InvalidRequest
at submit. `admission=` picks the policy (fifo, edf or slo-aware: deadline
order, a bounded queue, the wave model's predicted misses shed, budgets
degraded under overload); deadlines expire at the chunk's existing host
sync. `chaos=` injects a seeded fault schedule at the device-call
boundary (_device_call): a transient fault retries with exponential
backoff on the engine's clock, and retries exhausted reject the call's
requests `device-fault` with their slots and pages freed; an EWMA
slow-chunk detector halves the next chunk while the device is slow.
`metrics=` (obs.metrics) and `tracer=` (tenancy.ServeTraceRecorder) read
only what the chunk's one packed read already brought back: they add no
host sync, no runner and no graph.

A tracer that defines `on_span` and sets `detail = True` asks for more
(ServeTraceRecorder does not, and sees what the reference's engine gives):
  * each span the engine emits (prefill/bucket{b}, prefill/exact{S},
    decode/chunk{n}) is also a torch.profiler `record_function` range
    around its work, so a device trace taken meanwhile holds the engine's
    spans on its own clock;
  * child spans, category "serve", each both a profiler range and an
    on_span span with its parent's name in `parent`: serve.step (one
    step(), the root), serve.admit (the whole of _admit; args the queue
    length at entry and the requests admitted), serve.copy_in (a call's
    feed into its runner's static buffers, or the exact-length prefill's
    lane cache and batch), serve.launch (a graph replay or the eager
    body's enqueue; args the runner's key, `decode_chunk8`),
    serve.capture/<key> (a call that warms up and captures, in place of
    serve.launch; args StepRunner.seconds), serve.read (to_host: the host
    waiting on the device) and serve.retire (everything after a decode
    chunk's read, in-chunk recycling included);
  * one serve.queue span per admitted request (args its rid; parent the
    prefill that serves it) from its submit stamp to the start of that
    prefill, emitted when the wait ends: an on_span span only, since it
    spans steps;
  * decode attention timed inside the runners (obs/spans.py, the region
    around apply_gqa's decode branch): each decode/chunk{n} span carries
    attention_ms (over the chunk's n steps: device time on the card, the
    engine's clock on the CPU) and attention_regions, read after the
    chunk's one host read, with no sync of their own.
Any other tracer, and tracer=None, gets none of it: no range is opened, no
region recorded and no event captured in any graph, and the hot paths
test one boolean.

The SDC guard (`guard=`, kernels/systolic_gemm/guard.py), as in the
reference: under "probe" or "abft" every bucketed prefill forward and
every decode step runs under its own GuardTape, so each pod GEMM of the
model is verified (abft repairs a single corrupted element) inside the
captured graph; each runner takes one more static input, the attempt's
injection plan `sdc` (chaos `p_sdc`; (-1, 0, 0) disarms), and packs
(corrected, uncorrected) after its outputs, so a call still makes one
host read. Uncorrected output raises SilentCorruption, which retries like
a transient fault; retries exhausted reject the group or the live lanes
`sdc-uncorrectable` and free their slots and pages. A decode chunk writes
the caches in place, so before each guarded decode call the engine copies
the state the chunk advances (every KV and ring length, the ring keys and
values, the SSM conv window and state) device to device, and restores it
before a retry; KV rows past a restored length are rewritten by the
retry. A prefill resets its transient lane cache and rewrites its slots,
so it needs no copy. The exact-length prefill stays outside the guard.
With guard "off" (the default) nothing of this runs: runners, their
inputs, the packed layout, graphs, launches and host syncs are those of
the unguarded engine. Spans, deadlines, backoff, the EWMAs
and the slo-aware calibration read the injectable `clock=`; `stats` stays
real wall seconds. With the defaults (fifo, unbounded queue, no deadlines,
no chaos, no metrics, no tracer) tokens, host syncs and runners are those
of the engine without controls.

The caches are updated in place. A dead lane keeps decoding inertly to
the end of its chunk; its KV or SSM state is overwritten by the lane's
next prefill.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..kernels.systolic_gemm.guard import GuardTape, as_guard
from ..models.attention import KVCache, PagedKVCache, RingKVCache
from ..models.model import CrossKV, Model
from ..models.ssm import SSMCache
from ..models.transformer import MLACache
from ..obs import spans
from ..runtime import to_host
from ..train.fault import Ewma
from .admission import (AdmissionConfig, AdmissionController,  # noqa: F401
                        InvalidRequest, NEW, SLO_AWARE, ServeStalled,
                        WaveLatencyPredictor)
from .chaos import (FaultInjector, NumericalFault, PermanentFault,
                    SilentCorruption, SlowChunkDetector,
                    TransientDeviceError, check_lanes_finite)
from .graphs import GraphPool, StepRunner
from .paging import PagePool

MIN_BUCKET = 8          # smallest prefill bucket (the reference's default)
_NOTHING = contextlib.nullcontext()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # extra prefill-batch arrays (batch axis included), e.g. whisper's
    # {"frames": [1, src_len, d_model]} or a vlm's {"image_embeds": [1,
    # n_image_tokens, d_model]}, merged into the prefill batch; a request
    # with extras always prefills exact-length
    extras: dict = dataclasses.field(default_factory=dict)
    # QoS envelope (serve/admission.py): deadline is seconds from submit
    # on the engine's clock; priority breaks deadline ties (lower = more
    # urgent). state walks new -> queued -> running -> one terminal state
    # (done | rejected | expired); reason says why a request was shed.
    deadline_s: Optional[float] = None
    priority: int = 0
    state: str = NEW
    reason: str = ""
    # stamped by the admission controller
    _seq: int = dataclasses.field(default=0, repr=False)
    _submit_t: float = dataclasses.field(default=0.0, repr=False)
    _admit_t: float = dataclasses.field(default=0.0, repr=False)
    _deadline: Optional[float] = dataclasses.field(default=None, repr=False)
    # runners built (prefill + decode) at admit time: a retire whose epoch
    # grew saw a warm-up (and, on the card, a graph capture) inside its
    # service wall, so its calibration sample is skipped
    _jit_epoch: int = dataclasses.field(default=-1, repr=False)

    @property
    def finished(self) -> bool:
        return self.state in ("done", "rejected", "expired")


def _fix_lengths(cache: dict, true_lens: torch.Tensor) -> None:
    """Reset every KVCache's and MLACache's per-lane lengths from the
    padded bucket length to the true prompt lengths, in place. A
    RingKVCache is not a KVCache: its bucketed prefill has set its lengths
    already."""
    for node in cache.values():
        for c in node.values():
            if isinstance(c, (KVCache, MLACache)):
                c.length.copy_(true_lens.expand_as(c.length))


def _paged_nodes(cache: dict):
    for node in cache.values():
        for c in node.values():
            if isinstance(c, PagedKVCache):
                yield c


def _lane_tensors(c) -> tuple:
    """The tensors of a lane-resident cache node (KVCache, RingKVCache,
    MLACache, SSMCache or CrossKV), lane axis second."""
    if isinstance(c, SSMCache):
        return c.conv, c.state
    if isinstance(c, MLACache):
        return c.c_kv, c.k_rope, c.length
    if isinstance(c, CrossKV):
        return c.k, c.v
    return c.k, c.v, c.length


def _write_lane(big: dict, lane: dict, slot: int) -> None:
    """Copy lane 0 of every node of the 1-lane cache `lane` into slot
    `slot` of `big`, in place (the caches are stacked, lane axis second:
    [L, B, ...])."""
    for name, node in big.items():
        for key, c in node.items():
            for dst_t, src_t in zip(_lane_tensors(c),
                                    _lane_tensors(lane[name][key])):
                dst_t[:, slot] = src_t[:, 0]


def _copy_lanes(dst, src, slot_ids: torch.Tensor) -> None:
    """Lane g of cache node `src` into slot slot_ids[g] of `dst`, in place,
    for every lane with slot_ids[g] >= 0 (lane axis second: [L, B, ...]),
    routed on the device. A pad lane (-1) goes to lane 0's slot, which
    lane 0 (always a real one) then writes again: index_copy_ leaves the
    winner among duplicate indices unspecified."""
    idx = torch.where(slot_ids >= 0, slot_ids, slot_ids[:1])
    for dst_t, src_t in zip(_lane_tensors(dst), _lane_tensors(src)):
        dst_t.index_copy_(1, idx, src_t)
        dst_t.index_copy_(1, slot_ids[:1], src_t[:, :1])


def _reset(cache: dict) -> None:
    """Every tensor of a dense lane cache back to its init value (zero),
    in place."""
    for node in cache.values():
        for c in node.values():
            for t in _lane_tensors(c):
                t.zero_()


def _decode_state(cache: dict) -> list[torch.Tensor]:
    """What a decode step advances in place and a retry must find as it
    was: every KV, MLA and ring node's length, the ring keys and values,
    the SSM conv window and state. Dense and paged KV rows and MLA latent
    rows past a length need no copy: the retry writes them again. Decode
    never writes a CrossKV."""
    out = []
    for node in cache.values():
        for c in node.values():
            if isinstance(c, CrossKV):
                continue
            if isinstance(c, SSMCache):
                out += [c.conv, c.state]
            elif isinstance(c, RingKVCache):
                out += [c.k, c.v, c.length]
            else:
                out.append(c.length)
    return out


def _guarded(guard, sdc, magnitude: float, fn):
    """fn() under a GuardTape of `guard` with injection plan `sdc`: fn's
    result and the tape's (corrected, uncorrected) totals."""
    with GuardTape(guard, inject=sdc, magnitude=magnitude) as tape:
        out = fn()
    return out, tape.totals()


# The step bodies a StepRunner runs (serve/graphs.py). They take what they
# read as arguments and never the engine, so a runner does not keep its
# engine, and with it the weights, alive in a reference cycle.

def _prefill_body(model: Model, params, cache: dict, lane_cache: dict,
                  tokens, true_lens, slot_ids, dest=None, *, guard=None,
                  magnitude: float = 1e4, sdc=None):
    """A bucket's prefill: one forward over a fixed [slots, bucket] token
    batch into the bucket's static lane cache, reset first (a previous
    group's KV past the true lengths, conv window and SSM state must not
    leak in): per-lane last-real-position argmax (-1 where those logits are
    not finite), the length fixup, then each real lane into its slot of
    `cache` (slot_ids, -1 on pad lanes), or, paged, a page-granular
    scatter of the KV into the pool along `dest`. Every input is a device
    tensor: nothing of the group is a host value. With a `guard` the
    forward runs under a GuardTape with the plan `sdc`, and the first
    tokens come back with (corrected, uncorrected) appended."""
    _reset(lane_cache)

    def forward():
        return model.forward(params, {"tokens": tokens}, cache=lane_cache,
                             true_lens=true_lens)
    if guard is not None:
        (logits, lane_cache), gstats = _guarded(guard, sdc, magnitude,
                                                forward)
    else:
        logits, lane_cache = forward()
    idx = torch.clamp_min(true_lens - 1, 0)
    last = logits[torch.arange(tokens.shape[0], device=tokens.device), idx]
    first = torch.argmax(last, dim=-1)
    first = torch.where(torch.isfinite(last).all(dim=-1), first, -1)
    _fix_lengths(lane_cache, true_lens)
    for name, node in cache.items():
        for key, c in node.items():
            src = lane_cache[name][key]
            if isinstance(c, PagedKVCache):
                c.scatter_prefill(src, dest, slot_ids, true_lens)
            else:               # dense KV, or SSM state (lane-resident)
                _copy_lanes(c, src, slot_ids)
    if guard is not None:
        return torch.cat([first, torch.stack(gstats)])
    return first


def _decode_body(model: Model, params, cache: dict, eos_id: Optional[int],
                 toks, pos, bud, alive, n: int, *, guard=None,
                 magnitude: float = 1e4, sdc=None):
    """A chunk length's decode: n decode steps, all on the device (the
    inputs are the runner's static buffers, never written). Returns one
    packed tensor: the per-step tokens [n, slots], emit masks [n, slots],
    then (emitted, live lanes at the end) and the per-lane non-finite
    flags [slots], so the chunk is read back in one sync. With a `guard`
    each step's model call runs under its own GuardTape (the GEMM indices
    restart every step, so an armed plan `sdc` hits its target at every
    step, as in the reference's scan), and the chunk's (corrected,
    uncorrected) totals follow the flags."""
    emitted = torch.zeros((), dtype=torch.int64, device=toks.device)
    bad = torch.zeros_like(alive)
    seq, emits, verdicts = [], [], []
    for _ in range(n):
        if guard is not None:
            (logits, _), gstats = _guarded(
                guard, sdc, magnitude,
                lambda: model.decode_step(params, toks, cache, pos))
            verdicts.append(torch.stack(gstats))
        else:
            logits, _ = model.decode_step(params, toks, cache, pos)
        ok = torch.isfinite(logits).all(dim=-1)
        bad = bad | (alive & ~ok)
        nxt = torch.argmax(logits, dim=-1)
        emit = alive & ok
        toks = torch.where(emit, nxt, toks)
        bud = bud - emit.long()
        done = bud <= 0
        if eos_id is not None:
            done = done | (nxt == eos_id)
        alive = alive & ~done & ok
        pos = pos + 1
        emitted = emitted + emit.sum()
        seq.append(toks)
        emits.append(emit.long())
    stats = torch.stack([emitted, alive.sum()])
    parts = [torch.stack(seq).flatten(), torch.stack(emits).flatten(),
             stats, bad.long()]
    if guard is not None:
        parts.append(torch.stack(verdicts).sum(dim=0))
    return torch.cat(parts)


class _Scope:
    """One detail span of an engine (the module docstring): a profiler range
    around the block and its name on the engine's stack of open spans;
    on a clean exit, if `emit`, an on_span span with its parent's name and
    the args dict the block was given (and may have added to)."""

    __slots__ = ("engine", "name", "emit", "args", "parent", "t0", "range")

    def __init__(self, engine: "ServeEngine", name: str, emit: bool,
                 args: dict):
        self.engine, self.name, self.emit, self.args = engine, name, emit, args

    def __enter__(self) -> dict:
        e = self.engine
        self.parent = e._open[-1] if e._open else None
        e._open.append(self.name)
        self.range = record_function(self.name,
                                     repr(self.args) if self.args else None)
        self.range.__enter__()
        self.t0 = e._clock()
        return self.args

    def __exit__(self, exc_type, *exc) -> bool:
        e = self.engine
        t1 = e._clock()
        self.range.__exit__(None, None, None)
        e._open.pop()
        if self.emit and exc_type is None:
            e._span(self.name, "serve", self.t0, t1, parent=self.parent,
                    **self.args)
        return False


class ServeEngine:
    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 512, src_len: int = 0,
                 eos_id: Optional[int] = None,
                 tracer=None, decode_chunk: int = 8,
                 prefill_buckets: bool = True,
                 metrics=None, admission=None, chaos=None, clock=None,
                 max_retries: int = 3, backoff_s: float = 1e-3,
                 guard=None, paged: bool = False, page_size: int = 16,
                 kv_pages: Optional[int] = None, eager: bool = False):
        """The reference's arguments and defaults (no min_bucket or
        recycle: MIN_BUCKET is fixed and lanes recycle inside a chunk
        exactly when paged). src_len sizes the encoder-decoder family's
        cross K/V lanes (the frames a request may carry; 0 for every
        decoder-only arch, and for the vision-language family, whose
        cross K/V lanes then take its config's n_image_tokens rows).
        eager=True runs the step runners eagerly on the card too (no CUDA
        graphs): the run a graphed one is held against. On the CPU every
        runner runs eagerly either way."""
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.src_len = src_len
        self.eos_id = eos_id
        # optional duck-typed event sink (tenancy.ServeTraceRecorder): gets
        # on_prefill(rid, prompt_len) / on_decode(lanes, contexts) in the
        # engine's step-locked order, and (if it defines on_span) one timed
        # span per device call for the Perfetto export (obs/export.py).
        # One that also sets `detail` gets the module docstring's detail.
        self.tracer = tracer
        self._detail = (hasattr(tracer, "on_span")
                        and bool(getattr(tracer, "detail", False)))
        self._open: list[str] = []          # detail spans open, innermost last
        self._admitted = 0                  # requests whose prefill started
        self._attention: dict = {}          # the last runner call's regions
        self.decode_chunk = max(1, decode_chunk)
        self.device = model.device
        self.bucketed = bool(prefill_buckets) and model.bucketed_prefill_ok
        # paged=True swaps every KVCache for a PagedKVCache over a shared
        # kv_pages-page pool; paged=False keeps the engine as it was
        self._pool: Optional[PagePool] = None
        if paged:
            if not self.bucketed:
                raise ValueError(
                    "paged serving requires the bucketed prefill path "
                    "(dense/ssm/hybrid families with prefill_buckets=True)")
            if kv_pages is None:
                # the default pool covers the dense worst case exactly;
                # size it down to oversubscribe (admission queues on pages)
                kv_pages = slots * (max_len // page_size)
            self._pool = PagePool(kv_pages, page_size, slots, max_len,
                                  chunk_slack=self.decode_chunk)
            self.cache = model.init_cache(slots, max_len, page_size=page_size,
                                          kv_pages=kv_pages, src_len=src_len)
        else:
            self.cache = model.init_cache(slots, max_len, src_len=src_len)
        # in-chunk lane recycling: on exactly when paged
        self.recycle = bool(paged)
        self.active: list[Optional[Request]] = [None] * slots
        self.positions = np.zeros(slots, np.int64)
        self.budgets = np.zeros(slots, np.int64)
        self.queue: list[Request] = []
        # the compiled-step cache: runners by bucket and by chunk length,
        # one graph pool for all of them on the card unless eager
        self._graphs: Optional[GraphPool] = None
        if self.device.type == "cuda" and not eager:
            self._graphs = GraphPool(self.device)
        self._prefill_runners: dict[int, StepRunner] = {}
        self._lane_caches: dict[int, dict] = {}
        self._decode_runners: dict[int, StepRunner] = {}
        # prefill shapes hit: buckets, or prompt lengths (exact-length)
        self._buckets_seen: set[int] = set()
        # host-side tallies: device calls, forwards and their wall seconds
        # (each call ends in its host sync, so the wall covers the device).
        # A call that warmed a runner up and captured its graph counts as a
        # call, its wall goes to capture_s (and its steps to capture_*).
        # Real wall seconds, whatever clock the controls read.
        self.stats = {"bucketed": self.bucketed, "prefill_calls": 0,
                      "prefill_s": 0.0, "chunks": 0, "decode_steps": 0,
                      "decode_s": 0.0, "graphs": 0, "capture_s": 0.0,
                      "capture_prefills": 0, "capture_steps": 0}
        # SDC guard (kernels/systolic_gemm/guard.py): None or "off" leaves
        # the engine unguarded; "probe" and "abft" run every bucketed
        # prefill forward and every decode step under a GuardTape. The
        # exact-length prefill stays outside it, as in the reference.
        self._guard = as_guard(guard)
        self._guard_on = self._guard.mode != "off"
        self._saved: Optional[list[torch.Tensor]] = None
        self.restart(metrics=metrics, admission=admission, chaos=chaos,
                     clock=clock, max_retries=max_retries,
                     backoff_s=backoff_s)

    def restart(self, metrics=None, admission=None, chaos=None, clock=None,
                max_retries: int = 3, backoff_s: float = 1e-3) -> None:
        """Begin a run: the run's controls and state (metrics, admission
        controller, chaos injector, clock, retries, guard events, EWMAs) as
        the constructor sets them from the same arguments. The model, the
        caches, the compiled runners with their graphs and the lifetime
        tallies (`stats`, the page pool's totals) are kept, so a new run
        captures nothing. The engine must hold no request."""
        if self.queue or any(r is not None for r in self.active):
            raise RuntimeError("restart needs an engine that holds no "
                               "request")
        # optional obs.metrics.MetricsRegistry, fed host values the engine
        # already has at each sync
        self.metrics = metrics
        self.recycled = 0
        # injectable clock (serve/chaos.VirtualClock in tests): spans,
        # deadlines, backoff and the EWMAs read it, so failure scenarios
        # replay deterministically
        self._clock = clock if clock is not None else time.perf_counter
        # admission policy: None/str/AdmissionConfig -> controller. The
        # default AdmissionConfig() (fifo, unbounded queue, no deadlines)
        # leaves the engine's decisions as they were without controls.
        if admission is None:
            admission = AdmissionConfig()
        elif isinstance(admission, str):
            admission = AdmissionConfig(policy=admission)
        if isinstance(admission, AdmissionConfig):
            predictor = None
            if admission.policy == SLO_AWARE:
                predictor = WaveLatencyPredictor(
                    self.model.cfg, admission.design, admission.tdp,
                    faulty_pods=admission.faulty_pods)
            admission = AdmissionController(
                admission, slots=self.slots, max_len=self.max_len,
                predictor=predictor, metrics=metrics)
        self.admission: AdmissionController = admission
        if self._pool is not None:
            # paged admission: free pages gate it; the controller rejects
            # can-never-fit requests at submit and (slo-aware) sheds on
            # predicted page exhaustion
            self.admission.attach_pool(self._pool)
        # chaos: a ChaosConfig arms the seeded fault injector plus the
        # EWMA slow-chunk detector; None leaves every call a plain call.
        # Its p_sdc acts only through the SDC guard.
        if chaos is not None and not isinstance(chaos, FaultInjector):
            chaos = FaultInjector(chaos, clock=clock)
        self._chaos: Optional[FaultInjector] = chaos
        self._slow_detect = SlowChunkDetector() if chaos is not None \
            else None
        self._sdc_plan = None         # armed per attempt by _device_call
        self._sdc_magnitude = (self._chaos.config.sdc_magnitude
                               if self._chaos is not None else 1e4)
        # host-side guard tallies (mirrored to metrics when enabled)
        self.guard_events = {"corrected": 0, "uncorrectable": 0,
                             "non_finite": 0}
        self._chunk_cap: Optional[int] = None
        self.max_retries = max(0, int(max_retries))
        self.backoff_s = float(backoff_s)
        # measured decode seconds per token (engine clock): the
        # deadline-aware chunk sizing reads it
        self._sec_per_tok = Ewma(alpha=0.3)
        self._t0 = self._clock()
        # decode attention's regions, timed on the card's events or, on the
        # CPU, on the engine's clock; made current around runner calls
        self._regions = (spans.RegionRecorder(self.device, self._clock)
                         if self._detail else None)

    # -- fault boundary -------------------------------------------------
    def _sleep(self, seconds: float) -> None:
        if seconds <= 0:
            return
        if hasattr(self._clock, "sleep"):
            self._clock.sleep(seconds)        # virtual time: no blocking
        else:
            time.sleep(seconds)

    def _device_call(self, kind: str, fn):
        """Run one device call through the fault boundary: the chaos
        injector may stall or raise per its seeded schedule; transient
        errors retry with exponential backoff up to `max_retries`, then
        escalate to PermanentFault. The injector raises in before(kind),
        ahead of fn(), and fn() makes the call's runner (if new), copies
        its host inputs into the runner's static buffers and runs it: a
        failed attempt has written nothing, so a retry re-copies the same
        inputs into the same runner (no new runner, no new graph). With the
        guard on, each attempt also draws its SDC plan, and fn() raises
        SilentCorruption on uncorrected output after its read (a decode
        call first restores the state it advanced): retried the same way,
        but when the retries are exhausted it is re-raised, so the caller
        rejects the lanes `sdc-uncorrectable`, not `device-fault`. With
        chaos disarmed and the guard off this is a plain call."""
        if self._chaos is None and not self._guard_on:
            return fn()
        attempt = 0
        while True:
            try:
                if self._chaos is not None:
                    self._chaos.before(kind)
                    self._sdc_plan = (self._chaos.sdc_plan(kind)
                                      if self._guard_on else None)
                return fn()
            except (TransientDeviceError, SilentCorruption) as err:
                attempt += 1
                if self.metrics is not None:
                    self.metrics.counter("serve.chaos.retries",
                                         kind=kind).inc()
                if attempt > self.max_retries:
                    if isinstance(err, SilentCorruption):
                        raise
                    raise PermanentFault(
                        f"{kind} device call failed after {attempt} "
                        f"attempts: {err}") from err
                self._sleep(self.backoff_s * (2 ** (attempt - 1)))

    def _reject_group(self, reqs: list, reason: str) -> None:
        for r in reqs:
            self.admission.reject(r, reason)
        if self.metrics is not None:
            name = ("serve.chaos.sdc_uncorrectable"
                    if reason == "sdc-uncorrectable"
                    else "serve.chaos.permanent_faults")
            self.metrics.counter(name).inc()

    def _sdc_feed(self) -> np.ndarray:
        """The attempt's injection plan for the runner's `sdc` buffer;
        (-1, 0, 0) disarms (no chaos, or a clean draw)."""
        plan = self._sdc_plan if self._sdc_plan is not None else (-1, 0, 0)
        return np.asarray(plan, np.int64)

    def _verdict(self, kind: str, flags) -> int:
        """(corrected, uncorrected) of one guarded call's read: raises
        SilentCorruption on uncorrected output, else returns corrected."""
        if int(flags[1]) > 0:
            raise SilentCorruption(f"{kind}: {int(flags[1])} uncorrected "
                                   f"corruption(s) detected")
        return int(flags[0])

    def _note_guard(self, corrected: int) -> None:
        if corrected > 0:
            self.guard_events["corrected"] += int(corrected)
            if self.metrics is not None:
                self.metrics.counter("serve.guard.corrected").inc(
                    int(corrected))

    def _save_decode_state(self) -> None:
        """Copy what a decode chunk advances, device to device, before a
        guarded decode call (buffers made at the first call)."""
        state = _decode_state(self.cache)
        if self._saved is None:
            self._saved = [torch.empty_like(t) for t in state]
        for buf, t in zip(self._saved, state):
            buf.copy_(t)

    def _restore_decode_state(self) -> None:
        """Put back what _save_decode_state copied, before a retry."""
        for t, buf in zip(_decode_state(self.cache), self._saved):
            t.copy_(buf)

    def _shed_non_finite(self, pairs: list, where: str) -> None:
        """Finalize lanes whose logits went NaN/Inf: recompute would give
        the same poison, so there is no retry; each request ends
        ``rejected`` (``non-finite-logits``) and everyone else keeps
        serving."""
        try:
            check_lanes_finite([(lane, True) for _, lane in pairs], where)
        except NumericalFault:
            for r, _ in pairs:
                self.admission.reject(r, "non-finite-logits")
            self.guard_events["non_finite"] += len(pairs)
            if self.metrics is not None:
                self.metrics.counter("serve.numerical_faults",
                                     where=where).inc(len(pairs))

    # -- telemetry ------------------------------------------------------
    def _span(self, name: str, cat: str, t_start: float, t_end: float,
              **args) -> None:
        """Emit a timed span to the tracer (engine-relative clock); no-op
        unless the tracer understands spans (on_span)."""
        if self.tracer is not None and hasattr(self.tracer, "on_span"):
            self.tracer.on_span(name, ts=t_start - self._t0,
                                dur=t_end - t_start, cat=cat, **args)

    def _scope(self, name: str, emit: bool = True, **args):
        """A detail span around a block (a _Scope), or nothing without
        detail."""
        if not self._detail:
            return _NOTHING
        return _Scope(self, name, emit, args)

    def _note_queue_waits(self, reqs: list, t_start: float) -> None:
        """Detail: each request's serve.queue span, from its submit stamp
        to `t_start`, the start of the prefill that serves it (the open
        span), emitted as the wait ends."""
        parent = self._open[-1]
        for r in reqs:
            self._span("serve.queue", "serve", r._submit_t, t_start,
                       parent=parent, rid=r.rid)
        self._admitted += len(reqs)

    def _observe_prefill(self, path: str, tokens: int, lanes: int,
                         seconds: float) -> None:
        m = self.metrics
        if m is None:
            return
        m.counter("serve.prefill.calls", path=path).inc()
        m.counter("serve.prefill.tokens").inc(tokens)
        m.counter("serve.prefill.seconds").inc(seconds)
        m.histogram("serve.prefill.us").record(seconds * 1e6)
        m.gauge("serve.prefill.lanes").set(lanes)
        m.gauge("serve.queue_depth").set(len(self.queue))

    def _observe_decode(self, n: int, lanes: int, emitted: int,
                        live_end: int, seconds: float) -> None:
        m = self.metrics
        if m is None:
            return
        m.counter("serve.decode.chunks").inc()
        m.counter("serve.decode.tokens").inc(emitted)
        m.counter("serve.decode.seconds").inc(seconds)
        m.histogram("serve.decode.chunk_len").record(n)
        m.gauge("serve.slot_occupancy").set(lanes / self.slots)
        m.gauge("serve.decode.live_lanes_end").set(live_end)
        m.gauge("serve.queue_depth").set(len(self.queue))
        if emitted:
            # every token delivered at this chunk's host sync waited the
            # chunk's full wall time
            m.histogram("serve.decode.token_wait_us").record(
                seconds * 1e6, n=emitted)
        tok = m.counter("serve.decode.tokens").value
        sec = m.counter("serve.decode.seconds").value
        if sec > 0:
            m.gauge("serve.decode.tok_s").set(tok / sec)

    def _observe_paged(self) -> None:
        m, pool = self.metrics, self._pool
        if m is None or pool is None:
            return
        m.gauge("serve.paged.occupancy").set(pool.occupancy)
        m.gauge("serve.paged.pages_in_use").set(pool.pages_in_use)
        m.gauge("serve.paged.reserved_pages").set(pool.reserved_pages)
        chunks = m.counter("serve.decode.chunks").value
        if chunks:
            m.gauge("serve.paged.recycle_rate").set(self.recycled / chunks)

    # -- request flow --------------------------------------------------
    def submit(self, req: Request) -> None:
        """Validate + enqueue. Raises InvalidRequest (typed, names the
        offending field) for malformed requests; the admission policy may
        shed instead (request ends ``rejected``: ``queue-full``,
        ``shed-predicted-miss`` or, paged, ``pages-exhausted``). A paged
        engine refuses a request with extras (field ``extras``)."""
        if self._pool is not None and req.extras:
            raise InvalidRequest(
                "extras", "paged serving cannot prefill per-request extra "
                "modalities (exact-length fallback is dense-only)")
        if self.admission.on_submit(self.queue, req, self._clock()):
            self.queue.append(req)
        if self.metrics is not None:
            self.metrics.gauge("serve.queue_depth").set(len(self.queue))

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    # -- compiled steps ---------------------------------------------------
    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes: one runner (one CUDA graph on the card)
        per bucket hit on the bucketed path, at most max_prefill_compiles;
        distinct prompt lengths on the exact-length path, which compiles
        one per length in the reference (unbounded by construction)."""
        if self.bucketed:
            return len(self._prefill_runners)
        return len(self._buckets_seen)

    @property
    def max_prefill_compiles(self) -> int:
        return max(1, int(math.log2(self.max_len)))

    @property
    def decode_compiles(self) -> int:
        """Decode runners, one per pow2 chunk length: at most
        log2(decode_chunk) + 1."""
        return len(self._decode_runners)

    def _jit_sizes(self) -> int:
        """Runners built, prefill and decode: the counterpart of the
        reference's jit cache sizes, the compile epoch of the slo-aware
        calibration (a service interval that saw a runner's warm-up, and
        on the card its graph capture, is not a clean sample). Exact-length
        prefill builds no runner, as its reference jit is not counted."""
        return len(self._prefill_runners) + len(self._decode_runners)

    def graph_pool_bytes(self) -> int:
        """Device bytes the engine's graph pool holds (0 without graphs)."""
        return 0 if self._graphs is None else self._graphs.held_bytes()

    def _run(self, runner: StepRunner, **feed) -> tuple:
        """One step through `runner`, read back in the call's ONE host
        sync: (host array, real wall seconds, whether it warmed up and
        captured)."""
        captured = runner.captures
        t_start = time.perf_counter()
        if self._detail:
            out = self._call_traced(runner, feed, captured)
        else:
            out = to_host(runner(**feed))
        seconds = time.perf_counter() - t_start
        if captured:
            self.stats["graphs"] = self._graphs.graphs
            self.stats["capture_s"] = self._graphs.capture_s
        return out, seconds, captured

    def _call_traced(self, runner: StepRunner, feed: dict,
                     captured: bool):
        """A runner call with detail: its copy-in, launch (or warm-up and
        capture) and read as child spans, under the engine's region
        recorder; the regions' time is kept for the call's span."""
        with self._regions.recording():
            with self._scope("serve.copy_in"):
                runner.load(**feed)
            launch = (f"serve.capture/{runner.name}" if captured
                      else "serve.launch")
            with self._scope(launch, runner=runner.name) as args:
                out = runner.launch()
                if captured:
                    args.update(runner.seconds)
            with self._scope("serve.read"):
                out = to_host(out)
        pairs = self._regions.take()
        self._attention = {"attention_ms": spans.elapsed_ms(pairs),
                           "attention_regions": len(pairs)}
        return out

    def _prefill_runner(self, bucket: int) -> StepRunner:
        """The bucket's runner, made at its first use: static tokens [slots,
        bucket], true lengths, slot ids (and, paged, the lanes' destination
        pages), and the bucket's static transient lane cache."""
        runner = self._prefill_runners.get(bucket)
        if runner is not None:
            return runner
        dev, B = self.device, self.slots
        inputs = {"tokens": torch.zeros((B, bucket), dtype=torch.int64,
                                        device=dev),
                  "true_lens": torch.ones(B, dtype=torch.int64, device=dev),
                  "slot_ids": torch.full((B,), -1, dtype=torch.int64,
                                         device=dev)}
        if self._pool is None:
            lane = self.model.init_cache(B, self.max_len)
        else:
            # paged: the transient's dense KV spans the bucket's whole
            # pages only; its rings keep the engine's width, slot for slot
            pages = -(-bucket // self._pool.page_size)
            inputs["dest"] = torch.full((B, pages), self._pool.sentinel,
                                        dtype=torch.int64, device=dev)
            lane = self.model.init_cache(B, pages * self._pool.page_size,
                                         ring_len=self.max_len)
        self._lane_caches[bucket] = lane
        body = functools.partial(_prefill_body, self.model, self.params,
                                 self.cache, lane, **self._guard_kw(inputs))
        runner = StepRunner(body, inputs, self._graphs,
                            name=f"prefill_bucket{bucket}")
        self._prefill_runners[bucket] = runner
        return runner

    def _guard_kw(self, inputs: dict) -> dict:
        """With the guard on, a runner's one more static input, the
        injection plan `sdc` int64[3], and its body's guard arguments."""
        if not self._guard_on:
            return {}
        inputs["sdc"] = torch.full((3,), -1, dtype=torch.int64,
                                   device=self.device)
        return {"guard": self._guard, "magnitude": self._sdc_magnitude}

    def _decode_runner(self, n: int) -> StepRunner:
        runner = self._decode_runners.get(n)
        if runner is None:
            dev, B = self.device, self.slots
            inputs = {k: torch.zeros(B, dtype=torch.int64, device=dev)
                      for k in ("toks", "pos", "bud")}
            inputs["alive"] = torch.zeros(B, dtype=torch.bool, device=dev)
            body = functools.partial(_decode_body, self.model, self.params,
                                     self.cache, self.eos_id, n=n,
                                     **self._guard_kw(inputs))
            runner = StepRunner(body, inputs, self._graphs,
                                name=f"decode_chunk{n}")
            self._decode_runners[n] = runner
        return runner

    def _bucket(self, prompt_len: int) -> int:
        b = max(MIN_BUCKET, prompt_len)
        b = 1 << (b - 1).bit_length()                # next power of two
        return min(b, self.max_len)

    def _admit(self) -> None:
        if not self._detail:
            return self._admit_queue()
        with self._scope("serve.admit", queue=len(self.queue)) as args:
            before = self._admitted
            self._admit_queue()
            args["admitted"] = self._admitted - before

    def _admit_queue(self) -> None:
        # queue sweep first: expire queued-past-deadline, shed predicted
        # misses (slo-aware), and order the queue per policy. Pure host
        # work; a fifo queue with no deadlines passes through untouched.
        self.admission.sweep(self.queue, self._clock())
        while self.queue:
            free = self._free_slots()
            if not free:
                return
            if not self.bucketed or self.queue[0].extras:
                # extras carry per-request shapes (frames) that cannot
                # join a shared bucket batch: exact-length prefill
                self._prefill_into(free[0], self.queue.pop(0))
                continue
            # group the head-of-queue bucket: every queued request of the
            # same bucket rides the same prefill call (up to free slots)
            b = self._bucket(len(self.queue[0].prompt))
            take: list[Request] = []
            rest: list[Request] = []
            for r in self.queue:
                if len(take) < len(free) and not r.extras and \
                        self._bucket(len(r.prompt)) == b:
                    if self._pool is not None:
                        # a lane starts only if its worst-case page count
                        # (prompt + clamped budget + one chunk of inert
                        # writes) reserves now, so mapping never fails
                        # mid-flight; requests that don't fit wait queued
                        worst = self._pool.worst_pages(
                            len(r.prompt), self._clamped_budget(r))
                        if not self._pool.can_reserve(worst):
                            rest.append(r)
                            continue
                        self._pool.reserve(free[len(take)], worst)
                    take.append(r)
                else:
                    rest.append(r)
            self.queue = rest
            if not take:
                # the head bucket is blocked on pages; retires at the next
                # chunk sync will free some
                return
            self._prefill_group(take, free[: len(take)], b)

    def _activate(self, req: Request, slot: int, now: float) -> None:
        """A prefilled request takes its slot: position, (possibly
        degraded) budget, the admission stamps and its compile epoch."""
        self.active[slot] = req
        self.positions[slot] = len(req.prompt)
        self.budgets[slot] = self.admission.clamp_budget(
            req, self._clamped_budget(req), len(self.queue))
        self.admission.note_admitted(req, now)
        req._jit_epoch = self._jit_sizes()
        self._retire_if_full(slot)

    # -- bucketed prefill ------------------------------------------------
    def _prefill_group(self, reqs: list[Request], slot_list: list[int],
                       bucket: int) -> None:
        toks = np.zeros((self.slots, bucket), np.int64)
        true_lens = np.ones(self.slots, np.int64)       # pad lanes: len 1
        slot_ids = np.full(self.slots, -1, np.int64)    # -1: pad lane
        for g, r in enumerate(reqs):
            toks[g, :len(r.prompt)] = r.prompt
            true_lens[g] = len(r.prompt)
        slot_ids[:len(slot_list)] = slot_list
        feed = dict(tokens=toks, true_lens=true_lens, slot_ids=slot_ids)
        if self._pool is not None:
            # map each lane's prompt pages; row g of the LANE-indexed
            # destination table names lane g's pages over the bucket
            # (sentinel-padded). The slot-indexed page table reaches the
            # device before the next decode chunk (step() checks
            # pool.dirty).
            dest = np.full((self.slots, -(-bucket // self._pool.page_size)),
                           self._pool.sentinel, np.int64)
            for g, s in enumerate(slot_list):
                self._pool.map_to(s, len(reqs[g].prompt))
                own = self._pool.owned(s)
                dest[g, :len(own)] = own
            feed["dest"] = dest
        self._buckets_seen.add(bucket)
        t_start = self._clock()

        def call():
            if not self._guard_on:
                return self._run(self._prefill_runner(bucket), **feed)
            out, seconds, captured = self._run(self._prefill_runner(bucket),
                                               sdc=self._sdc_feed(), **feed)
            corrected = self._verdict("prefill", out[-2:])
            return out[:-2], seconds, captured, corrected
        try:
            with self._scope(f"prefill/bucket{bucket}", emit=False,
                             bucket=bucket, lanes=len(reqs),
                             rids=[r.rid for r in reqs]):
                if self._detail:
                    self._note_queue_waits(reqs, t_start)
                got = self._device_call("prefill", call)  # the ONE host sync
        except PermanentFault:
            # the call never ran: shed the group (terminal `rejected`);
            # its slots stay free and its pages return to the pool
            self._reject_group(reqs, "device-fault")
            self._release_group(slot_list, len(reqs))
            return
        except SilentCorruption:
            # every attempt's output failed the guard: the group's slots
            # were never activated, so they and their pages are freed
            self.guard_events["uncorrectable"] += 1
            self._reject_group(reqs, "sdc-uncorrectable")
            self._release_group(slot_list, len(reqs))
            return
        first, seconds, captured = got[:3]
        if self._guard_on:
            self._note_guard(got[3])
        t_end = self._clock()
        self.stats["prefill_calls"] += 1
        if captured:
            self.stats["capture_prefills"] += 1
        else:
            self.stats["prefill_s"] += seconds
        if self.tracer is not None:
            for r in reqs:       # successful work only enters the trace
                self.tracer.on_prefill(r.rid, len(r.prompt),
                                       t=t_start - self._t0)
        n_tokens = int(sum(len(r.prompt) for r in reqs))
        self._span(f"prefill/bucket{bucket}", "prefill", t_start, t_end,
                   bucket=bucket, lanes=len(reqs), tokens=n_tokens,
                   rids=[r.rid for r in reqs])
        self._observe_prefill("bucketed", n_tokens, len(reqs),
                              t_end - t_start)
        # a lane whose last-position logits are not finite came back as a
        # -1 first token: shed it before its slot is activated
        poisoned = [(r, s) for g, (r, s) in enumerate(zip(reqs, slot_list))
                    if first[g] < 0]
        if poisoned:
            self._shed_non_finite(poisoned, where="prefill")
            for _, s in poisoned:        # never activated: free its pages
                self._release_slot(s)
        for g, (r, s) in enumerate(zip(reqs, slot_list)):
            if first[g] >= 0:
                r.out.append(int(first[g]))
                self._activate(r, s, t_end)

    # -- exact-length prefill -------------------------------------------
    def _prefill_into(self, slot: int, req: Request) -> None:
        """Prefill one request, [1, S], into a fresh 1-lane cache (its
        CrossKV src_len rows wide), then copy that lane into `slot`. The
        request's extras join the prefill batch. The first token and its
        finiteness come back in one host read; a non-finite one rejects
        the request and leaves the slot untouched."""
        S = len(req.prompt)
        self._buckets_seen.add(S)
        t_start = self._clock()
        with self._scope(f"prefill/exact{S}", emit=False, bucket=S,
                         lanes=1, rids=[req.rid]):
            if self._detail:
                self._note_queue_waits([req], t_start)
            with self._scope("serve.copy_in"):
                lane_cache = self.model.init_cache(1, self.max_len,
                                                   src_len=self.src_len)
                batch = {"tokens": torch.as_tensor(
                    np.asarray(req.prompt, np.int64),
                    device=self.device)[None, :]}
                for key, val in req.extras.items():
                    batch[key] = torch.as_tensor(val, device=self.device)

            def call():
                wall0 = time.perf_counter()
                with self._scope("serve.launch", runner=f"prefill_exact{S}"):
                    logits, lane = self.model.prefill(self.params, batch,
                                                      lane_cache)
                    last = logits[0]
                    first = torch.where(torch.isfinite(last).all(),
                                        torch.argmax(last), -1)
                with self._scope("serve.read"):
                    first = int(to_host(first))          # the ONE host sync
                return first, lane, time.perf_counter() - wall0
            try:
                first, lane_cache, seconds = self._device_call("prefill",
                                                               call)
            except PermanentFault:
                self._reject_group([req], "device-fault")
                return
            self.stats["prefill_calls"] += 1
            self.stats["prefill_s"] += seconds
            if first < 0:
                self._shed_non_finite([(req, slot)], where="prefill")
                return
            _write_lane(self.cache, lane_cache, slot)
            req.out.append(first)
            t_end = self._clock()
        if self.tracer is not None:
            self.tracer.on_prefill(req.rid, S, t=t_start - self._t0)
        self._span(f"prefill/exact{S}", "prefill", t_start, t_end,
                   bucket=S, lanes=1, tokens=S, rids=[req.rid])
        self._observe_prefill("exact", S, 1, t_end - t_start)
        self._activate(req, slot, t_end)

    def _clamped_budget(self, req: Request) -> int:
        """Decode steps this request may take, clamped so that the lane
        never appends past max_len."""
        return min(req.max_new_tokens - 1,
                   max(0, self.max_len - len(req.prompt)))

    def _retire_if_full(self, slot: int) -> None:
        """A prompt that fills the cache retires with its prefill token."""
        if self.positions[slot] >= self.max_len:
            self.admission.finish(self.active[slot], now=self._clock())
            self._release_slot(slot)

    def _release_slot(self, i: int) -> None:
        """Clear a lane AND return its pages: the one retirement path for
        every way a lane can end (finish, expiry, shed, device fault), so
        no path leaks a page."""
        if self._pool is not None:
            self._pool.release(i, now=self._clock())
        self.active[i] = None

    def _release_group(self, slot_list: list[int], n: int) -> None:
        if self._pool is not None:
            for s in slot_list[:n]:
                self._pool.release(s, now=self._clock())

    # -- fused decode loop ------------------------------------------------
    def _chunk_len(self, live: list[int]) -> int:
        # queue waiting -> sync at the soonest lane completion (admit
        # early); queue drained -> run to the latest lane (fewest syncs)
        rem = [max(1, int(self.budgets[i])) for i in live]
        need = min(rem) if self.queue else max(rem)
        room = min(int(self.max_len - self.positions[i]) for i in live)
        n = max(1, min(self.decode_chunk, need, max(1, room)))
        if self._chunk_cap is not None:
            # slow-chunk mitigation (chaos armed + detector flagged):
            # shorter chunks while the device is slow, so deadline checks
            # and admission come around sooner
            n = min(n, self._chunk_cap)
        deadlines = [self.active[i]._deadline for i in live
                     if self.active[i]._deadline is not None]
        spt = self._sec_per_tok.value
        if deadlines and spt is not None and spt > 0:
            # deadline-aware sizing: no chunk so long that the earliest
            # deadline passes between host syncs (lanes without deadlines
            # leave the chunk as it was)
            slack = min(deadlines) - self._clock()
            if slack <= 0:
                n = 1                 # sync asap; expiry reclaims the lane
            else:
                n = max(1, min(n, int(slack / spt)))
        # pow2 floor: <= log2(decode_chunk)+1 decode runners
        return 1 << (n.bit_length() - 1)

    def step(self) -> int:
        """One scheduling quantum: admission, then one fused decode chunk.
        Returns the number of lanes live at the chunk start."""
        with self._scope("serve.step"):
            return self._step()

    def _step(self) -> int:
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        n = self._chunk_len(live)
        if self._pool is not None:
            # map pages to cover this chunk's appends (live lanes reach
            # pos + n; a lane that dies mid-chunk writes inertly inside the
            # same bound, covered by its reservation's chunk slack), then
            # push the slot-indexed table if it changed: host work and one
            # host->device copy, no device->host read
            for i in live:
                self._pool.map_to(i, int(self.positions[i]) + n)
            if self._pool.dirty:
                table = torch.from_numpy(self._pool.table().astype(np.int64))
                for c in _paged_nodes(self.cache):
                    c.page_table.copy_(table, non_blocking=True)
        toks = np.zeros(self.slots, np.int64)
        alive0 = np.zeros(self.slots, bool)
        for i in live:
            toks[i] = self.active[i].out[-1]
            alive0[i] = True
        pos0 = self.positions.copy()
        t_start = self._clock()
        feed = dict(toks=toks, pos=pos0, bud=self.budgets, alive=alive0)

        def call():
            if not self._guard_on:
                return self._run(self._decode_runner(n), **feed)
            out, seconds, captured = self._run(self._decode_runner(n),
                                               sdc=self._sdc_feed(), **feed)
            try:
                corrected = self._verdict("decode chunk", out[-2:])
            except SilentCorruption:
                # the chunk advanced the caches in place: put them back so
                # that a retry (or the next chunk) starts where this did
                self._restore_decode_state()
                raise
            return out[:-2], seconds, captured, corrected
        if self._guard_on:
            self._save_decode_state()
        try:
            with self._scope(f"decode/chunk{n}", emit=False, steps=n,
                             lanes=len(live)):
                got = self._device_call("decode", call)  # the ONE host sync
        except SilentCorruption:
            # every retry's chunk failed the guard; its state was put back,
            # but the lanes are unservable: reject them
            # `sdc-uncorrectable` and free their slots and pages
            self.guard_events["uncorrectable"] += 1
            self._reject_group([self.active[i] for i in live],
                               "sdc-uncorrectable")
            for i in live:
                self._release_slot(i)
            return len(live)
        except PermanentFault:
            # the chunk never ran (the injector raises before the call):
            # caches and positions are untouched. Shed the live lanes and
            # free their slots so queued work keeps flowing.
            self._reject_group([self.active[i] for i in live],
                               "device-fault")
            for i in live:
                self._release_slot(i)
            return len(live)
        packed, seconds, captured = got[:3]
        if self._guard_on:
            self._note_guard(got[3])
        t_end = self._clock()
        with self._scope("serve.retire"):
            self._retire_chunk(live, n, pos0, packed, seconds, captured,
                               t_start, t_end)
        return len(live)

    def _retire_chunk(self, live: list[int], n: int, pos0: np.ndarray,
                      packed: np.ndarray, seconds: float, captured: bool,
                      t_start: float, t_end: float) -> None:
        """Everything after a decode chunk's read: the tallies, its span and
        metrics, tokens appended, finishes, releases, non-finite lanes,
        expiry and in-chunk recycling."""
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += n
        if captured:
            self.stats["capture_steps"] += n
        else:
            self.stats["decode_s"] += seconds
        k = n * self.slots
        seq = packed[:k].reshape(n, self.slots)
        emits = packed[k:2 * k].reshape(n, self.slots).astype(bool)
        emitted, live_end = int(packed[2 * k]), int(packed[2 * k + 1])
        bad = packed[2 * k + 2:]
        self._span(f"decode/chunk{n}", "decode", t_start, t_end,
                   steps=n, lanes=len(live), tokens=emitted,
                   live_end=live_end,
                   **(self._attention if self._detail else {}))
        self._observe_decode(n, len(live), emitted, live_end,
                             t_end - t_start)
        if emitted > 0 and t_end > t_start:
            self._sec_per_tok.observe((t_end - t_start) / emitted)
            if self._slow_detect is not None:
                # a flagged slow streak halves the next chunk; a healthy
                # chunk lifts the cap again
                flagged = self._slow_detect.observe(
                    (t_end - t_start) / emitted)
                self._chunk_cap = max(1, n // 2) if flagged else None
        if self.tracer is not None:                   # step-locked replay
            dt_step = (t_end - t_start) / n
            for s in range(n):
                lanes = [i for i in live if emits[s, i]]
                if lanes:
                    self.tracer.on_decode(
                        len(lanes), [int(pos0[i]) + s for i in lanes],
                        t=(t_start - self._t0) + s * dt_step)
        jit_now = self._jit_sizes()
        for i in live:
            r = self.active[i]
            cnt = int(emits[:, i].sum())
            r.out.extend(int(seq[s, i]) for s in range(cnt))
            self.positions[i] += cnt
            self.budgets[i] -= cnt
            hit_eos = (self.eos_id is not None and cnt > 0
                       and int(seq[cnt - 1, i]) == self.eos_id)
            if self.budgets[i] <= 0 or hit_eos:
                if (self.admission.predictor is not None
                        and jit_now == r._jit_epoch):
                    # calibration: measured service time against the wave
                    # model's prediction for the tokens the request
                    # produced; skipped when a runner was built during its
                    # service (the wall then holds a warm-up or capture)
                    self.admission.observe_service(
                        self.admission.predictor.model_seconds(
                            len(r.prompt), max(1, len(r.out))),
                        t_end - r._admit_t)
                self.admission.finish(r, now=t_end)
                self._release_slot(i)
        # non-finite lanes: a poisoned lane stopped emitting at the bad
        # step, so it cannot have finished above; tokens emitted before it
        # are kept
        poisoned = [(self.active[i], i) for i in live
                    if self.active[i] is not None and bad[i]]
        if poisoned:
            self._shed_non_finite(poisoned, where="decode")
            for _, i in poisoned:
                self._release_slot(i)
        # deadlines at the chunk's existing host sync: completion above
        # wins over expiry in the same chunk
        for i in self.admission.expired_lanes(self.active, t_end):
            self.admission.expire(self.active[i], "deadline-exceeded")
            self._release_slot(i)
        if self.recycle and self.queue and \
                any(r is None for r in self.active):
            # in-chunk lane recycling: a lane that died inside THIS chunk
            # hands its slot and pages to queued work at this same sync,
            # so the successor's prefill lands before the next chunk
            occupied = sum(r is not None for r in self.active)
            self._admit()
            self.recycled += max(
                0, sum(r is not None for r in self.active) - occupied)
        self._observe_paged()

    def paged_kv_stats(self) -> dict:
        """Host-side page-pool accounting (no device sync). KV bytes come
        from the paged caches' dtypes and shapes; `dense_bytes` is what the
        same caches would cost as slots x max_len dense lanes. The pool's
        scratch page is not a page: totals count n_pages. SSM state and
        ring caches are fixed-size and lane-resident (nothing to page):
        they are reported as resident_lane_bytes, for all slots."""
        pool = self._pool
        if pool is None:
            raise ValueError("paged_kv_stats requires paged=True")
        per_tok = sum((c.k.nbytes + c.v.nbytes)
                      // ((pool.n_pages + 1) * pool.page_size)
                      for c in _paged_nodes(self.cache))
        resident = sum(c.lane_bytes() * self.slots
                       if isinstance(c, SSMCache) else c.k.nbytes + c.v.nbytes
                       for node in self.cache.values()
                       for c in node.values()
                       if isinstance(c, (SSMCache, RingKVCache)))
        live_tokens = sum(int(self.positions[i])
                          for i, r in enumerate(self.active)
                          if r is not None)
        return {
            "page_size": pool.page_size,
            "total_pages": pool.n_pages,
            "pages_in_use": pool.pages_in_use,
            "free_pages": pool.free_pages,
            "reserved_pages": pool.reserved_pages,
            "occupancy": pool.occupancy,
            "live_tokens": live_tokens,
            "mapped_tokens": pool.pages_in_use * pool.page_size,
            "kv_bytes_per_token": per_tok,
            "mapped_bytes": pool.pages_in_use * pool.page_size * per_tok,
            "pool_bytes": pool.n_pages * pool.page_size * per_tok,
            "dense_bytes": self.slots * self.max_len * per_tok,
            "resident_lane_bytes": resident,
            "recycled": self.recycled,
        }

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        """Drive the engine until queue and slots drain. Raises
        ServeStalled (naming the stuck request ids and states) if
        max_steps quanta pass with work still pending."""
        for _ in range(max_steps):
            if not self.queue and not any(self.active):
                return
            self.step()
        if not self.queue and not any(self.active):
            return
        pending = {r.rid: r.state for r in self.queue}
        pending.update({r.rid: r.state
                        for r in self.active if r is not None})
        raise ServeStalled(pending, max_steps)
