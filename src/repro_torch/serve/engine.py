"""Batched serving engine (counterpart of repro/serve/engine.py with fifo
admission, no deadlines, no guard, no chaos; paging optional).

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
    would take expert capacity from real ones): one request per prefill,
    [1, S], into a fresh 1-lane cache that is then copied into its slot.
    `bucketed` says which path an engine takes.
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
    (_release_slot). In-chunk recycling (always on when paged) re-runs
    admission at the chunk's own sync, so a lane that died mid-chunk is
    handed to queued work without an idle chunk. Paging adds no host
    sync. SSM state and ring caches are fixed-size per lane and stay
    lane-resident: nothing of them is paged (paged_kv_stats reports them
    as resident_lane_bytes), and the transient's rings have the engine's
    width.

The caches are updated in place. A dead lane keeps decoding inertly to
the end of its chunk; its KV or SSM state is overwritten by the lane's
next prefill.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional

import numpy as np
import torch

from ..models.attention import KVCache, PagedKVCache, RingKVCache
from ..models.model import Model
from ..models.ssm import SSMCache
from ..runtime import to_host
from .graphs import GraphPool, StepRunner
from .paging import PagePool

MIN_BUCKET = 8          # smallest prefill bucket (the reference's default)


class InvalidRequest(ValueError):
    """A request that must never reach the hot loop; `.field` names the
    offending Request attribute."""

    def __init__(self, field: str, msg: str):
        super().__init__(f"{field}: {msg}")
        self.field = field


class ServeStalled(RuntimeError):
    """run_to_completion ran out of steps with work still pending."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # new -> queued -> running -> done | rejected
    state: str = "new"
    reason: str = ""


def validate(req: Request, max_len: int) -> None:
    if len(req.prompt) == 0:
        raise InvalidRequest("prompt", "empty prompt")
    if len(req.prompt) > max_len:
        raise InvalidRequest("prompt", f"prompt length {len(req.prompt)} "
                                       f"exceeds max_len {max_len}")
    if req.max_new_tokens <= 0:
        raise InvalidRequest("max_new_tokens", f"token budget must be > 0, "
                                               f"got {req.max_new_tokens}")


def finish(req: Request) -> None:
    req.done = True
    req.state = "done"


def reject(req: Request, reason: str) -> None:
    req.state = "rejected"
    req.reason = reason


def _fix_lengths(cache: dict, true_lens: torch.Tensor) -> None:
    """Reset every KVCache's per-lane lengths from the padded bucket length
    to the true prompt lengths, in place. A RingKVCache is not a KVCache:
    its bucketed prefill has set its lengths already."""
    for node in cache.values():
        for c in node.values():
            if isinstance(c, KVCache):
                c.length.copy_(true_lens.expand_as(c.length))


def _paged_nodes(cache: dict):
    for node in cache.values():
        for c in node.values():
            if isinstance(c, PagedKVCache):
                yield c


def _lane_tensors(c) -> tuple:
    """The tensors of a lane-resident cache node (KVCache, RingKVCache or
    SSMCache), lane axis second."""
    if isinstance(c, SSMCache):
        return c.conv, c.state
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


# The step bodies a StepRunner runs (serve/graphs.py). They take what they
# read as arguments and never the engine, so a runner does not keep its
# engine, and with it the weights, alive in a reference cycle.

def _prefill_body(model: Model, params, cache: dict, lane_cache: dict,
                  tokens, true_lens, slot_ids, dest=None):
    """A bucket's prefill: one forward over a fixed [slots, bucket] token
    batch into the bucket's static lane cache, reset first (a previous
    group's KV past the true lengths, conv window and SSM state must not
    leak in): per-lane last-real-position argmax (-1 where those logits are
    not finite), the length fixup, then each real lane into its slot of
    `cache` (slot_ids, -1 on pad lanes), or, paged, a page-granular
    scatter of the KV into the pool along `dest`. Every input is a device
    tensor: nothing of the group is a host value."""
    _reset(lane_cache)
    logits, lane_cache = model.forward(params, {"tokens": tokens},
                                       cache=lane_cache, true_lens=true_lens)
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
    return first


def _decode_body(model: Model, params, cache: dict, eos_id: Optional[int],
                 toks, pos, bud, alive, n: int):
    """A chunk length's decode: n decode steps, all on the device (the
    inputs are the runner's static buffers, never written). Returns one
    packed tensor: the per-step tokens [n, slots], emit masks [n, slots],
    then (emitted, live lanes at the end) and the per-lane non-finite
    flags [slots], so the chunk is read back in one sync."""
    emitted = torch.zeros((), dtype=torch.int64, device=toks.device)
    bad = torch.zeros_like(alive)
    seq, emits = [], []
    for _ in range(n):
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
    return torch.cat([torch.stack(seq).flatten(),
                      torch.stack(emits).flatten(), stats, bad.long()])


class ServeEngine:
    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 decode_chunk: int = 8, paged: bool = False,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 eager: bool = False):
        """eager=True runs the step runners eagerly on the card too (no
        CUDA graphs): the run a graphed one is held against. On the CPU
        every runner runs eagerly either way."""
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.decode_chunk = max(1, decode_chunk)
        self.device = model.device
        self.bucketed = model.bucketed_prefill_ok
        # paged=True swaps every KVCache for a PagedKVCache over a shared
        # kv_pages-page pool (init_cache refuses it for the families that
        # prefill exact-length); paged=False keeps the engine as it was
        self._pool: Optional[PagePool] = None
        if paged:
            if kv_pages is None:
                # the default pool covers the dense worst case exactly;
                # size it down to oversubscribe (admission queues on pages)
                kv_pages = slots * (max_len // page_size)
            self._pool = PagePool(kv_pages, page_size, slots, max_len,
                                  chunk_slack=self.decode_chunk)
            self.cache = model.init_cache(slots, max_len, page_size=page_size,
                                          kv_pages=kv_pages)
        else:
            self.cache = model.init_cache(slots, max_len)
        # in-chunk lane recycling: on exactly when paged
        self.recycle = bool(paged)
        self.recycled = 0
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
        # call, its wall goes to capture_s (and its steps to capture_*)
        self.stats = {"bucketed": self.bucketed, "prefill_calls": 0,
                      "prefill_s": 0.0, "chunks": 0, "decode_steps": 0,
                      "decode_s": 0.0, "graphs": 0, "capture_s": 0.0,
                      "capture_prefills": 0, "capture_steps": 0}

    # -- request flow --------------------------------------------------
    def submit(self, req: Request) -> None:
        validate(req, self.max_len)
        req.state = "queued"
        if self._pool is not None and self._pool.worst_pages(
                len(req.prompt), self._clamped_budget(req)) > \
                self._pool.n_pages:
            # larger than the entire page pool: no amount of waiting lets
            # this request reserve, so it fails at the door
            reject(req, "pages-exhausted")
            return
        self.queue.append(req)

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

    def graph_pool_bytes(self) -> int:
        """Device bytes the engine's graph pool holds (0 without graphs)."""
        return 0 if self._graphs is None else self._graphs.held_bytes()

    def _run(self, runner: StepRunner, **feed) -> tuple:
        """One step through `runner`, read back in the call's ONE host
        sync: (host array, wall seconds, whether it warmed up and
        captured)."""
        captured = runner.captures
        t_start = time.perf_counter()
        out = to_host(runner(**feed))
        seconds = time.perf_counter() - t_start
        if captured:
            self.stats["graphs"] = self._graphs.graphs
            self.stats["capture_s"] = self._graphs.capture_s
        return out, seconds, captured

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
                                 self.cache, lane)
        runner = StepRunner(body, inputs, self._graphs)
        self._prefill_runners[bucket] = runner
        return runner

    def _decode_runner(self, n: int) -> StepRunner:
        runner = self._decode_runners.get(n)
        if runner is None:
            dev, B = self.device, self.slots
            inputs = {k: torch.zeros(B, dtype=torch.int64, device=dev)
                      for k in ("toks", "pos", "bud")}
            inputs["alive"] = torch.zeros(B, dtype=torch.bool, device=dev)
            body = functools.partial(_decode_body, self.model, self.params,
                                     self.cache, self.eos_id, n=n)
            runner = StepRunner(body, inputs, self._graphs)
            self._decode_runners[n] = runner
        return runner

    def _bucket(self, prompt_len: int) -> int:
        b = max(MIN_BUCKET, prompt_len)
        b = 1 << (b - 1).bit_length()                # next power of two
        return min(b, self.max_len)

    def _admit(self) -> None:
        while self.queue:
            free = self._free_slots()
            if not free:
                return
            if not self.bucketed:
                self._prefill_into(free[0], self.queue.pop(0))
                continue
            # group the head-of-queue bucket: every queued request of the
            # same bucket rides the same prefill call (up to free slots)
            b = self._bucket(len(self.queue[0].prompt))
            take: list[Request] = []
            rest: list[Request] = []
            for r in self.queue:
                if len(take) < len(free) and self._bucket(len(r.prompt)) == b:
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
        first, seconds, captured = self._run(self._prefill_runner(bucket),
                                             **feed)     # the ONE host sync
        self.stats["prefill_calls"] += 1
        if captured:
            self.stats["capture_prefills"] += 1
        else:
            self.stats["prefill_s"] += seconds
        for g, (r, s) in enumerate(zip(reqs, slot_list)):
            if first[g] < 0:      # non-finite last-position logits
                reject(r, "non-finite-logits")
                self._release_slot(s)        # never activated: free pages
                continue
            r.out.append(int(first[g]))
            r.state = "running"
            self.active[s] = r
            self.positions[s] = len(r.prompt)
            self.budgets[s] = self._clamped_budget(r)
            self._retire_if_full(s)

    # -- exact-length prefill -------------------------------------------
    def _prefill_into(self, slot: int, req: Request) -> None:
        """Prefill one request, [1, S], into a fresh 1-lane cache, then copy
        that lane into `slot`. The first token and its finiteness come back
        in one host read; a non-finite one rejects the request and leaves
        the slot untouched."""
        t_start = time.perf_counter()
        self._buckets_seen.add(len(req.prompt))
        lane_cache = self.model.init_cache(1, self.max_len)
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        logits, lane_cache = self.model.prefill(self.params,
                                                {"tokens": tokens},
                                                lane_cache)
        last = logits[0]
        first = torch.where(torch.isfinite(last).all(), torch.argmax(last),
                            -1)
        first = int(to_host(first))                      # the ONE host sync
        self.stats["prefill_calls"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t_start
        if first < 0:
            reject(req, "non-finite-logits")
            return
        _write_lane(self.cache, lane_cache, slot)
        req.out.append(first)
        req.state = "running"
        self.active[slot] = req
        self.positions[slot] = len(req.prompt)
        self.budgets[slot] = self._clamped_budget(req)
        self._retire_if_full(slot)

    def _clamped_budget(self, req: Request) -> int:
        """Decode steps this request may take, clamped so that the lane
        never appends past max_len."""
        return min(req.max_new_tokens - 1,
                   max(0, self.max_len - len(req.prompt)))

    def _retire_if_full(self, slot: int) -> None:
        """A prompt that fills the cache retires with its prefill token."""
        if self.positions[slot] >= self.max_len:
            finish(self.active[slot])
            self._release_slot(slot)

    def _release_slot(self, i: int) -> None:
        """Clear a lane AND return its pages: the one retirement path for
        every way a lane can end, so no path leaks a page."""
        if self._pool is not None:
            self._pool.release(i)
        self.active[i] = None

    # -- fused decode loop ------------------------------------------------
    def _chunk_len(self, live: list[int]) -> int:
        # queue waiting -> sync at the soonest lane completion (admit
        # early); queue drained -> run to the latest lane (fewest syncs)
        rem = [max(1, int(self.budgets[i])) for i in live]
        need = min(rem) if self.queue else max(rem)
        room = min(int(self.max_len - self.positions[i]) for i in live)
        n = max(1, min(self.decode_chunk, need, max(1, room)))
        return 1 << (n.bit_length() - 1)          # pow2 floor

    def step(self) -> int:
        """One scheduling quantum: admission, then one fused decode chunk.
        Returns the number of lanes live at the chunk start."""
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
        packed, seconds, captured = self._run(
            self._decode_runner(n), toks=toks, pos=self.positions,
            bud=self.budgets, alive=alive0)             # the ONE host sync
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += n
        if captured:
            self.stats["capture_steps"] += n
        else:
            self.stats["decode_s"] += seconds
        k = n * self.slots
        seq = packed[:k].reshape(n, self.slots)
        emits = packed[k:2 * k].reshape(n, self.slots).astype(bool)
        bad = packed[2 * k + 2:]
        for i in live:
            r = self.active[i]
            cnt = int(emits[:, i].sum())
            r.out.extend(int(seq[s, i]) for s in range(cnt))
            self.positions[i] += cnt
            self.budgets[i] -= cnt
            hit_eos = (self.eos_id is not None and cnt > 0
                       and int(seq[cnt - 1, i]) == self.eos_id)
            if self.budgets[i] <= 0 or hit_eos:
                finish(r)
                self._release_slot(i)
            elif bad[i]:
                # logits went NaN/Inf: the lane stopped emitting at that
                # step; tokens emitted before it are kept
                reject(r, "non-finite-logits")
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
        return len(live)

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
        """Drive the engine until queue and slots drain; raises
        ServeStalled if max_steps quanta pass with work pending."""
        for _ in range(max_steps):
            if not self.queue and not any(self.active):
                return
            self.step()
        if self.queue or any(self.active):
            pending = [r.rid for r in self.queue] + \
                [r.rid for r in self.active if r is not None]
            raise ServeStalled(f"requests {pending} still pending after "
                               f"{max_steps} steps")
