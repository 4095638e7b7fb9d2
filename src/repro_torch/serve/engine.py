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
    window gathered at the true length), so padding is inert there too.
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
    sync. SSM state is fixed-size per lane and stays lane-resident: nothing
    of it is paged (paged_kv_stats reports it as resident_lane_bytes).

The caches are updated in place. A dead lane keeps decoding inertly to
the end of its chunk; its KV or SSM state is overwritten by the lane's
next prefill.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models.attention import KVCache, PagedKVCache
from ..models.model import Model
from ..models.ssm import SSMCache
from ..runtime import to_host
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
    to the true prompt lengths, in place."""
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
    if isinstance(c, SSMCache):
        return c.conv, c.state
    return c.k, c.v, c.length


def _write_node_lane(dst, src, slot: int, g: int) -> None:
    """Copy lane g of cache node `src` into slot `slot` of `dst`, in place
    (the caches are stacked, lane axis second: [L, B, ...])."""
    for dst_t, src_t in zip(_lane_tensors(dst), _lane_tensors(src)):
        dst_t[:, slot] = src_t[:, g]


def _write_lane(big: dict, lane: dict, slot: int, g: int = 0) -> None:
    """Copy lane g of every node of `lane` into slot `slot` of `big`."""
    for name, node in big.items():
        for key, c in node.items():
            _write_node_lane(c, lane[name][key], slot, g)


class ServeEngine:
    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 decode_chunk: int = 8, paged: bool = False,
                 page_size: int = 16, kv_pages: Optional[int] = None):
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
        # host-side tallies: device calls, forwards and their wall seconds
        # (each call ends in its host sync, so the wall covers the device)
        self.stats = {"bucketed": self.bucketed, "prefill_calls": 0,
                      "prefill_s": 0.0, "chunks": 0, "decode_steps": 0,
                      "decode_s": 0.0}

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
        for g, r in enumerate(reqs):
            toks[g, :len(r.prompt)] = r.prompt
            true_lens[g] = len(r.prompt)
        dest = None
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
        t_start = time.perf_counter()
        first = self._prefill_batched(
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(true_lens).to(self.device), slot_list, dest)
        first = to_host(first)                           # the ONE host sync
        self.stats["prefill_calls"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t_start
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

    def _prefill_batched(self, tokens, true_lens, slot_list: list[int],
                         dest: Optional[np.ndarray] = None):
        """One prefill over a fixed [slots, bucket] token batch into a
        transient dense lane cache: per-lane last-real-position argmax (-1
        where those logits are not finite), the length fixup, then an
        in-place copy of each real lane into its slot, or, paged, a
        page-granular scatter into the pool along `dest`. Slot ids are host
        values, so the dense copy needs no device-side masking. Paged, the
        transient spans the bucket's whole pages only (dest's columns)."""
        if dest is None:
            lane_cache = self.model.init_cache(self.slots, self.max_len)
        else:
            lane_cache = self.model.init_cache(
                self.slots, dest.shape[1] * self._pool.page_size)
        logits, lane_cache = self.model.forward(
            self.params, {"tokens": tokens}, cache=lane_cache,
            true_lens=true_lens)
        idx = torch.clamp_min(true_lens - 1, 0)
        last = logits[torch.arange(self.slots, device=self.device), idx]
        first = torch.argmax(last, dim=-1)
        first = torch.where(torch.isfinite(last).all(dim=-1), first, -1)
        _fix_lengths(lane_cache, true_lens)
        if dest is not None:
            slot_ids = np.full(self.slots, -1, np.int64)    # -1: pad lane
            slot_ids[:len(slot_list)] = slot_list
            dev = self.device
            dest_t = torch.from_numpy(dest).to(dev)
            slot_t = torch.from_numpy(slot_ids).to(dev)
            for name, node in self.cache.items():
                for key, c in node.items():
                    src = lane_cache[name][key]
                    if isinstance(c, PagedKVCache):
                        c.scatter_prefill(src, dest_t, slot_t, true_lens)
                    else:                   # SSM state: lane-resident
                        for g, s in enumerate(slot_list):
                            _write_node_lane(c, src, s, g)
            return first
        for g, s in enumerate(slot_list):
            _write_lane(self.cache, lane_cache, s, g)
        return first

    # -- exact-length prefill -------------------------------------------
    def _prefill_into(self, slot: int, req: Request) -> None:
        """Prefill one request, [1, S], into a fresh 1-lane cache, then copy
        that lane into `slot`. The first token and its finiteness come back
        in one host read; a non-finite one rejects the request and leaves
        the slot untouched."""
        t_start = time.perf_counter()
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
    def _decode_chunk(self, toks, pos, bud, alive, n: int):
        """n decode steps, all on the device. Returns one packed tensor:
        the per-step tokens [n, slots], emit masks [n, slots], then
        (emitted, live lanes at the end) and the per-lane non-finite flags
        [slots], so the chunk is read back in one sync."""
        eos = self.eos_id
        emitted = torch.zeros((), dtype=torch.int64, device=self.device)
        bad = torch.zeros(self.slots, dtype=torch.bool, device=self.device)
        seq, emits = [], []
        for _ in range(n):
            logits, _ = self.model.decode_step(self.params, toks, self.cache,
                                               pos)
            ok = torch.isfinite(logits).all(dim=-1)
            bad = bad | (alive & ~ok)
            nxt = torch.argmax(logits, dim=-1)
            emit = alive & ok
            toks = torch.where(emit, nxt, toks)
            bud = bud - emit.long()
            done = bud <= 0
            if eos is not None:
                done = done | (nxt == eos)
            alive = alive & ~done & ok
            pos = pos + 1
            emitted = emitted + emit.sum()
            seq.append(toks)
            emits.append(emit.long())
        stats = torch.stack([emitted, alive.sum()])
        return torch.cat([torch.stack(seq).flatten(),
                          torch.stack(emits).flatten(), stats, bad.long()])

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
        dev = self.device
        t_start = time.perf_counter()
        packed = self._decode_chunk(
            torch.from_numpy(toks).to(dev),
            torch.from_numpy(self.positions.copy()).to(dev),
            torch.from_numpy(self.budgets.copy()).to(dev),
            torch.from_numpy(alive0).to(dev), n)
        packed = to_host(packed)                         # the ONE host sync
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += n
        self.stats["decode_s"] += time.perf_counter() - t_start
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
        scratch page is not a page: totals count n_pages. SSM state is
        fixed-size and lane-resident (nothing to page): it is reported as
        resident_lane_bytes, for all slots."""
        pool = self._pool
        if pool is None:
            raise ValueError("paged_kv_stats requires paged=True")
        per_tok = sum((c.k.nbytes + c.v.nbytes)
                      // ((pool.n_pages + 1) * pool.page_size)
                      for c in _paged_nodes(self.cache))
        resident = sum(c.lane_bytes() * self.slots
                       for node in self.cache.values()
                       for c in node.values() if isinstance(c, SSMCache))
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
