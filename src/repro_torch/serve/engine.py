"""Batched serving engine (counterpart of repro/serve/engine.py in its
default configuration: fifo admission, no deadlines, no paging, no guard,
no chaos).

The engine owns a fixed decode batch of `slots` lanes; requests queue,
prefill into free slots, and decode step-locked with the rest of the batch.

  * Bucketed prefill: prompts are right-padded to power-of-two buckets and
    queued requests of the head request's bucket share ONE prefill over a
    fixed [slots, bucket] batch. Padding is inert for the dense KV cache:
    causal masking keeps padded keys out of real rows, and the length
    fixup masks the padded cache slots until decode overwrites them.
  * Fused decode: a chunk of n decode steps runs as a Python loop whose
    tokens, positions, budgets and alive masks stay on the device; nothing
    is read back inside the loop. A lane whose budget runs out keeps
    decoding inertly until the chunk ends. Chunk lengths are floored to
    powers of two.
  * Host syncs: exactly one counted read (runtime.to_host) per prefill
    group and one per decode chunk.

The KV cache is updated in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models.attention import KVCache
from ..models.model import Model
from ..runtime import to_host

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


def _write_lane(big: dict, lane: dict, slot: int, g: int = 0) -> None:
    """Copy lane g of `lane` into slot `slot` of `big`, in place (the
    caches are stacked, lane axis second: [L, B, ...])."""
    for name, node in big.items():
        for key, c in node.items():
            src = lane[name][key]
            for dst_t, src_t in ((c.k, src.k), (c.v, src.v),
                                 (c.length, src.length)):
                dst_t[:, slot] = src_t[:, g]


class ServeEngine:
    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 decode_chunk: int = 8):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.decode_chunk = max(1, decode_chunk)
        self.device = model.device
        self.cache = model.init_cache(slots, max_len)
        self.active: list[Optional[Request]] = [None] * slots
        self.positions = np.zeros(slots, np.int64)
        self.budgets = np.zeros(slots, np.int64)
        self.queue: list[Request] = []
        # host-side tallies: device calls, forwards and their wall seconds
        # (each call ends in its host sync, so the wall covers the device)
        self.stats = {"prefill_calls": 0, "prefill_s": 0.0, "chunks": 0,
                      "decode_steps": 0, "decode_s": 0.0}

    # -- request flow --------------------------------------------------
    def submit(self, req: Request) -> None:
        validate(req, self.max_len)
        req.state = "queued"
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
            # group the head-of-queue bucket: every queued request of the
            # same bucket rides the same prefill call (up to free slots)
            b = self._bucket(len(self.queue[0].prompt))
            take: list[Request] = []
            rest: list[Request] = []
            for r in self.queue:
                if len(take) < len(free) and self._bucket(len(r.prompt)) == b:
                    take.append(r)
                else:
                    rest.append(r)
            self.queue = rest
            self._prefill_group(take, free[: len(take)], b)

    # -- bucketed prefill ------------------------------------------------
    def _prefill_group(self, reqs: list[Request], slot_list: list[int],
                       bucket: int) -> None:
        toks = np.zeros((self.slots, bucket), np.int64)
        true_lens = np.ones(self.slots, np.int64)       # pad lanes: len 1
        for g, r in enumerate(reqs):
            toks[g, :len(r.prompt)] = r.prompt
            true_lens[g] = len(r.prompt)
        t_start = time.perf_counter()
        first = self._prefill_batched(
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(true_lens).to(self.device), slot_list)
        first = to_host(first)                           # the ONE host sync
        self.stats["prefill_calls"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t_start
        for g, (r, s) in enumerate(zip(reqs, slot_list)):
            if first[g] < 0:      # non-finite last-position logits
                reject(r, "non-finite-logits")
                continue
            r.out.append(int(first[g]))
            r.state = "running"
            self.active[s] = r
            self.positions[s] = len(r.prompt)
            self.budgets[s] = self._clamped_budget(r)
            self._retire_if_full(s)

    def _prefill_batched(self, tokens, true_lens, slot_list: list[int]):
        """One prefill over a fixed [slots, bucket] token batch into a
        transient lane cache: per-lane last-real-position argmax (-1 where
        those logits are not finite), the length fixup, then an in-place
        copy of each real lane into its slot. Slot ids are host values, so
        the scatter needs no device-side masking."""
        lane_cache = self.model.init_cache(self.slots, self.max_len)
        logits, lane_cache = self.model.forward(
            self.params, {"tokens": tokens}, cache=lane_cache)
        idx = torch.clamp_min(true_lens - 1, 0)
        last = logits[torch.arange(self.slots, device=self.device), idx]
        first = torch.argmax(last, dim=-1)
        first = torch.where(torch.isfinite(last).all(dim=-1), first, -1)
        _fix_lengths(lane_cache, true_lens)
        for g, s in enumerate(slot_list):
            _write_lane(self.cache, lane_cache, s, g)
        return first

    def _clamped_budget(self, req: Request) -> int:
        """Decode steps this request may take, clamped so that the lane
        never appends past max_len."""
        return min(req.max_new_tokens - 1,
                   max(0, self.max_len - len(req.prompt)))

    def _retire_if_full(self, slot: int) -> None:
        """A prompt that fills the cache retires with its prefill token."""
        if self.positions[slot] >= self.max_len:
            finish(self.active[slot])
            self.active[slot] = None

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
                self.active[i] = None
            elif bad[i]:
                # logits went NaN/Inf: the lane stopped emitting at that
                # step; tokens emitted before it are kept
                reject(r, "non-finite-logits")
                self.active[i] = None
        return len(live)

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
