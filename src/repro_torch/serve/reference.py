"""Reference serving engine: the per-token oracle (counterpart of
repro/serve/reference.py, fifo admission).

One exact-length prefill per request (for a sliding-window ring cache:
the last window of the prompt rolled into its slots) and one host read
per decoded token.
`Request.out` holds max_new_tokens greedy tokens (the first from prefill),
truncated at eos_id inclusive: the contract ServeEngine shares. The oracle
also keeps, per request, the top-1 minus top-2 logit margin and the
largest |logit| of every token it chose (`margins[rid]`), read in the same
sync as the token, so a comparison can tell a near tie from a fault.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.model import Model
from ..runtime import to_host
from .engine import (Request, ServeStalled, _write_lane, finish, reject,
                     validate)


def _pick(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] logits -> [B, 4] float64: argmax, all-finite, top-2 margin,
    max |logit|, for one host read."""
    lf = logits.float()
    top2 = torch.topk(lf, 2, dim=-1).values
    return torch.stack([torch.argmax(logits, dim=-1).double(),
                        torch.isfinite(lf).all(dim=-1).double(),
                        (top2[:, 0] - top2[:, 1]).double(),
                        lf.abs().amax(dim=-1).double()], dim=-1)


class ReferenceEngine:
    """Step-locked continuous batching, host-synced per token."""

    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = model.device
        self.cache = model.init_cache(slots, max_len)
        self.active: list[Optional[Request]] = [None] * slots
        self.positions = np.zeros(slots, np.int64)
        self.budgets = np.zeros(slots, np.int64)
        self.queue: list[Request] = []
        self.margins: dict[int, list[tuple[float, float]]] = {}

    def submit(self, req: Request) -> None:
        validate(req, self.max_len)
        req.state = "queued"
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _admit(self) -> None:
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            self._prefill_into(slot, self.queue.pop(0))

    def _prefill_into(self, slot: int, req: Request) -> None:
        S = len(req.prompt)
        lane_cache = self.model.init_cache(1, self.max_len)
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        logits, lane_cache = self.model.prefill(self.params,
                                                {"tokens": tokens},
                                                lane_cache)
        tok, fin, margin, top = to_host(_pick(logits))[0]
        if not fin:
            reject(req, "non-finite-logits")
            return
        _write_lane(self.cache, lane_cache, slot)
        req.out.append(int(tok))
        self.margins[req.rid] = [(float(margin), float(top))]
        req.state = "running"
        self.active[slot] = req
        self.positions[slot] = S
        self.budgets[slot] = min(req.max_new_tokens - 1,
                                 max(0, self.max_len - S))
        if S >= self.max_len:
            finish(req)
            self.active[slot] = None

    def step(self) -> int:
        """One step-locked decode over all slots. Returns #active."""
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        toks = np.zeros(self.slots, np.int64)
        for i in live:
            toks[i] = self.active[i].out[-1]
        logits, self.cache = self.model.decode_step(
            self.params, torch.from_numpy(toks).to(self.device), self.cache,
            torch.from_numpy(self.positions.copy()).to(self.device))
        picked = to_host(_pick(logits))
        for i in live:
            r = self.active[i]
            tok, fin, margin, top = picked[i]
            if not fin:
                reject(r, "non-finite-logits")
                self.active[i] = None
                continue
            r.out.append(int(tok))
            self.margins[r.rid].append((float(margin), float(top)))
            self.positions[i] += 1
            self.budgets[i] -= 1
            if self.budgets[i] <= 0 or (self.eos_id is not None
                                        and int(tok) == self.eos_id):
                finish(r)
                self.active[i] = None
        return len(live)

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and not any(self.active):
                return
            self.step()
        if self.queue or any(self.active):
            pending = [r.rid for r in self.queue] + \
                [r.rid for r in self.active if r is not None]
            raise ServeStalled(f"requests {pending} still pending after "
                               f"{max_steps} steps")
