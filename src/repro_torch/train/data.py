# Copy of src/repro/train/data.py (the port imports nothing of repro).
"""Deterministic synthetic token pipeline.

Reproducible across restarts (sequence index -> tokens is a pure function
of (seed, step, host)), sharded per host, with background-style prefetch
(here: an iterator that builds the next batch eagerly). A real deployment
swaps `_synth_tokens` for a tokenized shard reader; everything else stays.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _synth_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """Markov-ish synthetic text: deterministic in (seed, step, host)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    b, s = cfg.host_batch, cfg.seq_len
    base = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    # inject local structure so the loss is learnable (copy-prev patterns)
    shift = np.roll(base, 1, axis=1)
    mask = rng.random((b, s)) < 0.5
    return np.where(mask, shift, base).astype(np.int32)


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """Yields {tokens, labels} with next-token labels; resume-safe: pass the
    restored step and the stream continues identically."""
    step = start_step
    while True:
        toks = _synth_tokens(cfg, step)
        labels = np.concatenate(
            [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int32)], axis=1)
        yield {"tokens": toks, "labels": labels}
        step += 1
