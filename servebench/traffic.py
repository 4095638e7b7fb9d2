"""The one traffic generator: a mix file's parameters and a seed in, the
requests of a run out.

A mix (traffic/<mix>.json) names the engine's size (`serving`), the
arrivals (`arrival`: an open loop of `poisson` arrivals at `rate_per_s`, after
`initial` requests that are due at once), the prompt and output
length distributions (`uniform` or `loguniform` between `min` and `max`,
inclusive), `ramp_s` seconds of load before the measured window opens,
and how many served tokens of each lane's sampled request the
correctness check compares (`check`, check.py).

Every seed gets the same distributions, evenly mixed, in another order:
the i-th request takes the quantile frac(o + i * a) of each distribution,
with a fixed irrational step a for each (prompt, output, gap) and an
offset o drawn from the seed. Any run of consecutive requests then holds
its lengths and gaps in close to their distribution's proportions, so no
seed bunches long prompts together and runs on different seeds do the
same work: the tails of a cell below the knee read alike from seed to
seed. The `initial` requests fill the engine at once; each of them takes
an output length drawn from 1 up to its drawn length, so that the slots
do not all finish together and the window opens on a steady mix.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Planned:
    due_s: float           # seconds after the load starts
    prompt: np.ndarray     # token ids
    max_new: int           # output tokens, the prefill's first included


def quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    """Lengths at probabilities u of a `uniform` or `loguniform` integer
    distribution over [min, max]."""
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "uniform":
        x = lo + u * (hi + 1 - lo)
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


# golden ratio, sqrt 2 and sqrt 3, less their integer parts
STEPS = {"prompt": 0.6180339887498949, "output": 0.41421356237309515,
         "gap": 0.7320508075688772}


def evenly_mixed(n: int, step: float, rng: np.random.Generator) -> np.ndarray:
    """n probabilities frac(o + i * step), o uniform from rng, kept inside
    (0, 1)."""
    u = (rng.random() + step * np.arange(n)) % 1.0
    return np.clip(u, 0.5 / max(n, 1) / 64, 1.0 - 0.5 / max(n, 1) / 64)


def plan(mix: dict, seed: int, vocab: int, seconds: float) -> list[Planned]:
    """The requests of one run, enough to keep arriving through the ramp,
    the window and half a window more."""
    rng = np.random.default_rng([seed, 1])
    arr = mix["arrival"]
    if arr["kind"] != "poisson":
        raise ValueError(f"unknown arrival kind {arr['kind']!r}")
    rate = float(arr["rate_per_s"])
    n_init = int(arr.get("initial", 0))
    horizon = float(mix["ramp_s"]) + 1.5 * seconds
    n_stream = int(math.ceil(rate * horizon)) + 16
    n = n_init + n_stream
    prompts = quantile(mix["prompt"], evenly_mixed(n, STEPS["prompt"], rng))
    outputs = quantile(mix["output"], evenly_mixed(n, STEPS["output"], rng))
    u = evenly_mixed(n_stream, STEPS["gap"], rng)
    gaps = -np.log1p(-u) / rate
    due = np.concatenate([np.zeros(n_init), np.cumsum(gaps)])
    outputs[:n_init] = rng.permutation(residual(
        mix["output"], (np.arange(n_init) + 0.5) / max(1, n_init)))
    ids = rng.integers(0, vocab, size=int(prompts.sum()), dtype=np.int64)
    cuts = np.cumsum(prompts)[:-1]
    return [Planned(float(t), p, int(o))
            for t, p, o in zip(due, np.split(ids, cuts), outputs)]


def residual(dist: dict, u: np.ndarray) -> np.ndarray:
    """Remaining output lengths of requests caught running, at
    probabilities u: the residual length's distribution has density
    P(L >= x) / E[L] for x >= 1."""
    lengths = quantile(dist, (np.arange(4096) + 0.5) / 4096)
    x = np.arange(1, int(dist["max"]) + 1)
    surv = (lengths[None, :] >= x[:, None]).mean(axis=1)
    cdf = np.cumsum(surv) / surv.sum()
    return np.searchsorted(cdf, u).astype(np.int64) + 1


def warmup_prompt_lengths(mix: dict) -> list[int]:
    """Prompt lengths that reach every prefill shape of the mix: its
    shortest and longest prompt and every power of two between, so that
    a power-of-two bucketing meets each of its buckets once."""
    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    pw = [1 << k for k in range(lo.bit_length(), hi.bit_length())
          if lo < (1 << k) < hi]
    return sorted({lo, hi, *pw})
