"""Whether the timed path's tokens are right: a sample of the requests
the run finished, each prompt with its served tokens run once through
the plain float32 reference, and the widest gap by which a served token's
logit lies below the reference's best at its position.

The engine decodes greedily, so a sound program serves the reference's
best token wherever the two are not near a tie, and a near tie costs a gap
of about its rounding. The sample covers every lane of the engine that
served a request: the longest finished request, whole, and for each lane
one request that it finished, drawn from the seed, over its first
`positions` served tokens (the mix's `check`); the run waits past the
close until each such lane has finished one. A fault that spoils some
lanes (half of the batch served another half's logits) then shows on
every seed. The control puts
a lower precision in the program's place: at the same positions it reads
the gap of the token that the reference computed in float8 puts first.

Two numbers come out: the widest gap, and the mean gap over the tokens
compared. A cell's limits file names the numbers it compares, each with
its limit (see PERF.md for the readings behind each).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference
from .reference.common import F32, FP8


def lanes_seen(served: list) -> set:
    """The lanes in which some request was seen running."""
    return {s.lane for s in served if s.lane is not None}


def lanes_done(served: list) -> set:
    """The lanes in which some request has finished."""
    return {s.lane for s in served
            if s.req.state == "done" and s.lane is not None}


def settled(served: list) -> bool:
    """Every lane that served a request has finished one."""
    return lanes_seen(served) <= lanes_done(served)


def sample(served: list, mix: dict, seed: int) -> list:
    """(request, positions) pairs: the longest finished request with all
    its served tokens, then one finished request of each lane, drawn from
    the seed, with its first `positions`."""
    done = [s for s in served if s.req.state == "done"]
    if not done:
        return []
    rng = np.random.default_rng([seed, 2])
    longest = max(done, key=lambda s: len(s.req.out))
    picked = [(longest, len(longest.req.out))]
    k = int(mix["check"]["positions"])
    for lane in sorted(lanes_done(done)):
        mine = [s for s in done if s.lane == lane and s is not longest]
        if mine:
            s = mine[int(rng.integers(len(mine)))]
            picked.append((s, min(k, len(s.req.out))))
    return picked


def gaps(weights: dict, cfg: dict, picked: list, device,
         control: bool = False) -> dict:
    """Over the sampled positions' served tokens (`control`: the float8
    reference's first choices instead): the widest logit gap, the mean
    gap, the number of tokens compared and the lanes they came from."""
    fam = reference.family(cfg["family"])
    widest, total, n = 0.0, 0.0, 0
    for s, k in picked:
        out = list(s.req.out[:k])
        seq = np.concatenate([np.asarray(s.plan.prompt), out[:-1]])
        tokens = torch.as_tensor(seq, dtype=torch.int64, device=device)
        P = len(s.plan.prompt)
        rows = torch.arange(P - 1, P - 1 + len(out), device=device)
        ref = fam.forward_rows(weights, cfg, tokens, rows, F32())
        best = ref.max(dim=-1).values
        if control:
            pick = fam.forward_rows(weights, cfg, tokens, rows,
                                    FP8()).argmax(dim=-1)
        else:
            pick = torch.as_tensor(out, dtype=torch.int64, device=device)
        gap = best - ref.gather(1, pick[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        total += float(gap.double().sum())
        n += len(out)
        del ref
    return {"max_logit_gap": widest, "mean_logit_gap": total / max(1, n),
            "tokens": n,
            "lanes": len({s.lane for s, _ in picked if s.lane is not None})}
