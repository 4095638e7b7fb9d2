"""Butterfly collectives: the paper's interconnect as a collective schedule
(counterpart of repro/parallel/collectives.py), on torch.distributed.

SOSA's Butterfly network (§3.2, Fig 6) is a log2(N)-stage fabric where
stage t connects nodes differing in bit t. Its distributed-training
analogue is the recursive-halving/doubling ("butterfly") all-reduce:
log2(N) rounds of pairwise exchange at doubling distances. The ring is the
baseline: 2(N-1) steps, bandwidth-optimal for large payloads, N-1 latency
hops. The expansion-2 variant splits the payload over two plane schedules
per round, like the paper's Butterfly-2.

Each function runs on every rank of `group` (SPMD) with that rank's
tensor `x` and returns its result, where the reference runs inside
shard_map over `axis_name`: `group` is the process group of one mesh
dimension (`mesh.get_group("pod")`), the reference's axis index is the
rank within the group and its axis size the group's size. A ppermute is
one `dist.batch_isend_irecv` of paired sends and receives, its peers
given as global ranks (the groups of a mesh dimension do not hold
consecutive global ranks). The order of every addition is the
reference's, so each shard equals JAX's bit for bit (f32 addition of two
operands commutes).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _axis(group) -> tuple[int, int]:
    """(rank within group, group size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def _exchange(x: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """One rank's part of a ppermute: send x to group rank `dst`, return
    what group rank `src` sent (both in one batch: NCCL pairs them)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _partner(x: torch.Tensor, group, bit: int) -> torch.Tensor:
    """ppermute over the pairs i <-> i ^ bit (a symmetric permutation)."""
    idx, _ = _axis(group)
    return _exchange(x, group, idx ^ bit, idx ^ bit)


def _check_pow2(n: int) -> None:
    assert n & (n - 1) == 0, "butterfly collectives need a power-of-two axis"


def butterfly_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Recursive-doubling all-reduce: log2(N) exchange rounds (Fig 6 DAG).
    Round t exchanges with the partner differing in bit t of the axis
    index; after all rounds every rank holds the full sum."""
    _, n = _axis(group)
    _check_pow2(n)
    for t in range(n.bit_length() - 1):
        x = x + _partner(x, group, 1 << t)
    return x


def butterfly_all_reduce_expansion2(x: torch.Tensor, group) -> torch.Tensor:
    """Butterfly-2: the payload split in half, the halves run on plane-0
    (LSB-first) and plane-1 (MSB-first) schedules: disjoint link sets per
    round (the paper's expansion argument). An odd payload is padded by
    one zero."""
    _, n = _axis(group)
    _check_pow2(n)
    rounds = n.bit_length() - 1
    flat = x.reshape(-1)
    pad = flat.shape[0] % 2
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    a, b = torch.chunk(flat, 2)
    for t in range(rounds):
        a = a + _partner(a, group, 1 << t)                  # plane 0
        b = b + _partner(b, group, 1 << (rounds - 1 - t))   # plane 1
    out = torch.cat([a, b])
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


def butterfly_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Recursive-halving reduce-scatter: log2(N) rounds, halving the
    payload each round, bits walked MSB -> LSB; rank i ends with the i-th
    1/N slice of the sum. x's leading dim must be divisible by N."""
    idx, n = _axis(group)
    _check_pow2(n)
    buf = x
    for t in range(n.bit_length() - 2, -1, -1):
        bit = 1 << t
        half = buf.shape[0] // 2
        lo, hi = buf[:half], buf[half:]
        has_bit = (idx & bit) != 0
        # keep the half matching our bit, ship the other to the partner
        keep, ship = (hi, lo) if has_bit else (lo, hi)
        buf = keep + _partner(ship, group, bit)
    return buf


def butterfly_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Recursive-doubling all-gather (the reduce-scatter's walk inverted).
    The gathered order is bit-reversal-composed; paired with
    `butterfly_reduce_scatter` (same bit walk),
    all_gather(reduce_scatter(x)) == all_reduce(x) exactly, which is the
    only way it is used (the ZeRO-1 gradient path)."""
    idx, n = _axis(group)
    _check_pow2(n)
    buf = x
    for t in range(n.bit_length() - 1):
        bit = 1 << t
        other = _partner(buf, group, bit)
        lo, hi = (other, buf) if idx & bit else (buf, other)
        buf = torch.cat([lo, hi], dim=0)
    return buf


def ring_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Baseline: the 2(N-1)-step ring (reduce-scatter, then all-gather),
    any axis size; the payload is padded to a multiple of N."""
    idx, n = _axis(group)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1)
    nxt, prv = (idx + 1) % n, (idx - 1) % n

    # reduce-scatter: start with own chunk (idx+1); at step s, the incoming
    # partial is for chunk (idx - s) mod n: add our copy of it and pass on
    acc = chunks[(idx + 1) % n]
    for step in range(n - 1):
        acc = _exchange(acc, group, nxt, prv)
        acc = acc + chunks[(idx - step) % n]
    # rank idx now owns the fully reduced chunk (idx+2) mod n; all-gather
    out = [acc]
    cur = acc
    for step in range(n - 1):
        cur = _exchange(cur, group, nxt, prv)
        out.append(cur)
    # out[k] came from rank (idx - k): it owns chunk (idx - k + 2) mod n
    ordered = torch.empty_like(chunks)
    for k, c in enumerate(out):
        ordered[(idx + 2 - k) % n] = c
    flat_out = ordered.reshape(-1)
    if pad:
        flat_out = flat_out[:-pad]
    return flat_out.reshape(x.shape)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The library all-reduce (dist.all_reduce, SUM) on a copy of x."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


COLLECTIVES = {
    "psum": psum,
    "butterfly": butterfly_all_reduce,
    "butterfly2": butterfly_all_reduce_expansion2,
    "ring": ring_all_reduce,
}


def all_reduce_under_mesh(mesh, axis_name: str, impl: str = "butterfly"):
    """f(x) -> x summed over the mesh dimension `axis_name` by `impl`: x a
    DTensor whose local block each rank reduces, its placements kept (the
    reference's shard_map with P(axis_name) in and out)."""
    fn = COLLECTIVES[impl]
    group = mesh.get_group(axis_name)

    def _run(x):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(fn(x.to_local(), group), x.device_mesh,
                                  x.placements, shape=x.shape,
                                  stride=x.stride())

    return _run
