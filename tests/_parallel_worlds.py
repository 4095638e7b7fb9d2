"""The two worlds behind tests/test_torch_parallel.py, each run as a
subprocess over a work directory that holds `inputs.npz`:

    python tests/_parallel_worlds.py jax  WORKDIR   # 8 forced host devices
    python tests/_parallel_worlds.py gloo WORKDIR   # 8 gloo ranks

`jax` runs the reference (repro.parallel, repro.train.grad_sync,
repro.train.train_step) under shard_map on 8 CPU devices and writes
`jax.npz` and `jax.json`. `gloo` starts 8 ranks with
torch.multiprocessing (init_method file:// inside WORKDIR, so concurrent
test workers never share a port), runs the port on the same inputs and
writes `rank{r}.npz`, with the local shapes that the sharded step's loss
and attention saw on that rank (`_recording`). Neither world imports the other package, and the
test compares their files: one world of each per test module, not one per
case.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import types

import numpy as np

N = 8
# one row per rank of each collective case: (name, per-rank payload shape)
COLL_CASES = {"butterfly": (64,), "butterfly2": (64,), "ring": (64,),
              "psum": (64,), "butterfly2_odd": (63,), "ring_ragged": (61,),
              "rs_ag": (64,), "rs_ag_2d": (16, 4)}
COMPRESSED_STEPS = 3
COMPRESSED_LEN = 300             # two BLOCKs after padding
GRAD_IMPLS = ("psum", "butterfly", "butterfly2", "compressed")
SHARD_ARCHS = ("granite-8b", "dbrx-132b", "deepseek-v2-236b", "mamba2-370m",
               "hymba-1.5b")
MESHES = {"pdm": ((2, 2, 2), ("pod", "data", "model")),
          "dm": ((2, 4), ("data", "model"))}
MICROBATCHES = 2                 # the microbatched sharded step's
LOSS_VOCABS = (256, 255)         # split 64 a rank on 4 ways; replicated
DECODE_PAD = 4                   # cache rows past the prompt


def coll_inputs() -> dict:
    rng = np.random.default_rng(0)
    out = {name: rng.standard_normal((N,) + shape).astype(np.float32)
           for name, shape in COLL_CASES.items()}
    out["compressed"] = rng.standard_normal(
        (COMPRESSED_STEPS, N, COMPRESSED_LEN)).astype(np.float32)
    return out


def replicated_grads() -> dict:
    """The reference's test's gradient tree (tests/test_grad_sync.py)."""
    rng = np.random.default_rng(0)
    return {"w1": rng.standard_normal((8, 16)).astype(np.float32),
            "w2": {"a": rng.standard_normal((5,)).astype(np.float32),
                   "b": rng.standard_normal((3, 3)).astype(np.float32)}}


def distinct_grads(rank: int) -> dict:
    """Rank r's own gradients: f32 leaves and one bf16-representable leaf
    (cast to bf16 by the caller), distinct on every rank."""
    rng = np.random.default_rng(100 + rank)
    return {"w1": rng.standard_normal((8, 16)).astype(np.float32),
            "w2": {"a": rng.standard_normal((5,)).astype(np.float32),
                   "b": rng.standard_normal((3, 3)).astype(np.float32)}}


def numpy_params(schema: dict, seed: int = 0) -> dict:
    """A port schema's leaves drawn from a numpy seed (standard normal, in
    f32; the caller casts), in key order."""
    rng = np.random.default_rng(seed)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(s[k]) for k in sorted(s)}
        return rng.standard_normal(s.shape).astype(np.float32)
    return walk(schema)


def nest(flat: dict, prefix: str) -> dict:
    """{prefix + 'a/b': x} -> {'a': {'b': x}}."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# --------------------------------------------------------------------------
# the JAX world
# --------------------------------------------------------------------------

def jax_world(workdir: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_arch, reduced
    from repro.models.layers import is_spec
    from repro.models.model import Model
    from repro.parallel import collectives as C
    from repro.parallel.compression import compressed_psum
    from repro.parallel.sharding import (batch_sharding, pspec_for_axes,
                                         shardings_from_schema)
    from repro.train.grad_sync import make_grad_sync
    from repro.train.train_step import TrainConfig, grads_fn

    devs = np.array(jax.devices())
    assert devs.size == N, devs
    out: dict = {}
    meta: dict = {}
    inp = coll_inputs()
    line = Mesh(devs.reshape(N), ("x",))

    def per_shard(fn, arr):
        f = shard_map(lambda a: fn(a[0], "x")[None], mesh=line,
                      in_specs=P("x"), out_specs=P("x"), check_rep=False)
        return np.asarray(f(jnp.asarray(arr)))

    fns = {"butterfly": C.butterfly_all_reduce,
           "butterfly2": C.butterfly_all_reduce_expansion2,
           "ring": C.ring_all_reduce,
           "psum": lambda x, ax: jax.lax.psum(x, ax),
           "butterfly2_odd": C.butterfly_all_reduce_expansion2,
           "ring_ragged": C.ring_all_reduce}
    for name, fn in fns.items():
        out[f"coll/{name}"] = per_shard(fn, inp[name])
    for name in ("rs_ag", "rs_ag_2d"):
        out[f"coll/{name}/rs"] = per_shard(C.butterfly_reduce_scatter,
                                           inp[name])
        out[f"coll/{name}"] = per_shard(
            lambda a, ax: C.butterfly_all_gather(
                C.butterfly_reduce_scatter(a, ax), ax), inp[name])

    f = shard_map(lambda g, e: tuple(
        r[None] for r in compressed_psum(g[0], "x", e[0])), mesh=line,
        in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x")),
        check_rep=False)
    err = jnp.zeros((N, COMPRESSED_LEN), jnp.float32)
    for t in range(COMPRESSED_STEPS):
        red, err = f(jnp.asarray(inp["compressed"][t]), err)
        out[f"compressed/{t}/reduced"] = np.asarray(red)
        out[f"compressed/{t}/error"] = np.asarray(err)

    # make_grad_sync on replicated grads (the reference's own test's mesh)
    pdm = Mesh(devs.reshape(MESHES["pdm"][0]), MESHES["pdm"][1])
    g = replicated_grads()
    grads = {"w1": jnp.asarray(g["w1"]),
             "w2": {"a": jnp.asarray(g["w2"]["a"]),
                    "b": jnp.asarray(g["w2"]["b"], jnp.bfloat16)}}
    for impl in GRAD_IMPLS:
        sync = make_grad_sync(pdm, axis="pod", impl=impl)
        with pdm:
            red, e = jax.jit(lambda x: sync(x))(grads)
        out[f"sync/{impl}/w1"] = np.asarray(red["w1"])
        out[f"sync/{impl}/a"] = np.asarray(red["w2"]["a"])
        out[f"sync/{impl}/b"] = np.asarray(
            red["w2"]["b"].astype(jnp.float32))
        if e is not None:
            out[f"sync/{impl}/error"] = np.asarray(e)

    # specs that need a real mesh, and the slice each device holds
    specs: dict = {}
    slices: dict = {}
    for mname, (shape, names) in MESHES.items():
        mesh = Mesh(devs.reshape(shape), names)
        specs[f"batch/{mname}"] = [list(batch_sharding(mesh, nd).spec)
                                   for nd in (2, 3)]
        for arch in SHARD_ARCHS:
            schema = Model(reduced(get_arch(arch))).schema()
            leaves = jax.tree_util.tree_flatten_with_path(
                schema, is_leaf=is_spec)[0]
            nshard = dict(jax.tree_util.tree_flatten_with_path(
                shardings_from_schema(schema, mesh),
                is_leaf=lambda x: isinstance(x, NamedSharding))[0])
            for path, spec in leaves:
                key = "/".join(str(p.key) for p in path)
                ns = NamedSharding(mesh, pspec_for_axes(spec.axes, spec.shape,
                                                        mesh))
                specs[f"{mname}/{arch}/{key}"] = [
                    list(e) if isinstance(e, tuple) else e
                    for e in nshard[path].spec]
                idx = ns.devices_indices_map(spec.shape)
                slices[f"{mname}/{arch}/{key}"] = [
                    [[s.start or 0, dim if s.stop is None else s.stop]
                     for s, dim in zip(idx[d], spec.shape)]
                    for d in devs.reshape(-1)]
    meta["specs"] = specs
    meta["slices"] = slices

    # the sharded step's reference: JAX's grads_fn, f32, unsharded
    data = np.load(os.path.join(workdir, "inputs.npz"))
    params = jax.tree.map(jnp.asarray, nest(dict(data), "yi/"))
    batch = {k: jnp.asarray(data[f"batch/{k}"]) for k in ("tokens",
                                                          "labels")}
    jm = Model(reduced(get_arch("yi-6b")))
    for name, n in (("step", 1), ("micro", MICROBATCHES)):
        loss, jg = jax.jit(grads_fn(jm, TrainConfig(microbatches=n)))(
            params, batch)
        out[f"{name}/loss"] = np.asarray(loss)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
            out[f"{name}/grads/" + "/".join(str(p.key) for p in path)] = \
                np.asarray(leaf)
    np.savez(os.path.join(workdir, "jax.npz"), **out)
    with open(os.path.join(workdir, "jax.json"), "w") as fh:
        json.dump(meta, fh)


# --------------------------------------------------------------------------
# the gloo world
# --------------------------------------------------------------------------

def _rank_main(rank: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        world_size=N, rank=rank)
    try:
        out = _rank_cases(rank, workdir)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _recording():
    """The local shapes the sharded step's loss and attention see on this
    rank: the logits each loss path takes (the vocabulary-parallel sums,
    or _cross_entropy_sums on replicated logits), and the head counts of
    q, k and v in each attention forward and of q, out and dout in each
    flash backward and local decode attention, with whether q came as a
    DTensor (the gathered path) or as a local shard."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    seen = types.SimpleNamespace(vocab_parallel=[], replicated=[], fwd=[],
                                 bwd=[], decode=[])
    orig = (L._VocabParallelSums, L._cross_entropy_sums, A._forward_blocks,
            A._flash_bwd_pass, A.decode_attention)

    def heads(t):
        return (t.to_local() if A.is_dtensor(t) else t).shape[2]

    class VocabParallel:
        @staticmethod
        def apply(logits, *args):
            seen.vocab_parallel.append(list(logits.shape))
            return orig[0].apply(logits, *args)

    def replicated(logits, *args):
        seen.replicated.append(list(logits.shape))
        return orig[1](logits, *args)

    def fwd(q, k, v, **kw):
        seen.fwd.append([heads(q), heads(k), heads(v), A.is_dtensor(q)])
        return orig[2](q, k, v, **kw)

    def bwd(q, k, v, out, lse, dout, *args):
        seen.bwd.append([heads(q), heads(out), heads(dout),
                         A.is_dtensor(q)])
        return orig[3](q, k, v, out, lse, dout, *args)

    def decode(q, k, v, *args, **kw):
        # the module's own name: reached by on_query_shards on the local
        # heads, while the model calls the name it imported
        seen.decode.append([heads(q), heads(k), heads(v), A.is_dtensor(q)])
        return orig[4](q, k, v, *args, **kw)

    (L._VocabParallelSums, L._cross_entropy_sums, A._forward_blocks,
     A._flash_bwd_pass, A.decode_attention) = (VocabParallel, replicated,
                                               fwd, bwd, decode)
    try:
        yield seen
    finally:
        (L._VocabParallelSums, L._cross_entropy_sums, A._forward_blocks,
         A._flash_bwd_pass, A.decode_attention) = orig


def _save_seen(out: dict, prefix: str, seen) -> None:
    for k, v in vars(seen).items():
        out[f"{prefix}/seen/{k}"] = np.array(v, dtype=np.int64).reshape(
            len(v), len(v[0]) if v else 0)


def _rank_cases(rank: int, workdir: str) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.parallel.sharding import (batch_sharding,
                                               distribute_params,
                                               make_constrain, sharded_step)
    from repro_torch.train.grad_sync import make_grad_sync
    from repro_torch.train.train_step import TrainConfig, grads_fn
    from repro_torch.train.tree import leaves_with_paths, tree_map

    out: dict = {}
    inp = {k: torch.from_numpy(v) for k, v in coll_inputs().items()}
    line = init_device_mesh("cpu", (N,), mesh_dim_names=("x",))
    gx = line.get_group("x")
    for name in ("butterfly", "butterfly2", "ring", "psum",
                 "butterfly2_odd", "ring_ragged"):
        fn = C.COLLECTIVES[name.split("_")[0]]
        out[f"coll/{name}"] = fn(inp[name][rank], gx).numpy()
    for name in ("rs_ag", "rs_ag_2d"):
        rs = C.butterfly_reduce_scatter(inp[name][rank], gx)
        out[f"coll/{name}/rs"] = rs.numpy()
        out[f"coll/{name}"] = C.butterfly_all_gather(rs, gx).numpy()
    # all_reduce_under_mesh on a DTensor block keeps its placements
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    blk = DTensor.from_local(inp["butterfly"][rank][None], line, [Shard(0)])
    red = C.all_reduce_under_mesh(line, "x", "butterfly")(blk)
    out["coll/under_mesh"] = red.to_local()[0].numpy()
    out["coll/under_mesh_placements"] = np.array(str(red.placements))

    err = torch.zeros(COMPRESSED_LEN)
    for t in range(COMPRESSED_STEPS):
        red, err = compressed_psum(inp["compressed"][t][rank], gx, err)
        out[f"compressed/{t}/reduced"] = red.numpy()
        out[f"compressed/{t}/error"] = err.numpy()

    # make_grad_sync on (pod 2, data 2, model 2)
    pdm = init_device_mesh("cpu", MESHES["pdm"][0],
                           mesh_dim_names=MESHES["pdm"][1])

    def tree(g):
        return {"w1": torch.from_numpy(g["w1"]),
                "w2": {"a": torch.from_numpy(g["w2"]["a"]),
                       "b": torch.from_numpy(g["w2"]["b"]).bfloat16()}}
    rep_g, own_g = tree(replicated_grads()), tree(distinct_grads(rank))
    for impl in GRAD_IMPLS + ("ring",):
        sync = make_grad_sync(pdm, axis="pod", impl=impl)
        for label, g in (("sync", rep_g), ("own", own_g)):
            red, e = sync(g)
            for k, leaf in leaves_with_paths(red):
                out[f"{label}/{impl}/{k.split('/')[-1]}"] = \
                    leaf.float().numpy()
                out[f"{label}/{impl}/{k.split('/')[-1]}/dtype"] = \
                    np.array(str(leaf.dtype))
            out[f"{label}/{impl}/has_error"] = np.array(e is not None)
            if e is not None:
                out[f"{label}/{impl}/error"] = e.numpy()
    dm = init_device_mesh("cpu", MESHES["dm"][0],
                          mesh_dim_names=MESHES["dm"][1])
    red, e = make_grad_sync(dm, axis="pod", impl="butterfly")(own_g)
    out["noop/same_objects"] = np.array(
        red is own_g and e is None)

    # distribute_params: this rank's shard of every leaf
    for mname, (shape, names) in MESHES.items():
        mesh = pdm if mname == "pdm" else dm
        for arch in SHARD_ARCHS:
            model = Model(reduced(get_arch(arch)), device="cpu")
            params = tree_map(torch.from_numpy, numpy_params(model.schema()))
            dist_p = distribute_params(params, model.schema(), mesh)
            for k, leaf in leaves_with_paths(dist_p):
                local = leaf.to_local()
                out[f"shard/{mname}/{arch}/{k}"] = local.numpy()

    # the sharded step: reduced yi-6b on (data 2, model 4), f32
    mesh = make_host_mesh(model=4, device="cpu")
    data = np.load(os.path.join(workdir, "inputs.npz"))
    cfg = reduced(get_arch("yi-6b"))
    model = Model(cfg, device="cpu",
                  constrain=make_constrain(mesh, cfg.vocab))
    params = tree_map(torch.from_numpy, nest(dict(data), "yi/"))
    dparams = distribute_params(params, model.schema(), mesh)
    batch = {k: torch.from_numpy(data[f"batch/{k}"]).long()
             for k in ("tokens", "labels")}
    dbatch = {k: distribute_tensor(v, mesh, batch_sharding(mesh, v.ndim))
              for k, v in batch.items()}
    for name, n in (("micro", MICROBATCHES), ("step", 1)):
        with _recording() as seen:
            loss, grads = sharded_step(grads_fn(
                model, TrainConfig(microbatches=n)))(dparams, dbatch)
        _save_seen(out, name, seen)
        out[f"{name}/loss"] = loss.full_tensor().numpy()
        out[f"{name}/loss_placements"] = np.array(str(loss.placements))
        for k, g in leaves_with_paths(grads):
            out[f"{name}/grads/{k}"] = g.full_tensor().numpy()
            out[f"{name}/placements/{k}"] = np.array(str(g.placements))
    # the pending data-parallel sum, completed by make_grad_sync
    synced, _ = make_grad_sync(mesh, axis="data", impl="butterfly")(grads)
    for k, g in leaves_with_paths(synced):
        out[f"step/synced/{k}"] = g.full_tensor().numpy()
        out[f"step/synced_placements/{k}"] = np.array(str(g.placements))

    # the loss alone on logits placed by the "logits" constrain: the
    # vocabulary split 64 a rank, or replicated where it does not divide
    from repro_torch.models.layers import cross_entropy_loss
    for V in LOSS_VOCABS:
        logits = distribute_tensor(torch.from_numpy(data[f"loss/logits{V}"]),
                                   mesh, batch_sharding(mesh, 3))
        logits.requires_grad_()
        labels = distribute_tensor(torch.from_numpy(data[f"loss/labels{V}"]),
                                   mesh, batch_sharding(mesh, 2))
        placed = make_constrain(mesh, V)(logits, "logits")

        def loss_grad(x, y):
            loss = cross_entropy_loss(placed, y)
            return loss, torch.autograd.grad(loss, x)[0]
        with _recording() as seen:
            loss, g = sharded_step(loss_grad)(logits, labels)
        _save_seen(out, f"loss{V}", seen)
        out[f"loss{V}/placements"] = np.array(str(placed.placements))
        out[f"loss{V}/loss"] = loss.full_tensor().detach().numpy()
        out[f"loss{V}/grad"] = g.full_tensor().numpy()

    # prefill and a decode step on a DTensor cache: the chunked forward
    # and decode attention on the local query heads
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.dryrun import _distribute
    from repro_torch.parallel.sharding import cache_pspecs
    tokens = dbatch["tokens"]
    B, S = tokens.shape
    cache = model.init_cache(B, S + DECODE_PAD, dtype=torch.float32)
    cache = _distribute(cache, cache_pspecs(cache, mesh), mesh)
    with _recording() as seen, torch.no_grad():
        logits, cache = sharded_step(model.prefill)(dparams,
                                                    {"tokens": tokens},
                                                    cache)
        out["serve/prefill"] = logits.full_tensor().numpy()
        nxt = distribute_tensor(batch["tokens"][:, 0], mesh,
                                batch_sharding(mesh, 1))
        pos = distribute_tensor(torch.tensor(S), mesh,
                                [Replicate()] * mesh.ndim)
        logits, _ = sharded_step(model.decode_step)(dparams, nxt, cache, pos)
        out["serve/decode"] = logits.full_tensor().numpy()
    _save_seen(out, "serve", seen)
    return out


def gloo_world(workdir: str) -> None:
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(workdir,), nprocs=N, join=True)


if __name__ == "__main__":
    mode, workdir = sys.argv[1], sys.argv[2]
    {"jax": jax_world, "gloo": gloo_world}[mode](workdir)
