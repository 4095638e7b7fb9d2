"""Multi-pod dry-run: prove the distribution config is coherent
(counterpart of repro/launch/dryrun.py).

For every (architecture x applicable shape x mesh) cell, the sharded step
runs on fake tensors over a fake process group of `chips` ranks:

    init_process_group("fake") -> make_production_mesh -> FakeTensorMode
        -> build_cell (DTensor arguments) -> step under CellCounter and
        MemTracker -> memory, FLOP, byte and collective counts per device

Nothing is allocated and nothing moves: the fake group answers every
collective without data, and fake tensors hold shapes only. The counts
are rank 0's, one device of the mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    ... --device cpu      # fake CPU tensors on a CPU mesh, no card needed

Placeholder tensors are fake "cuda" tensors on a "cuda" mesh by default
(the card is what the dry-run models; torch must be built for CUDA);
`--device cpu` gives fake CPU tensors on a "cpu" mesh, the same counts.
Results land in reports/dryrun_torch/<mesh>/<arch>__<shape>.json, which
repro_torch.roofline.report reads.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time
import traceback

import torch

from ..configs import SHAPES, applicable_shapes, get_arch, list_archs
from ..models.layers import param_count
from ..models.model import Model
from ..parallel.sharding import (ATTN_SP_RULES, P, batch_axes, cache_pspecs,
                                 distribute_params, fsdp_pspecs_from_schema,
                                 make_constrain, placements,
                                 pspecs_from_schema, sharded_step,
                                 zero1_pspec)
from ..roofline.analysis import (HBM_PER_CHIP, CellCounter, Roofline,
                                 from_counts, model_flops, nbytes)
from ..runtime import resolve_device
from ..train.optimizer import AdamWConfig, AdamWState, adamw_update
from ..train.train_step import TrainConfig, grads_fn
from .mesh import make_production_mesh, mesh_shape_dict

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")


def kv_replication(cfg, mesh) -> int:
    """Virtual-KV factor so decode caches shard over the model axis."""
    m = mesh_shape_dict(mesh).get("model", 1)
    kv = max(1, cfg.n_kv_heads)
    if cfg.mla is not None or cfg.family == "ssm":
        return 1
    if kv < m and m % kv == 0 and cfg.n_heads % m == 0:
        return m // kv
    return 1


def input_specs(arch: str, shape_name: str, mesh=None) -> dict:
    """(shape, dtype) stand-ins for every model input of a cell (public
    entry used by the dry-run; no allocation)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S if not shape.is_decode else 1), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = ((B, S), torch.int32)
    if cfg.encoder_decoder and not shape.is_decode:
        specs["frames"] = ((B, S, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm" and not shape.is_decode:
        specs["image_embeds"] = ((B, cfg.n_image_tokens, cfg.d_model),
                                 torch.bfloat16)
    return specs


def _microbatches(arch: str, shape_name: str) -> int:
    """Grad-accum for the big train cells (activation fit)."""
    if shape_name != "train_4k":
        return 1
    return {"nemotron-4-340b": 4, "llama-3.2-vision-90b": 2,
            "deepseek-v2-236b": 2, "dbrx-132b": 2}.get(arch, 1)


def calibration_cfgs(cfg):
    """Two reduced-DEPTH (same width!) variants whose segments hold 1 vs
    2 layers, plus the per-layer extrapolation count.

    The reference needs them because XLA's cost analysis counts a scan
    body once. The port traces every layer (its layers are a Python loop),
    so its full-depth count needs no extrapolation; run_cell makes both
    traces all the same, and its roofline reads
        total(L) = f(1) + (f(2) - f(1)) * extra
    as the reference's does, so the two packages' reports compare term
    for term.
    """
    fam = cfg.family
    if fam == "vlm":
        g = cfg.cross_attn_every
        return (dataclasses.replace(cfg, n_layers=g),
                dataclasses.replace(cfg, n_layers=2 * g),
                cfg.n_layers // g - 1)
    if fam == "hybrid":
        c1 = dataclasses.replace(cfg, n_layers=2, global_attn_layers=(0,))
        c2 = dataclasses.replace(cfg, n_layers=3, global_attn_layers=(0,))
        # globals cost ~= SWA layers (masking is free); 1 global is in f;
        # remaining layers (incl. the other globals) extrapolate as SWA.
        return c1, c2, cfg.n_layers - 2
    if cfg.moe and cfg.moe.first_dense_layers:
        fd = cfg.moe.first_dense_layers
        return (dataclasses.replace(cfg, n_layers=fd + 1),
                dataclasses.replace(cfg, n_layers=fd + 2),
                cfg.n_layers - fd - 1)
    if cfg.encoder_decoder:
        return (dataclasses.replace(cfg, n_layers=1, n_encoder_layers=1),
                dataclasses.replace(cfg, n_layers=2, n_encoder_layers=2),
                cfg.n_layers - 1)
    return (dataclasses.replace(cfg, n_layers=1),
            dataclasses.replace(cfg, n_layers=2), cfg.n_layers - 1)


def _int32_indices(cache):
    """The cache with its int64 index tensors (lengths, page tables) in
    int32, the reference's dtype, so that a cell's argument bytes compare
    with the reference's to the byte (the serve engine keeps int64)."""
    def cast(t):
        return t.to(torch.int32) if t.dtype == torch.int64 else t
    if isinstance(cache, dict):
        return {k: _int32_indices(v) for k, v in cache.items()}
    if dataclasses.is_dataclass(cache):
        return dataclasses.replace(cache, **{
            f.name: cast(getattr(cache, f.name))
            for f in dataclasses.fields(cache)})
    return cast(cache)


def _distribute(tree, specs, mesh):
    """Each tensor of `tree` (dicts, cache dataclasses) distributed with
    the P at the same place in `specs`."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _distribute(getattr(tree, f.name),
                                getattr(specs, f.name), mesh)
            for f in dataclasses.fields(tree)})
    return distribute_tensor(tree, mesh, placements(specs, mesh))


def build_cell(arch: str, shape_name: str, mesh, seq_shard: bool = True,
               include_optimizer: bool = True, cfg_override=None,
               microbatches: int | None = None, opts: dict | None = None,
               device=None):
    """Returns (fn, args, donate): the step and its arguments as DTensors
    on `mesh`, ready to trace. Call it under a FakeTensorMode (the
    arguments are then fake tensors on `device`, the card by default) with
    the fake group that holds `mesh`.

    opts — hillclimb knobs, as in the reference:
      moe_dispatch: "onehot"|"sort"      (MoE data-movement strategy)
      moe_group_size, router_bf16, opt_bf16
      mla_seq_shard / kv_seq_shard: bool (cache sequence sharding)
      attn_seq_parallel: bool            (ATTN_SP_RULES)
      kv_block: int                      (chunked-attention block size)
      remat: bool                        (default: on for train cells)
    """
    opts = opts or {}
    dev = resolve_device(device)
    cfg = cfg_override if cfg_override is not None else get_arch(arch)
    if opts.get("moe_dispatch") and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=opts["moe_dispatch"]))
    if opts.get("moe_group_size") and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=opts["moe_group_size"]))
    if opts.get("router_bf16") and cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_dtype="bfloat16"))
    shape = SHAPES[shape_name]
    kv_rep = kv_replication(cfg, mesh) if shape.is_decode else 1
    attn_sp = opts.get("attn_seq_parallel", False)
    use_sp = (seq_shard and shape.kind == "train") or \
        (attn_sp and not shape.is_decode)
    constrain = make_constrain(mesh, cfg.vocab, seq_shard=use_sp)
    model = Model(cfg, device=dev, kv_rep=kv_rep, constrain=constrain,
                  remat=opts.get("remat", shape.kind == "train"),
                  kv_block=opts.get("kv_block", 1024))

    sch = model.schema()
    # FSDP (params dp-sharded, per-layer gather/reduce-scatter) for every
    # train cell and for serving cells whose TP-sharded weights would not
    # fit a 16 GB chip alongside the KV cache (the reference's threshold)
    rules = ATTN_SP_RULES if attn_sp else None
    tp = mesh_shape_dict(mesh).get("model", 1)
    params_gb_tp = param_count(sch) * 2 / tp / 2 ** 30
    use_fsdp = shape.kind == "train" or params_gb_tp > 8.0
    p_specs = (fsdp_pspecs_from_schema(sch, mesh, rules) if use_fsdp
               else pspecs_from_schema(sch, mesh, rules))
    params = distribute_params(model.shapes(), sch, mesh, specs=p_specs)

    dp = batch_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    batch = {k: _distribute(torch.empty(s, dtype=dt, device=dev),
                            P(*((dpa,) + (None,) * (len(s) - 1))), mesh)
             for k, (s, dt) in input_specs(arch, shape_name, mesh).items()}

    if shape.kind == "train":
        ub = microbatches if microbatches is not None else \
            _microbatches(arch, shape_name)
        ocfg = AdamWConfig(
            moment_dtype="bfloat16" if opts.get("opt_bf16") else "float32")
        tcfg = TrainConfig(microbatches=ub, optimizer=ocfg)
        gf = grads_fn(model, tcfg)
        if include_optimizer:
            @sharded_step
            def step(params, opt_state, batch):
                loss, grads = gf(params, batch)
                new_params, new_opt, om = adamw_update(
                    tcfg.optimizer, opt_state, grads)
                return new_params, new_opt, {"loss": loss, **om}

            # ZeRO-1: master/m/v sharded over DP axes on top of TP
            def z1(dt, s=sch, ps=p_specs):
                if isinstance(s, dict):
                    return {k: z1(dt, s[k], ps[k]) for k in s}
                return _distribute(torch.empty(s.shape, dtype=dt, device=dev),
                                   zero1_pspec(ps, s.shape, mesh), mesh)
            mdt = torch.bfloat16 if opts.get("opt_bf16") else torch.float32
            opt = AdamWState(
                _distribute(torch.zeros((), dtype=torch.int32, device=dev),
                            P(), mesh),
                z1(torch.float32), z1(mdt), z1(mdt))
            return step, (params, opt, batch), (0, 1)

        return sharded_step(gf), (params, batch), ()

    # serving cells
    max_len = shape.seq_len
    src_len = shape.seq_len if cfg.encoder_decoder else cfg.n_image_tokens
    cache = _int32_indices(model.init_cache(shape.global_batch, max_len,
                                            src_len=src_len))
    c_specs = cache_pspecs(cache, mesh,
                           mla_seq_shard=opts.get("mla_seq_shard", False),
                           kv_seq_shard=opts.get("kv_seq_shard", False))
    cache = _distribute(cache, c_specs, mesh)

    if shape.kind == "prefill":
        @sharded_step
        def step(params, batch, cache):
            return model.prefill(params, batch, cache)
        return step, (params, batch, cache), (2,)

    # decode / long_decode: one token against a filled cache
    tokens = _distribute(
        torch.empty((shape.global_batch,), dtype=torch.int32, device=dev),
        P(dpa if shape.global_batch > 1 else None), mesh)
    position = _distribute(torch.zeros((), dtype=torch.int32, device=dev),
                           P(), mesh)

    @sharded_step
    def step(params, tokens, cache, position):
        return model.decode_step(params, tokens, cache, position)
    return step, (params, tokens, cache, position), (2,)


def _local_tensors(tree) -> list:
    """The local shard (rank 0's) of every tensor in a tree of dicts,
    tuples, lists and cache dataclasses."""
    from torch.distributed.tensor import DTensor
    out = []

    def walk(t):
        if isinstance(t, DTensor):
            out.append(t.to_local())
        elif isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))
    walk(tree)
    return out


@contextlib.contextmanager
def fake_world(chips: int):
    """A fake process group of `chips` ranks (this process is rank 0),
    destroyed on every exit path. Refuses to start beside a default group:
    the group is process-global."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError(
            "a default process group exists: the dry-run opens a fake group "
            "of its own and cannot share the process with another")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        yield
    finally:
        dist.destroy_process_group()


# DTensor's metadata work: its sharding propagation (which runs each op
# once more at its global shape to learn the output's layout) and a
# strided shard's local size (worked out from a small index tensor)
_META_WORK = (("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
               ("propagate", "propagate_op_sharding",
                "propagate_op_sharding_non_cached",
                "_propagate_tensor_meta", "_propagate_tensor_meta_non_cached")),
              ("torch.distributed.tensor.placement_types", "_StridedShard",
               ("local_shard_size_and_offset",
                "_local_shard_size_and_offset")))


@contextlib.contextmanager
def _dtensor_patches():
    """DTensor's metadata work runs outside the trace's modes, for the
    trace only. Under them, the sharding propagation's global-shape ops
    would pass the counters and the memory tracker as the device's own
    (torch 2.13's MemTracker skips them, 2.11's does not, and a 512-rank
    cell then reads hundreds of GB above its arguments), and a strided
    shard's index tensor would be fake, its values unknown, so that the
    propagation of any op meeting one (an einsum flattening two sharded
    axes) raises. Outside, the propagation makes fake tensors of its own
    and the index tensor is real, a few elements long.

    Besides, the planner of a redistribution caches its plans, but not
    while a fake mode is on (it takes that for a compile, where shapes
    may be symbolic); the trace's shapes are all static, so its plans are
    cached here too."""
    import importlib

    from torch.utils._python_dispatch import _disable_current_modes

    def outside(orig):
        fn = orig.__func__ if isinstance(orig, (staticmethod, classmethod)) \
            else orig

        @functools.wraps(fn)
        def run(*a, **kw):
            with _disable_current_modes():
                return fn(*a, **kw)
        return type(orig)(run) if isinstance(
            orig, (staticmethod, classmethod)) else run

    done = []
    try:
        for mod, cls_name, names in _META_WORK:
            try:
                cls = getattr(importlib.import_module(mod), cls_name)
            except (ImportError, AttributeError):
                continue
            for name in names:
                orig = cls.__dict__.get(name)
                if orig is not None:
                    setattr(cls, name, outside(orig))
                    done.append((cls, name, orig))
        try:
            from torch.distributed.tensor import _redistribute as redist
        except ImportError:
            redist = None
        orig = getattr(redist, "_gen_transform_infos_non_cached", None)
        if orig is not None:
            redist._gen_transform_infos_non_cached = functools.cache(orig)
            done.append((redist, "_gen_transform_infos_non_cached", orig))
        yield
    finally:
        for obj, name, orig in reversed(done):
            setattr(obj, name, orig)


def _trace_cell(arch, shape_name, mesh, memory: bool = False, device=None,
                **kw) -> dict:
    """One traced step of a cell on fake tensors: its CellCounter and, with
    memory, the bytes of its arguments, the MemTracker peak above them and
    its outputs' bytes, per device (rank 0)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), _dtensor_patches():
        fn, args, _ = build_cell(arch, shape_name, mesh, device=device, **kw)
        local = _local_tensors(args)
        counter = CellCounter()
        out: dict = {"counter": counter}
        if not memory:
            with counter:
                fn(*args)
            return out
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        mt.track_external(*local)
        dev = local[0].device.type
        before = _total(mt.get_tracker_snapshot("current"), dev)
        with counter, mt:
            res = fn(*args)
        peak = _total(mt.get_tracker_snapshot("peak"), dev)
        out.update(argument_size_in_bytes=sum(map(nbytes, local)),
                   temp_size_in_bytes=max(0, peak - before),
                   output_size_in_bytes=sum(map(nbytes,
                                                _local_tensors(res))))
        return out


def _total(snapshot: dict, device_type: str) -> int:
    """The Total of a MemTracker snapshot on the devices of a type."""
    return sum(v for dev, snap in snapshot.items()
               if torch.device(dev).type == device_type
               for k, v in snap.items() if str(k).lower().endswith("total"))


def _terms(counter, chips, name="", kinds: dict | None = None):
    rl = from_counts(name, counter, chips)
    if kinds is not None and rl.collective_by_kind:
        for k, v in rl.collective_by_kind.items():
            kinds[k] = kinds.get(k, 0) + v
    return (rl.flops_per_device, rl.bytes_per_device,
            rl.collective_bytes_per_device)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             seq_shard: bool = True, save: bool = True,
             include_optimizer: bool = True, tag: str = "",
             calibrate: bool = True, opts: dict | None = None,
             device=None) -> dict:
    """One dry-run cell: the full-depth trace (memory fit and counts) and
    the 1- and 2-layer calibration traces of calibration_cfgs. The
    `*_scanned` keys keep the reference's names for the full-depth trace's
    counts; nothing is scanned here, every layer is traced and counted.
    `device` is the fake tensors' and the mesh's: the card by default."""
    chips = 512 if multi_pod else 256
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    t0 = time.time()
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "chips": chips, "status": "ok", "opts": opts or {}}
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            result.update(_trace_and_price(
                arch, shape_name, mesh, chips, calibrate, device,
                seq_shard=seq_shard, include_optimizer=include_optimizer,
                opts=opts))
        result["compile_s"] = round(time.time() - t0, 1)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        result["compile_s"] = round(time.time() - t0, 1)
    if save:
        outdir = os.path.join(REPORT_DIR, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        fname = f"{arch}__{shape_name}{tag}.json"
        with open(os.path.join(outdir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def _trace_and_price(arch, shape_name, mesh, chips, calibrate, device,
                     **kw) -> dict:
    """run_cell's traces and their roofline; kw are build_cell's."""
    cfg, shape = get_arch(arch), SHAPES[shape_name]
    result: dict = {}
    full = _trace_cell(arch, shape_name, mesh, memory=True, device=device,
                       **kw)
    f_raw, b_raw, c_raw = _terms(full["counter"], chips)
    result.update({"flops_per_device_scanned": f_raw,
                   "bytes_per_device_scanned": b_raw,
                   "collective_bytes_per_device_scanned": c_raw})

    if calibrate:
        c1, c2, extra = calibration_cfgs(cfg)
        ckw = dict(kw, microbatches=1, device=device)
        k1: dict = {}
        k2: dict = {}
        f1 = _terms(_trace_cell(arch, shape_name, mesh, cfg_override=c1,
                                **ckw)["counter"], chips, kinds=k1)
        f2 = _trace_cell(arch, shape_name, mesh, cfg_override=c2, **ckw)
        f2 = _terms(f2["counter"], chips, kinds=k2)
        # per-layer deltas clamped >= 0, as in the reference
        flops, nbytes, coll = (a + max(0.0, b - a) * extra
                               for a, b in zip(f1, f2))
        result["calibration"] = {"l1": f1, "l2": f2, "extra_layers": extra}
        result["collective_by_kind_per_device"] = {
            k: k1.get(k, 0) + (k2.get(k, 0) - k1.get(k, 0)) * extra
            for k in set(k1) | set(k2)}
    else:
        flops, nbytes, coll = f_raw, b_raw, c_raw

    rl = Roofline(name=f"{arch}__{shape_name}", chips=chips,
                  flops_per_device=flops, bytes_per_device=nbytes,
                  collective_bytes_per_device=coll)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                   ("train", "prefill") else 1)
    # 6ND convention: N excludes the input-embedding table (a gather,
    # not matmul flops); the unembedding projection stays counted.
    n_active = cfg.active_params_estimate() - cfg.vocab * cfg.d_model
    mf = model_flops(n_active, tokens, train=shape.kind == "train")
    result.update(rl.to_dict(mf))
    for attr in ("temp_size_in_bytes", "argument_size_in_bytes",
                 "output_size_in_bytes"):
        result[attr] = int(full[attr])
    args_b = result["argument_size_in_bytes"]
    tmp_b = result["temp_size_in_bytes"]
    result["hbm_fit"] = bool((args_b + tmp_b) <= HBM_PER_CHIP)
    result["hbm_gb_per_chip"] = (args_b + tmp_b) / 2 ** 30
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--no-optimizer", action="store_true")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--device", type=str, default=None,
                    help="device of the fake tensors and the mesh: the card "
                         "by default, 'cpu' to trace without one")
    args = ap.parse_args(argv)

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in applicable_shapes(get_arch(arch)):
                cells.append((arch, shape))
    else:
        assert args.arch and args.shape
        cells = [(args.arch, args.shape)]

    for mp in meshes:
        for arch, shape in cells:
            r = run_cell(arch, shape, multi_pod=mp,
                         seq_shard=not args.no_seq_shard,
                         include_optimizer=not args.no_optimizer,
                         tag=args.tag, device=args.device)
            flag = "OK " if r["status"] == "ok" else "ERR"
            extra = (f"hbm={r.get('hbm_gb_per_chip', 0):.2f}GB "
                     f"bottleneck={r.get('bottleneck')}"
                     if r["status"] == "ok" else r.get("error", ""))
            print(f"[{flag}] {r['mesh']:16s} {arch:22s} {shape:12s} "
                  f"compile={r['compile_s']:7.1f}s {extra}", flush=True)


if __name__ == "__main__":
    main()
