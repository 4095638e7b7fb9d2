"""Parallelism: the port's collectives, compressed all-reduce, gradient
sync, parameter placement and sharded step against the JAX package's, on
the CPU.

One world of each kind serves the whole module (tests/_parallel_worlds.py):
the reference under shard_map on 8 forced host devices, as its own
tests/test_collectives.py and tests/test_grad_sync.py run it, and the port
on 8 gloo ranks (torch.multiprocessing, init_method file:// under
tmp_path). Both run at once, on the same numpy-seeded inputs. Per shard:
every collective on an 8-rank axis (rs∘ag, butterfly2 at an odd length,
the ring at a length 8 does not divide), compressed_psum over three steps
with the error carried, make_grad_sync on (pod 2, data 2, model 2) against
JAX's on replicated grads and against a numpy sum on per-rank grads,
each rank's shard from distribute_params against the slice JAX's
NamedSharding names for that device, and the sharded step: reduced yi-6b
on (data 2, model 4) in f32 against the unsharded port and JAX's
grads_fn, whole and in 2 microbatches, with the local shapes its loss
and attention saw on each rank (the vocabulary 256 split 64 a rank; 4
query heads over 2 K/V heads, one query head a rank); the loss alone on
logits of a vocabulary that divides 4 and of one that does not; and a
prefill and a decode step on a DTensor cache.
"""

import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _parallel_worlds as W
from repro_torch import TOLERANCES
from repro_torch.configs import get_arch, reduced
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import (P, batch_pspec, placements,
                                           pspecs_from_schema,
                                           shardings_from_schema)
from repro_torch.train.train_step import TrainConfig, grads_fn
from repro_torch.train.tree import leaves_with_paths, tree_map

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
IGNORED = 3                       # labels set to ignore_id a row, past the last


class Mesh:
    """A mesh stand-in: `.shape` maps axis names to sizes in mesh order."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


def _yi_inputs() -> dict:
    """f32 parameters of reduced yi-6b drawn at the schemas' init scale, and
    a batch, from numpy seeds."""
    cfg = reduced(get_arch("yi-6b"))
    rng = np.random.default_rng(7)
    out = {}
    for k, spec in leaves_with_paths(Model(cfg, device="cpu").schema()):
        if spec.init == "ones":
            a = np.ones(spec.shape, np.float32)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            scale = spec.scale or 1.0 / np.sqrt(fan_in)
            a = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
        out["yi/" + k] = a
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    out["batch/tokens"] = toks
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int64)],
                            axis=1)
    # IGNORED more labels a row, at other places in each row: every row
    # keeps as many, so the port's microbatches (each rank's rows cut in
    # turn) and the reference's (the batch reshaped) count alike
    for row in labels:
        row[rng.choice(S - 1, IGNORED, replace=False)] = -1
    out["batch/labels"] = labels
    for V in W.LOSS_VOCABS:
        out[f"loss/logits{V}"] = (rng.standard_normal((B, S, V)) * 3).astype(
            np.float32)
        out[f"loss/labels{V}"] = np.where(labels < 0, -1, labels % V)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    wd = tmp_path_factory.mktemp("parallel")
    inputs = _yi_inputs()
    np.savez(wd / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["JAX_PLATFORMS"] = "cpu"
    procs = {mode: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_parallel_worlds.py"), mode,
         str(wd)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for mode in ("jax", "gloo")}
    for mode, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"{mode} world failed:\n{out}\n{err[-6000:]}"
    import json
    return types.SimpleNamespace(
        inputs=inputs, jax=dict(np.load(wd / "jax.npz")),
        meta=json.loads((wd / "jax.json").read_text()),
        ranks=[dict(np.load(wd / f"rank{r}.npz")) for r in range(W.N)])


# --------------------------------------------------------------------------
# collectives and compression, per shard
# --------------------------------------------------------------------------

COLL_KEYS = ["butterfly", "butterfly2", "ring", "psum", "butterfly2_odd",
             "ring_ragged", "rs_ag", "rs_ag_2d", "rs_ag/rs", "rs_ag_2d/rs"]


@pytest.mark.parametrize("key", COLL_KEYS)
def test_collective_equals_jax_per_shard(worlds, key):
    """Rank r's result bit for bit the reference's shard r (every schedule
    adds in the reference's order), but the library psum, whose order of
    summation is gloo's (psum_gloo_f32); the all-reduces equal to the
    numpy sum within f32 reassociation."""
    want = worlds.jax[f"coll/{key}"]
    for r in range(W.N):
        got = worlds.ranks[r][f"coll/{key}"]
        if key == "psum":
            assert TOLERANCES["psum_gloo_f32"].ok(torch.from_numpy(got),
                                                  torch.from_numpy(want[r]))
        else:
            np.testing.assert_array_equal(got, want[r],
                                          err_msg=f"{key} rank {r}")
    if "/" not in key:
        x = W.coll_inputs()[key]
        np.testing.assert_allclose(want[0], x.sum(axis=0), rtol=1e-5,
                                   atol=1e-5)


def test_reduce_scatter_slices_and_under_mesh(worlds):
    """Rank r's reduce-scatter holds the r-th eighth of the sum; the
    DTensor form of all_reduce_under_mesh keeps its Shard(0) placement
    and equals the plain butterfly."""
    x = W.coll_inputs()["rs_ag"]
    total = x.sum(axis=0)
    for r in range(W.N):
        np.testing.assert_allclose(worlds.ranks[r]["coll/rs_ag/rs"],
                                   total[8 * r:8 * r + 8], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(worlds.ranks[r]["coll/under_mesh"],
                                      worlds.ranks[r]["coll/butterfly"])
        assert str(worlds.ranks[r]["coll/under_mesh_placements"]) == \
            "(Shard(dim=0),)"


@pytest.mark.parametrize("step", range(W.COMPRESSED_STEPS))
def test_compressed_psum_equals_jax_with_error_carried(worlds, step):
    """Each step's reduced sum and new error bit for bit JAX's per shard,
    the error of step t fed to step t + 1 on both sides; the sum within
    the reference test's 0.05 of its largest entry."""
    for r in range(W.N):
        for part in ("reduced", "error"):
            np.testing.assert_array_equal(
                worlds.ranks[r][f"compressed/{step}/{part}"],
                worlds.jax[f"compressed/{step}/{part}"][r],
                err_msg=f"step {step} {part} rank {r}")
    x = W.coll_inputs()["compressed"][step]
    exact = x.sum(axis=0)
    red = worlds.ranks[0][f"compressed/{step}/reduced"]
    assert float(np.abs(red - exact).max() / np.abs(exact).max()) < 0.05


# --------------------------------------------------------------------------
# gradient sync on (pod 2, data 2, model 2)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", W.GRAD_IMPLS)
def test_grad_sync_replicated_equals_jax(worlds, impl):
    """Replicated grads over a 2-pod axis: every rank's reduced leaves bit
    for bit JAX's make_grad_sync (the compressed error carry within
    compressed_error_jit_f32), the bf16 leaf still bf16, and 2x the input
    within the reference test's bound."""
    g = W.replicated_grads()
    want = {"w1": g["w1"], "a": g["w2"]["a"],
            "b": torch.from_numpy(g["w2"]["b"]).bfloat16().float().numpy()}
    for r in range(W.N):
        got = worlds.ranks[r]
        for leaf in ("w1", "a", "b"):
            np.testing.assert_array_equal(got[f"sync/{impl}/{leaf}"],
                                          worlds.jax[f"sync/{impl}/{leaf}"])
            tol = 0.05 if impl == "compressed" else 1e-4
            rel = np.abs(got[f"sync/{impl}/{leaf}"] - 2 * want[leaf]).max() \
                / np.abs(2 * want[leaf]).max()
            assert rel < tol, (impl, leaf, rel)
        assert str(got[f"sync/{impl}/b/dtype"]) == "torch.bfloat16"
        assert bool(got[f"sync/{impl}/has_error"]) == (impl == "compressed")
        if impl == "compressed":
            assert TOLERANCES["compressed_error_jit_f32"].ok(
                torch.from_numpy(got[f"sync/{impl}/error"]),
                torch.from_numpy(worlds.jax[f"sync/{impl}/error"]))


@pytest.mark.parametrize("impl", W.GRAD_IMPLS + ("ring",))
def test_grad_sync_distinct_equals_numpy_sum(worlds, impl):
    """Rank r's own grads summed over its pod pair (r and r ^ 4: pod is the
    major mesh axis): the f32 leaves equal numpy's f32 sum (two operands:
    exact), the bf16 leaf its bf16 rounding; compressed within 0.05 of
    each leaf's maximum, with an error carry over the whole flat vector."""
    for r in range(W.N):
        mine, peer = W.distinct_grads(r), W.distinct_grads(r ^ 4)
        got = worlds.ranks[r]
        bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
        want = {"w1": mine["w1"] + peer["w1"],
                "a": mine["w2"]["a"] + peer["w2"]["a"],
                "b": bf(bf(mine["w2"]["b"]) + bf(peer["w2"]["b"]))}
        for leaf, w in want.items():
            g = got[f"own/{impl}/{leaf}"]
            if impl == "compressed":
                assert np.abs(g - w).max() / np.abs(w).max() < 0.05, \
                    (leaf, r)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{leaf} {r}")
        assert str(got[f"own/{impl}/b/dtype"]) == "torch.bfloat16"
    if impl == "compressed":
        for r in range(W.N):
            assert worlds.ranks[r]["own/compressed/error"].shape == (8 * 16
                                                                     + 5 + 9,)


def test_grad_sync_noop_without_pod(worlds):
    for r in range(W.N):
        assert bool(worlds.ranks[r]["noop/same_objects"])


# --------------------------------------------------------------------------
# placement: distribute_params, batch_sharding, shardings_from_schema
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_params(arch: str) -> dict:
    """The full leaves the gloo ranks distributed (numpy-seeded)."""
    model = Model(reduced(get_arch(arch)), device="cpu")
    return dict(leaves_with_paths(W.numpy_params(model.schema())))


@pytest.mark.parametrize("mesh", list(W.MESHES))
@pytest.mark.parametrize("arch", W.SHARD_ARCHS)
def test_distribute_params_shard_is_jax_slice(worlds, arch, mesh):
    """Rank r's local shard of every leaf equals the full tensor at the
    slice JAX's NamedSharding(mesh, spec).devices_indices_map names for
    device r (the leading layer axis the port stacks on a one-layer
    segment taken whole)."""
    full = _port_params(arch)
    prefix = f"{mesh}/{arch}/"
    jkeys = {k[len(prefix):] for k in worlds.meta["slices"]
             if k.startswith(prefix)}
    assert jkeys == set(full), sorted(jkeys ^ set(full))
    for key, t in full.items():
        sl = worlds.meta["slices"][prefix + key]
        # the reference keeps a one-layer segment without the layer axis
        lead = (slice(None),) if len(sl[0]) == t.ndim - 1 else ()
        for r in range(W.N):
            idx = lead + tuple(slice(a, b) for a, b in sl[r])
            np.testing.assert_array_equal(
                worlds.ranks[r][f"shard/{prefix}{key}"], t[idx],
                err_msg=f"{prefix}{key} rank {r}")


def _dict_leaves(tree, prefix: str = "") -> dict:
    """{path: leaf} of nested dicts whose leaves are tuples (specs,
    placements), which leaves_with_paths would walk into."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_dict_leaves(tree[k], f"{prefix}{k}/"))
    return out


@pytest.mark.parametrize("mesh", list(W.MESHES))
def test_named_sharding_specs_equal_jax(worlds, mesh):
    """batch_sharding's spec and every leaf's shardings_from_schema spec
    as JAX's NamedShardings hold them (8 real devices), and the port's
    placements those of JAX's spec."""
    shape, names = W.MESHES[mesh]
    m = Mesh(shape, names)

    def norm(spec):
        return [tuple(e) if isinstance(e, list) else e for e in spec]
    for nd, want in zip((2, 3), worlds.meta["specs"][f"batch/{mesh}"]):
        assert list(batch_pspec(m, nd)) == norm(want)
    for arch in W.SHARD_ARCHS:
        model = Model(reduced(get_arch(arch)), device="cpu")
        specs = _dict_leaves(pspecs_from_schema(model.schema(), m))
        pls = _dict_leaves(shardings_from_schema(model.schema(), m))
        for key, spec in specs.items():
            want = norm(worlds.meta["specs"][f"{mesh}/{arch}/{key}"])
            if len(spec) == len(want) + 1:     # stacked one-layer segment
                want = [None] + want
            assert list(spec) == want, (arch, key, spec, want)
            assert pls[key] == placements(P(*want), m), (arch, key)


# --------------------------------------------------------------------------
# the sharded step
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _unsharded(microbatches: int = 1):
    inputs = _yi_inputs()
    cfg = reduced(get_arch("yi-6b"))
    params = tree_map(torch.from_numpy, W.nest(inputs, "yi/"))
    batch = {k: torch.from_numpy(inputs[f"batch/{k}"])
             for k in ("tokens", "labels")}
    loss, grads = grads_fn(Model(cfg, device="cpu"), TrainConfig(
        microbatches=microbatches))(params, batch)
    return loss, dict(leaves_with_paths(grads))


def _check_step(worlds, name: str, microbatches: int) -> None:
    """The gloo world's `name` step: loss and every full_tensor() gradient
    against the unsharded port (sharded_loss_f32, sharded_grads_f32) and
    JAX's grads_fn (loss_f32, grads_f32)."""
    got = worlds.ranks[0]
    loss, grads = _unsharded(microbatches)
    tl, tg = TOLERANCES["sharded_loss_f32"], TOLERANCES["sharded_grads_f32"]
    assert tl.ok(torch.from_numpy(got[f"{name}/loss"]), loss)
    assert TOLERANCES["loss_f32"].ok(
        torch.from_numpy(got[f"{name}/loss"]),
        torch.from_numpy(worlds.jax[f"{name}/loss"]))
    prefix = f"{name}/grads/"
    assert set(grads) == {k[len(prefix):] for k in got
                          if k.startswith(prefix)}
    for k, g in grads.items():
        mine = torch.from_numpy(got[prefix + k])
        ref = torch.from_numpy(worlds.jax[prefix + k])
        scale = float(g.abs().max())
        assert float((mine - g).abs().max()) <= tg.atol * scale, k
        assert float((mine - ref).abs().max()) <= \
            TOLERANCES["grads_f32"].atol * float(ref.abs().max()), k


def test_sharded_step_equals_unsharded_and_jax(worlds):
    """Reduced yi-6b (4 heads, 2 KV heads) on (data 2, model 4): loss and
    every full_tensor() gradient against the unsharded port (f32 sums
    split over ranks) and JAX's grads_fn (loss_f32, grads_f32). The
    divisibility guard leaves k and v replicated; the loss and the
    gradients of data-replicated weights come back Partial over data."""
    got = worlds.ranks[0]
    _check_step(worlds, "step", 1)
    assert str(got["step/loss_placements"]).startswith("(Partial(sum)")
    for key in ("layers/mlp/up", "layers/attn/q"):
        assert str(got[f"step/placements/{key}"]).startswith(
            "(Partial(sum)"), key


def test_sharded_microbatched_step_equals_unsharded_and_jax(worlds):
    """The same step in 2 microbatches, each rank's rows cut in turn
    (train_step._split_micro), against the unsharded port's and JAX's
    microbatched grads_fn. Every row ignores as many labels, so both
    packages' microbatches count alike; each microbatch's count is
    reduced over the data axis before its division."""
    _check_step(worlds, "micro", W.MICROBATCHES)
    for r in range(W.N):
        assert str(worlds.ranks[r]["micro/loss_placements"]).startswith(
            "(Partial(sum)")


@pytest.mark.parametrize("name", ["step", "micro"])
def test_sharded_loss_takes_each_ranks_vocabulary_shard(worlds, name):
    """The logits enter the loss as [B_local, S, V / 4] on every rank: the
    batch of 4 over data 2 (in 2 microbatches, 1 row a rank each), the
    vocabulary of 256 over model 4, 64 words a rank, through the
    vocabulary-parallel sums and never the replicated path."""
    n = W.MICROBATCHES if name == "micro" else 1
    want = [[B // 2 // n, S, 256 // 4]] * n
    for r in range(W.N):
        seen = worlds.ranks[r]
        assert seen[f"{name}/seen/vocab_parallel"].tolist() == want, r
        assert seen[f"{name}/seen/replicated"].size == 0, r


@pytest.mark.parametrize("name", ["step", "micro"])
def test_sharded_attention_keeps_the_query_heads_split(worlds, name):
    """Reduced yi-6b's 4 query heads over 2 K/V heads on a model axis of
    4 (Hq divides, Hkv does not): every attention forward and flash
    backward on every rank runs on local tensors with Hq / 4 = 1 query
    head, its out and dout 1 head, and the one K/V head that head reads
    (head r reads K/V head r // 2); none on a gathered DTensor."""
    n = W.MICROBATCHES if name == "micro" else 1
    layers = reduced(get_arch("yi-6b")).n_layers
    for r in range(W.N):
        seen = worlds.ranks[r]
        assert seen[f"{name}/seen/fwd"].tolist() == [[1, 1, 1, 0]] * (
            layers * n), r
        assert seen[f"{name}/seen/bwd"].tolist() == [[1, 1, 1, 0]] * (
            layers * n), r


@pytest.mark.parametrize("vocab", W.LOSS_VOCABS)
def test_loss_on_placed_logits_equals_plain(worlds, vocab):
    """cross_entropy_loss on [4, 16, V] f32 logits placed by the "logits"
    constrain, with ignored labels, and its gradient against the plain
    loss on the whole tensor: V = 256 splits 64 a rank over model
    (Shard(2)) through the vocabulary-parallel sums; V = 255 does not
    divide 4, stays replicated as act_pspec leaves it and takes
    _cross_entropy_sums on each rank's rows."""
    from repro_torch.models.layers import cross_entropy_loss
    x = torch.from_numpy(worlds.inputs[f"loss/logits{vocab}"]).requires_grad_()
    loss = cross_entropy_loss(
        x, torch.from_numpy(worlds.inputs[f"loss/labels{vocab}"]))
    grad, = torch.autograd.grad(loss, x)
    split = vocab % 4 == 0
    for r in range(W.N):
        got = worlds.ranks[r]
        assert str(got[f"loss{vocab}/placements"]) == (
            "(Shard(dim=0), Shard(dim=2))" if split
            else "(Shard(dim=0), Replicate())")
        assert TOLERANCES["sharded_loss_f32"].ok(
            torch.from_numpy(got[f"loss{vocab}/loss"]), loss.detach())
        mine = torch.from_numpy(got[f"loss{vocab}/grad"])
        assert float((mine - grad).abs().max()) <= \
            TOLERANCES["sharded_grads_f32"].atol * float(grad.abs().max())
        local = [[B // 2, S, vocab // 4 if split else vocab]]
        assert got[f"loss{vocab}/seen/vocab_parallel"].tolist() == (
            local if split else [])
        assert got[f"loss{vocab}/seen/replicated"].tolist() == (
            [] if split else local)


def test_sharded_prefill_and_decode_equal_unsharded(worlds):
    """Model.prefill on a DTensor cache (cache_pspecs: the 2 K/V heads do
    not divide model 4, so it is replicated there) and one decode step:
    the last-position logits against the unsharded port's (logits_f32),
    the chunked forward and decode attention each on 1 local query head
    and the K/V head it reads."""
    inputs = _yi_inputs()
    cfg = reduced(get_arch("yi-6b"))
    model = Model(cfg, device="cpu")
    params = tree_map(torch.from_numpy, W.nest(inputs, "yi/"))
    tokens = torch.from_numpy(inputs["batch/tokens"])
    cache = model.init_cache(B, S + W.DECODE_PAD, dtype=torch.float32)
    with torch.no_grad():
        prefill, cache = model.prefill(params, {"tokens": tokens}, cache)
        decode, _ = model.decode_step(params, tokens[:, 0], cache, S)
    for r in range(W.N):
        got = worlds.ranks[r]
        for key, want in (("prefill", prefill), ("decode", decode)):
            assert TOLERANCES["logits_f32"].ok(
                torch.from_numpy(got[f"serve/{key}"]), want), (key, r)
        assert got["serve/seen/fwd"].tolist() == [[1, 1, 1, 0]] * \
            cfg.n_layers
        assert got["serve/seen/decode"].tolist() == [[1, 1, 1, 0]] * \
            cfg.n_layers


def test_grad_sync_completes_the_sharded_sum(worlds):
    """make_grad_sync(mesh, "data", "butterfly") on the sharded step's
    DTensor gradients: every leaf Partial over data comes back Replicate
    there, and every full_tensor() equal to the step's."""
    for r in range(W.N):
        got = worlds.ranks[r]
        for k in [k for k in got if k.startswith("step/synced/")]:
            leaf = k[len("step/synced/"):]
            if r == 0:
                np.testing.assert_allclose(
                    got[k], got[f"step/grads/{leaf}"], rtol=0, atol=1e-6
                    * float(np.abs(got[f"step/grads/{leaf}"]).max()))
            assert not str(got[f"step/synced_placements/{leaf}"]) \
                .startswith("(Partial(sum)"), leaf
