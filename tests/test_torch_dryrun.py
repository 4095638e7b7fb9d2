"""The port's dry-run (repro_torch/launch/dryrun.py) and roofline
(repro_torch/roofline/) against the reference's on the CPU.

The reference's side runs once per module in a subprocess over 8 forced
host devices (tests/_dryrun_world.py): importing repro.launch.dryrun sets
XLA_FLAGS to 512 devices, which must not reach the JAX tests that share
this worker. The port traces on fake tensors over a fake process group in
this process (run_cell and fake_world open it and destroy it on every
exit path).

Held equal: input_specs for all 40 (arch, shape) pairs, calibration_cfgs
and _microbatches for every arch, kv_replication on both production mesh
shapes, and the per-device argument bytes of three reduced granite-8b
cells on (data 2, model 4) to the byte of XLA's memory_analysis(). The
port counts every layer it traces, so its full-depth count equals the
calibration's extrapolation (FLOPs and collective bytes exactly). Then the H100 Roofline terms, the
report tables, the 512-rank granite-8b decode_32k cell through the CLI,
and that importing the dry-run opens no process group. On a fake group of
16 ranks: the sharded loss's peak scales with each rank's vocabulary
shard, and a reduced GQA prefill's peak and FLOPs fall 16-fold with the
query heads kept split.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (SHAPES, get_arch, list_archs, reduced)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline import analysis, report
from repro_torch.roofline.analysis import (HBM_PER_CHIP, LINK_BW, PEAK_FLOPS,
                                           CellCounter, Roofline, from_counts)

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [f"{a}/{s}" for a in sorted(
    ["granite-8b", "yi-6b", "minitron-8b", "nemotron-4-340b", "mamba2-370m",
     "dbrx-132b", "deepseek-v2-236b", "hymba-1.5b", "whisper-small",
     "llama-3.2-vision-90b"]) for s in
    ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
ARCHS = sorted({p.split("/")[0] for p in PAIRS})
CELLS = ("train_4k", "decode_32k", "prefill_32k")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_jax") / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "tests/_dryrun_world.py"),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_the_pairs_are_the_reference_matrix():
    assert sorted(list_archs()) == ARCHS
    assert len(PAIRS) == 40 and set(SHAPES) == {"train_4k", "prefill_32k",
                                                "decode_32k", "long_500k"}


@pytest.mark.parametrize("pair", PAIRS)
def test_input_specs_equal_jax(jax_side, pair):
    arch, shape = pair.split("/")
    got = {k: [list(s), str(dt).replace("torch.", "")]
           for k, (s, dt) in dryrun.input_specs(arch, shape).items()}
    assert got == jax_side["input_specs"][pair]
    assert dryrun._microbatches(arch, shape) == \
        jax_side["microbatches"][pair]


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_cfgs_equal_jax(jax_side, arch):
    c1, c2, extra = dryrun.calibration_cfgs(get_arch(arch))
    j1, j2, jextra = jax_side["calibration"][arch]
    norm = lambda d: json.loads(json.dumps(d, default=str))   # noqa: E731
    assert norm(dataclasses.asdict(c1)) == j1
    assert norm(dataclasses.asdict(c2)) == j2
    assert extra == jextra


class _ShapeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("mesh_name", ["pod_16x16", "multipod_2x16x16"])
def test_kv_replication_equal_jax(jax_side, mesh_name):
    shape = {"pod_16x16": {"data": 16, "model": 16},
             "multipod_2x16x16": {"pod": 2, "data": 16,
                                  "model": 16}}[mesh_name]
    for arch in ARCHS:
        assert dryrun.kv_replication(get_arch(arch), _ShapeMesh(shape)) == \
            jax_side["kv_replication"][f"{arch}/{mesh_name}"], arch


def _reduced_cell(arch, shape, cfg=None, memory=True, microbatches=1,
                  **kw):
    """One traced cell of reduced(arch) on 8 fake ranks, (data 2, model
    4), fake CPU tensors."""
    cfg = cfg or reduced(get_arch(arch))
    with dryrun.fake_world(8):
        mesh = make_host_mesh(model=4, device="cpu")
        return dryrun._trace_cell(arch, shape, mesh, memory=memory,
                                  device="cpu", cfg_override=cfg,
                                  microbatches=microbatches, **kw)


@pytest.mark.parametrize("shape", CELLS)
def test_argument_bytes_equal_xla(jax_side, shape):
    """The sum of every argument's local shard on rank 0 (params, AdamW
    state and batch; params, cache and batch or token) equals XLA's
    per-device argument_size_in_bytes: 4,425,924, 268,502,916 and
    136,381,312 in the reference's compile."""
    r = _reduced_cell("granite-8b", shape)
    assert r["argument_size_in_bytes"] == jax_side["argument_bytes"][shape]
    assert r["temp_size_in_bytes"] > 0 and r["counter"].flops > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape", [("granite-8b", "train_4k"),
                                        ("dbrx-132b", "prefill_32k")])
def test_full_depth_count_equals_the_extrapolation(arch, shape):
    """Every layer is traced, so at 3 layers the full count is the 1- and
    2-layer calibration traces' c1 + (c2 - c1) * extra: FLOPs and
    collective bytes exactly, a dense arch's train step with AdamW and an
    MoE arch's prefill. Bytes accessed within a millionth: a few small
    ops do not grow by whole layers."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), n_layers=3)
    c1, c2, extra = dryrun.calibration_cfgs(cfg)
    assert (c1.n_layers, c2.n_layers, extra) == (1, 2, 2)
    full, one, two = (_reduced_cell(arch, shape, c, memory=False)["counter"]
                      for c in (cfg, c1, c2))
    for key in ("flops", "bytes", "collective_total"):
        f, a, b = (getattr(c, key) for c in (full, one, two))
        assert b > a > 0 or (key == "collective_total" and b >= a), key
        if key == "bytes":
            assert f == pytest.approx(a + (b - a) * extra, rel=1e-6)
        else:
            assert f == a + (b - a) * extra, key


def test_microbatches_split_each_ranks_rows():
    """dbrx's train cell takes 2 microbatches (_microbatches): a batch
    sharded over data is cut on each rank (DTensor cannot unflatten the
    sharded axis the reference reshapes), the same products on half the
    rows twice: the step's FLOPs equal one microbatch's, and its
    activations' peak falls."""
    one = _reduced_cell("dbrx-132b", "train_4k")
    two = _reduced_cell("dbrx-132b", "train_4k", microbatches=2)
    assert two["counter"].flops == one["counter"].flops
    assert two["argument_size_in_bytes"] == one["argument_size_in_bytes"]
    assert two["temp_size_in_bytes"] < one["temp_size_in_bytes"]


def test_counter_counts_local_shards_and_collectives():
    """A [64 x 32] @ [32 x 48] product with the rows over data and the
    columns over model: the per-device FLOPs of the local shards (rank 0's
    [32 x 32] @ [32 x 12]), and an all-gather of the product's columns
    counted at its operand's bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(8):
        mesh = make_host_mesh(model=4, device="cpu")
        with FakeTensorMode(), dryrun._dtensor_patches():
            x = distribute_tensor(torch.empty(64, 32), mesh,
                                  (Shard(0), Replicate()))
            w = distribute_tensor(torch.empty(32, 48), mesh,
                                  (Replicate(), Shard(1)))
            c = CellCounter()
            with c:
                y = x @ w
                y.redistribute(mesh, (Shard(0), Replicate()))
    assert c.flops == 2 * 32 * 32 * 12
    assert c.collective["all-gather"] == 32 * 12 * 4
    assert c.collective_total == c.collective["all-gather"]
    rl = from_counts("x", c, 8)
    assert rl.collective_by_kind == c.collective
    assert rl.flops_per_device == c.flops


def _loss_peak(vocab: int, B: int = 4, S: int = 1024):
    """MemTracker's peak above the inputs of the sharded loss and its
    gradient on fake bf16 logits [B, S, vocab] of a fake 16-rank group,
    (data 1, model 16), placed as the unembedding leaves them (the
    vocabulary over model where it divides), with the local logits'
    shape and placements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.parallel.sharding import make_constrain, sharded_step
    with dryrun.fake_world(16):
        mesh = make_host_mesh(model=16, device="cpu")
        constrain = make_constrain(mesh, vocab)
        with FakeTensorMode(), dryrun._dtensor_patches():
            x = distribute_tensor(
                torch.empty(B, S, vocab, dtype=torch.bfloat16), mesh,
                (Shard(0), Shard(2) if vocab % 16 == 0 else Replicate()))
            x.requires_grad_()
            y = distribute_tensor(torch.empty(B, S, dtype=torch.int64), mesh,
                                  (Shard(0), Replicate()))

            def loss_grad(x, y):
                loss = cross_entropy_loss(constrain(x, "logits"), y)
                return torch.autograd.grad(loss, x)[0]
            mt = MemTracker()
            mt.track_external(x.to_local(), y.to_local())
            before = dryrun._total(mt.get_tracker_snapshot("current"), "cpu")
            with mt:
                sharded_step(loss_grad)(x, y)
            peak = dryrun._total(mt.get_tracker_snapshot("peak"), "cpu")
            placed = constrain(x, "logits")
            return (peak - before, tuple(placed.to_local().shape),
                    placed.placements)


def test_sharded_loss_peak_scales_with_the_vocabulary_shard():
    """The loss of the sharded step never gathers a vocabulary that the
    "logits" constrain splits: at fixed B S = 4096 its peak above the
    logits is two f32 copies of the rank's [4, 1024, V / 16] shard (the
    forward's f32 cast beside exp(x - max), the backward's cast beside
    the gradient it makes in place; 2.0053 and 2.0026 of a copy at V =
    16000 and 32000) and doubles with V. A gathered vocabulary would hold
    at least one f32 copy of all V, 16 shards. hymba's 32001 words do not
    divide 16: they stay replicated, and _cross_entropy_sums holds five
    f32 copies of the whole vocabulary as on one card."""
    from torch.distributed.tensor import Replicate, Shard
    peaks = {}
    for vocab in (16 * 1000, 16 * 2000):
        peak, local, placements = _loss_peak(vocab)
        assert local == (4, 1024, vocab // 16)
        assert placements == (Shard(0), Shard(2))
        shard_f32 = 4 * 1024 * (vocab // 16) * 4
        assert 2.0 * shard_f32 <= peak <= 2.01 * shard_f32, peak / shard_f32
        peaks[vocab] = peak
    assert 1.99 <= peaks[32000] / peaks[16000] <= 2.01
    peak, local, placements = _loss_peak(32001)
    assert local == (4, 1024, 32001)
    assert placements == (Shard(0), Replicate())
    assert peak >= 5 * 4 * 1024 * 32001 * 4


def test_gqa_prefill_keeps_query_heads_split_on_16_ranks():
    """A reduced GQA prefill_32k cell (reduced yi-6b widened to yi-6b's 32
    query heads over 4 K/V heads) on a fake group of 16 ranks, (data 1,
    model 16): 4 K/V heads do not divide 16, 32 query heads do. With the
    query heads kept split (attention.on_query_shards) the step's peak
    above its arguments and its FLOPs a rank are each at least 15 times
    below the gathered path's (attention.query_head_dims forced empty:
    every head on every rank; 15.7 and 15.9 when written)."""
    from repro_torch.models import attention
    cfg = dataclasses.replace(reduced(get_arch("yi-6b")), n_heads=32,
                              n_kv_heads=4)
    split = _reduced_cell_16("yi-6b", "prefill_32k", cfg)
    orig = attention.query_head_dims
    attention.query_head_dims = lambda q, k, v: ()
    try:
        gathered = _reduced_cell_16("yi-6b", "prefill_32k", cfg)
    finally:
        attention.query_head_dims = orig
    assert split["argument_size_in_bytes"] == \
        gathered["argument_size_in_bytes"]
    assert gathered["temp_size_in_bytes"] >= 15 * split["temp_size_in_bytes"]
    assert gathered["counter"].flops >= 15 * split["counter"].flops


def _reduced_cell_16(arch, shape, cfg):
    """One traced cell of `cfg` on 16 fake ranks, (data 1, model 16)."""
    with dryrun.fake_world(16):
        mesh = make_host_mesh(model=16, device="cpu")
        return dryrun._trace_cell(arch, shape, mesh, memory=True,
                                  device="cpu", cfg_override=cfg,
                                  microbatches=1)


def test_roofline_terms_and_bottleneck():
    """tests/test_roofline_sharding.py's case at the H100's rates."""
    assert (PEAK_FLOPS, analysis.HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    assert HBM_PER_CHIP == 85_017_493_504
    r = Roofline(name="x", chips=256, flops_per_device=989e12,
                 bytes_per_device=3.35e12 * 2,
                 collective_bytes_per_device=450e9 * 0.5)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 2.0) < 1e-9
    assert abs(r.collective_s - 0.5) < 1e-9
    assert r.bottleneck == "memory" and r.bound_s == r.memory_s
    mf = 989e12 * 256  # exactly 1s of useful work at peak
    assert abs(r.roofline_fraction(mf) - 0.5) < 1e-9
    assert abs(r.model_flops_ratio(mf) - 1.0) < 1e-12
    assert set(r.to_dict(mf)) == {
        "name", "chips", "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "compute_s", "memory_s",
        "collective_s", "bottleneck", "model_flops", "model_flops_ratio",
        "roofline_fraction"}


def test_report_tables_from_fixture_rows(tmp_path):
    rows = [
        {"arch": "yi-6b", "shape": "decode_32k", "status": "ok",
         "hbm_gb_per_chip": 3.5, "hbm_fit": True, "compile_s": 4.2,
         "compute_s": 1e-5, "memory_s": 2e-3, "collective_s": 1e-4,
         "bottleneck": "memory", "model_flops_ratio": 0.5,
         "roofline_fraction": 0.0025},
        {"arch": "yi-6b", "shape": "train_4k", "status": "ok",
         "hbm_gb_per_chip": 120.0, "hbm_fit": False, "compile_s": 30.0,
         "compute_s": 2.0, "memory_s": 1.0, "collective_s": 3.0,
         "bottleneck": "collective", "model_flops_ratio": 0.9,
         "roofline_fraction": 0.6},
        {"arch": "granite-8b", "shape": "prefill_32k", "status": "error",
         "error": "RuntimeError: no rule", "compile_s": 1.0}]
    d = tmp_path / "pod_16x16"
    d.mkdir()
    for r in rows:
        (d / f"{r['arch']}__{r['shape']}.json").write_text(json.dumps(r))
    (d / "yi-6b__train_4k_tagged.json").write_text(json.dumps(rows[1]))
    got = report.load("pod_16x16", report_dir=str(tmp_path))
    assert [(r["arch"], r["shape"]) for r in got] == [
        ("granite-8b", "prefill_32k"), ("yi-6b", "train_4k"),
        ("yi-6b", "decode_32k")]
    table = report.fmt_dryrun_table(got).splitlines()
    assert table[0] == ("| arch | shape | status | HBM GB/chip | fit79.2GiB "
                        "| trace s |")
    assert table[2] == ("| granite-8b | prefill_32k | ERROR: RuntimeError: "
                        "no rule | — | — | 1.0 |")
    assert table[3] == "| yi-6b | train_4k | ok | 120.00 | N | 30 |"
    assert table[4] == "| yi-6b | decode_32k | ok | 3.50 | Y | 4 |"
    roof = report.fmt_roofline_table(got).splitlines()
    assert len(roof) == 4
    assert roof[2] == ("| yi-6b | train_4k | 2 | 1 | 3 | collective | "
                       "0.90 | 0.600 |")
    assert report.pick_hillclimb(got) == [
        ("yi-6b", "decode_32k", "worst roofline fraction"),
        ("yi-6b", "train_4k", "most collective-bound")]
    assert Path(report.REPORT_DIR).resolve() == \
        (ROOT / "reports" / "dryrun_torch").resolve()


def test_multipod_cell_through_the_cli_on_cpu():
    """The reference's slow test's cell, full width and depth, 512 fake
    ranks: `python -m repro_torch.launch.dryrun --arch granite-8b --shape
    decode_32k --multi-pod --device cpu`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-8b", "--shape", "decode_32k", "--multi-pod", "--device",
         "cpu", "--tag", "_test"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    assert len(line) == 1 and line[0].startswith(
        "[OK ] multipod_2x16x16 granite-8b             decode_32k "), line
    path = Path(dryrun.REPORT_DIR) / "multipod_2x16x16" / \
        "granite-8b__decode_32k_test.json"
    r = json.loads(path.read_text())
    path.unlink()
    assert r["status"] == "ok" and r["chips"] == 512
    assert r["compute_s"] > 0 and r["collective_s"] >= 0
    assert r["calibration"]["extra_layers"] == 35
    # every layer is traced: the full count is the extrapolation's
    assert r["flops_per_device_scanned"] == r["flops_per_device"]
    assert r["hbm_fit"] and 0 < r["hbm_gb_per_chip"] < HBM_PER_CHIP / 2 ** 30


def test_import_opens_no_group_and_run_cell_leaves_none():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun as d\n"
            "assert not dist.is_initialized()\n"
            "r = d.run_cell('mamba2-370m', 'decode_32k', save=False, "
            "calibrate=False, device='cpu')\n"
            "assert r['status'] == 'ok', r.get('error')\n"
            "assert not dist.is_initialized()\n"
            "print('ok', r['chips'])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok", "256"]


def test_run_cell_refuses_beside_a_default_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        r = dryrun.run_cell("yi-6b", "decode_32k", save=False,
                            calibrate=False, device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert r["status"] == "error"
    assert "a default process group exists" in r["error"]
