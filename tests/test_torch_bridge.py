"""Foundation of the PyTorch port: it loads no JAX, the parameter bridge is
bit-exact, and entry points never fall back to the CPU on their own."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models.model import Model as JaxModel
from repro_torch import HOST_SYNCS, resolve_device, to_host
from repro_torch.bridge import model_params_from_jax, params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.kernels.systolic_gemm import ops
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]

_NO_JAX = r"""
import pkgutil, sys
sys.modules["jax"] = None        # any import of jax or repro now fails
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None  # bf16 checkpoints go through torch views
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(m.name)
import chip_smoke
assert sys.modules["jax"] is None and sys.modules["repro"] is None
assert "repro_torch.serve.graphs" in sys.modules
for m in ("train.optimizer", "train.train_step", "train.checkpoint",
          "train.data", "train.tree", "launch.train", "train.grad_sync",
          "launch.mesh", "parallel.collectives", "parallel.compression",
          "parallel.sharding", "parallel.autoshard", "launch.dryrun",
          "roofline.analysis", "roofline.report", "core.executor",
          "tenancy.sweep"):
    assert "repro_torch." + m in sys.modules, m
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    # every module was imported: flash attention, paging, the SSD kernel
    # package, the SSM model, the MoE model, the step runners, the
    # training modules and the parallel ones included
    assert int(proc.stdout.split()[1]) >= 32


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bridge_bit_exact(arch: str):
    """Convert reduced(arch)'s reference parameters; every leaf must keep
    its name, shape, dtype and bits. Returns the port's tree."""
    cfg = reduced(get_arch(arch))
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    model = Model(t_reduced(t_get_arch(arch)), device="cpu")
    schema = dict(_leaves(model.schema()))
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tleaves = dict(_leaves(tp))
    assert set(tleaves) == set(jleaves) == set(schema)
    for name, a in jleaves.items():
        t = tleaves[name]
        assert tuple(t.shape) == a.shape == schema[name].shape, name
        assert str(t.dtype).endswith(a.dtype.name), name
        bits = np.int16 if a.dtype.itemsize == 2 else np.int32
        got = t.view(torch.int16 if bits is np.int16 else torch.int32)
        assert np.array_equal(got.numpy(), a.view(bits)), name
    return tp


def test_bridge_is_bit_exact_name_for_name():
    _bridge_bit_exact("granite-8b")


def test_bridge_keeps_the_moe_router_in_f32():
    """dbrx's tree: the router stays f32 (its ParamSpec's dtype) beside
    bf16 experts, bit for bit."""
    tp = _bridge_bit_exact("dbrx-132b")
    assert tp["moe"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-370m", "dbrx-132b",
                                  "whisper-small"])
def test_model_aware_bridge_is_params_from_jax_on_stacked_segments(arch):
    """Every segment of these has more than one layer (whisper's encoder
    subtree is stacked in both packages): the model-aware form converts
    exactly as params_from_jax does, to the port's schema."""
    tp = _bridge_bit_exact(arch)
    cfg = reduced(get_arch(arch))
    jp = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0)))
    model = Model(t_reduced(t_get_arch(arch)), device="cpu")
    assert all(seg.n > 1 for seg in model.segs)
    got = dict(_leaves(model_params_from_jax(model, jp)))
    assert got.keys() == dict(_leaves(tp)).keys()
    for name, t in _leaves(tp):
        assert torch.equal(got[name], t), name


def test_model_aware_bridge_stacks_one_layer_segments():
    """reduced(hymba): glob0 | swa_tail, one layer each, which the
    reference keeps unstacked. Each of their leaves gains the leading
    layer axis of the port's schema, bits unchanged; embed and ln_f are
    converted as they are."""
    cfg = reduced(get_arch("hymba-1.5b"))
    jp = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0)))
    model = Model(t_reduced(t_get_arch("hymba-1.5b")), device="cpu")
    assert [(s.name, s.n) for s in model.segs] == [("glob0", 1),
                                                   ("swa_tail", 1)]
    tp = model_params_from_jax(model, jp)
    schema = dict(_leaves(model.schema()))
    jleaves = dict(_leaves(jp))
    tleaves = dict(_leaves(tp))
    assert set(tleaves) == set(jleaves) == set(schema)
    for name, a in jleaves.items():
        t = tleaves[name]
        stacked = name.split("/")[1] in ("glob0", "swa_tail")
        assert tuple(t.shape) == schema[name].shape == (
            (1,) + a.shape if stacked else a.shape), name
        bits = np.int16 if a.dtype.itemsize == 2 else np.int32
        got = t.view(torch.int16 if bits is np.int16 else torch.int32)
        assert np.array_equal(got.numpy().reshape(a.shape), a.view(bits)), \
            name


def test_model_aware_bridge_lands_on_the_models_device():
    """model_params_from_jax puts the leaves on the model's device unless
    the caller names another (a card model's weights go to the card); a
    model on the meta device gets meta leaves of the schema's shapes."""
    cfg = reduced(get_arch("hymba-1.5b"))
    jp = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0)))
    meta = Model(t_reduced(t_get_arch("hymba-1.5b")), device="meta")
    got = dict(_leaves(model_params_from_jax(meta, jp)))
    schema = dict(_leaves(meta.schema()))
    assert got.keys() == schema.keys()
    for name, t in got.items():
        assert t.device.type == "meta", name
        assert tuple(t.shape) == schema[name].shape, name
    cpu = dict(_leaves(model_params_from_jax(meta, jp, device="cpu")))
    assert all(t.device.type == "cpu" for t in cpu.values())
    on_cpu = Model(t_reduced(t_get_arch("hymba-1.5b")), device="cpu")
    for name, t in _leaves(model_params_from_jax(on_cpu, jp)):
        assert torch.equal(t, cpu[name]), name


def test_port_init_follows_the_schema():
    """init(generator) draws the reference's schema: ones for norms,
    normal with fan-in scale for projections, deterministic per seed."""
    model = Model(t_reduced(t_get_arch("granite-8b")), device="cpu")
    p1 = model.init(torch.Generator().manual_seed(0))
    p2 = model.init(torch.Generator().manual_seed(0))
    for (name, a), (_, b) in zip(_leaves(p1), _leaves(p2)):
        assert torch.equal(a, b), name
        assert a.dtype == torch.bfloat16
    assert torch.equal(p1["ln_f"]["scale"], torch.ones(64, dtype=torch.bfloat16))
    up = p1["layers"]["mlp"]["up"].float()            # [L, d, ff], fan-in d
    assert abs(float(up.std()) - 64 ** -0.5) < 0.01
    assert abs(float(p1["embed"]["tok"].float().std()) - 1.0) < 0.05


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(t_reduced(t_get_arch("granite-8b")))
    assert resolve_device("cpu") == torch.device("cpu")


def test_gemm_runs_only_on_cpu_or_cuda():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.systolic_gemm(x, torch.zeros((4, 3), device="meta"))


def test_to_host_counts_every_read():
    before = HOST_SYNCS.count
    out = to_host(torch.arange(3))
    to_host(torch.ones(2))
    assert HOST_SYNCS.count - before == 2
    assert isinstance(out, np.ndarray) and out.tolist() == [0, 1, 2]
