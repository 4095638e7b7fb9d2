"""Training's optimizer, step, checkpoints, data stream and launcher
against the JAX package's, on the CPU at reduced() size.

adamw_update against the reference's on the same gradients (f32 and bf16
moments); lr_schedule at warmup, peak and end; three steps of the
reference's arithmetic in f32 (grads_fn and adamw_update with f32 params),
plain and with microbatches=4: losses, grad norms, params and moments;
three bf16 train steps (make_train_step) beside the reference's; the loss
falling over 30 steps (the reference's test); checkpoints: a round trip, a
torn checkpoint ignored, a flipped byte raising CheckpointCorrupt, and
checkpoints crossing between the two packages in both directions (reduced
yi: every segment has more than one layer); the data stream resuming; the
launcher's kill and resume; and the refusals that keep gradients from
being lost in a kernel without a backward. Parameters come from the
reference's init through the bridge; tolerances from runtime.TOLERANCES.
"""

import os
import tempfile
from contextlib import redirect_stdout
from io import StringIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models.model import Model as JaxModel
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro.train.data import DataConfig as JaxDataConfig, batches as jbatches
from repro_torch import TOLERANCES
from repro_torch.bridge import model_params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.systolic_gemm import ops as sg_ops
from repro_torch.launch import train as launch
from repro_torch.models.model import Model
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               batches, init_adamw, latest_step,
                               lr_schedule, make_train_step,
                               restore_checkpoint, save_checkpoint)
from repro_torch.train.checkpoint import CheckpointCorrupt
from repro_torch.train.optimizer import AdamWState, adamw_update
from repro_torch.train.train_step import grads_fn
from repro_torch.train.tree import leaves_with_paths, tree_map

OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)


def _setup(arch: str = "yi-6b", dtype=np.float32):
    """(JAX model, port model, reference params, port params): the
    reference's init, cast to f32 where asked."""
    jm = JaxModel(reduced(get_arch(arch)), remat=True)
    tm = Model(t_reduced(t_get_arch(arch)), remat=True, device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jm, tm, jp, model_params_from_jax(tm, jax.tree.map(np.asarray,
                                                              jp))


def _flat(tree) -> dict:
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else
                          np.asarray(v, np.float32), np.float32)
            for k, v in leaves_with_paths(tree)}


def _stream(cfg, seq=16, batch=8, start=0):
    return batches(DataConfig(vocab=cfg.vocab, seq_len=seq,
                              global_batch=batch), start_step=start)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """Two updates from the same state on the same bf16 gradients (the
    first large enough to clip, the second not): params bit-equal, master
    and moments within adamw_f32, grad_norm and lr within it too."""
    _, _, jp, tp = _setup(dtype=None)
    rng = np.random.default_rng(5)
    jcfg = jopt.AdamWConfig(moment_dtype=moments, **OPT)
    tcfg = AdamWConfig(moment_dtype=moments, **OPT)
    js, ts = jopt.init_adamw(jp, jcfg), init_adamw(tp, tcfg)
    tol = TOLERANCES["adamw_f32"]
    for scale in (1.0, 1e-3):
        g_np = jax.tree.map(lambda a: (scale * rng.standard_normal(
            a.shape)).astype(np.float32), jax.tree.map(np.asarray, jp))
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g_np)
        tg = tree_map(lambda a: a.to(torch.bfloat16),
                      model_params_from_jax(Model(t_reduced(t_get_arch(
                          "yi-6b")), device="cpu"), g_np))
        jp2, js, jm = jopt.adamw_update(jcfg, js, jg)
        tp2, ts, tm = adamw_update(tcfg, ts, tg)
        assert tp2["embed"]["tok"].dtype == torch.bfloat16
        for a, b in ((_flat(tp2), _flat(jax.tree.map(np.asarray, jp2))),):
            for k in b:
                assert np.array_equal(a[k], b[k]), k
        for name in ("master", "m", "v"):
            a = _flat(getattr(ts, name))
            b = _flat(jax.tree.map(np.asarray, getattr(js, name)))
            for k in b:
                assert tol.ok(torch.from_numpy(a[k]), torch.from_numpy(
                    b[k])), (name, k)
        for key in ("grad_norm", "lr"):
            assert tol.ok(tm[key].reshape(1), torch.tensor(
                [float(jm[key])])), key
        assert int(ts.step) == int(js.step)


def test_lr_schedule_matches_reference():
    c = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    jc = jopt.AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 5, 10, 55, 100, 120):
        want = float(jopt.lr_schedule(jc, jnp.asarray(step)))
        got = float(lr_schedule(c, torch.tensor(step)))
        assert TOLERANCES["adamw_f32"].ok(torch.tensor([got]),
                                          torch.tensor([want])), step
    # the reference's own checks: warmup, peak, end at 10% of the peak
    assert float(lr_schedule(c, torch.tensor(0))) < 1e-4
    assert abs(float(lr_schedule(c, torch.tensor(10))) - 1e-3) < 1e-4
    assert float(lr_schedule(c, torch.tensor(100))) < 2.1e-4


@pytest.mark.parametrize("microbatches", [1, 4])
def test_three_f32_steps_match_reference(microbatches):
    """The reference's step arithmetic with every parameter in f32
    (grads_fn, then adamw_update with compute_dtype f32): losses within
    loss_f32, grad norms within grad_norm_f32, params within
    params_after_steps_f32 (atol in units of lr_peak), m and v within
    moments_f32."""
    jm, tm, jp, tp = _setup()
    jc, tc = jopt.AdamWConfig(**OPT), AdamWConfig(**OPT)
    jg = jax.jit(jstep.grads_fn(jm, jstep.TrainConfig(
        microbatches=microbatches)))
    tg = grads_fn(tm, TrainConfig(microbatches=microbatches))
    jup = jax.jit(lambda s, g: jopt.adamw_update(jc, s, g, jnp.float32))
    js, ts = jopt.init_adamw(jp), init_adamw(tp)
    stream = _stream(tm.cfg)
    for _ in range(3):
        b = next(stream)
        jl, jgr = jg(jp, {k: jnp.asarray(v) for k, v in b.items()})
        jp, js, jmx = jup(js, jgr)
        tl, tgr = tg(tp, {k: torch.from_numpy(v) for k, v in b.items()})
        tp, ts, tmx = adamw_update(tc, ts, tgr, compute_dtype=torch.float32)
        assert abs(float(tl) - float(jl)) <= \
            TOLERANCES["loss_f32"].rtol * abs(float(jl))
        assert TOLERANCES["grad_norm_f32"].ok(
            tmx["grad_norm"].reshape(1), torch.tensor([float(
                jmx["grad_norm"])]))
    p_tol = TOLERANCES["params_after_steps_f32"].atol * OPT["lr_peak"]
    got, want = _flat(tp), _flat(jax.tree.map(np.asarray, jp))
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) <= p_tol, k
    for name in ("m", "v"):
        got = _flat(getattr(ts, name))
        want = _flat(jax.tree.map(np.asarray, getattr(js, name)))
        atol = TOLERANCES["moments_f32"].atol
        for k in want:
            err = float(np.abs(got[k] - want[k]).max())
            assert err <= atol * float(np.abs(want[k]).max()), (name, k)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_three_bf16_train_steps_beside_reference(microbatches):
    """make_train_step as the launcher runs it (bf16 params, f32 master):
    losses within loss_bf16, grad norms within grad_norm_bf16, params
    within params_after_steps_bf16 (atol in units of the summed learning
    rates)."""
    jm, tm, jp, tp = _setup(dtype=None)
    jfn = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig(
        microbatches=microbatches, optimizer=jopt.AdamWConfig(**OPT))))
    tfn = make_train_step(tm, TrainConfig(microbatches=microbatches,
                                          optimizer=AdamWConfig(**OPT)))
    js, ts = jopt.init_adamw(jp), init_adamw(tp)
    stream, lr_sum = _stream(tm.cfg), 0.0
    for _ in range(3):
        b = next(stream)
        jp, js, jmx = jfn(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tmx = tfn(tp, ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        lr_sum += float(jmx["lr"])
        assert abs(float(tmx["loss"]) - float(jmx["loss"])) <= \
            TOLERANCES["loss_bf16"].rtol * abs(float(jmx["loss"]))
        assert TOLERANCES["grad_norm_bf16"].ok(
            tmx["grad_norm"].reshape(1), torch.tensor([float(
                jmx["grad_norm"])]))
        assert TOLERANCES["adamw_f32"].ok(tmx["lr"].reshape(1),
                                          torch.tensor([float(jmx["lr"])]))
    p_tol = TOLERANCES["params_after_steps_bf16"].atol * lr_sum
    got, want = _flat(tp), _flat(jax.tree.map(np.asarray, jp))
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) <= p_tol, k


def test_loss_decreases_over_steps():
    """tests/test_train_serve.py::test_loss_decreases_over_steps on the
    port: reduced granite-8b, 30 steps."""
    _, tm, _, tp = _setup("granite-8b", dtype=None)
    fn = make_train_step(tm, TrainConfig(optimizer=AdamWConfig(
        lr_peak=5e-3, warmup_steps=3, total_steps=60, weight_decay=0.0)))
    opt = init_adamw(tp)
    stream, losses = _stream(tm.cfg, seq=32), []
    for _ in range(30):
        b = {k: torch.from_numpy(v) for k, v in next(stream).items()}
        tp, opt, m = fn(tp, opt, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_checkpoint_roundtrip_torn_and_corrupt():
    _, tm, _, tp = _setup(dtype=None)
    tree = (tp, init_adamw(tp))
    with tempfile.TemporaryDirectory() as d:
        assert latest_step(d) is None
        assert restore_checkpoint(d, tree) == (None, None)
        save_checkpoint(d, 10, tree)
        path = save_checkpoint(d, 20, tree)
        os.makedirs(os.path.join(d, "step_00000030"))      # torn: ignored
        assert latest_step(d) == 20
        back, step = restore_checkpoint(d, tree)
        assert step == 20 and isinstance(back[1], AdamWState)
        for (ka, a), (kb, b) in zip(leaves_with_paths(tree),
                                    leaves_with_paths(back)):
            assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
        # one flipped byte: the sha256 gate names the shard
        shard = os.path.join(path, "shard_0.npz")
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(CheckpointCorrupt) as err:
            restore_checkpoint(d, tree)
        assert err.value.path == shard
        # the older checkpoint is intact
        assert restore_checkpoint(d, tree, step=10)[1] == 10


def test_checkpoints_cross_between_packages():
    """The port's checkpoint restores through the reference's
    restore_checkpoint, and the reference's through the port's: the same
    keys, dtypes (bf16 as uint16 bits) and values, both directions."""
    jm, tm, jp, tp = _setup(dtype=None)
    jtree = (jp, jopt.init_adamw(jp))
    ttree = (tp, init_adamw(tp))
    rng = np.random.default_rng(2)
    # distinct moments, so that a swapped leaf would show
    ttree = (tp, ttree[1]._replace(
        m=tree_map(lambda a: torch.from_numpy(rng.standard_normal(
            a.shape).astype(np.float32)), ttree[1].m),
        step=torch.tensor(7, dtype=torch.int32)))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(os.path.join(d, "port"), 3, ttree)
        back, step = jckpt.restore_checkpoint(os.path.join(d, "port"), jtree)
        assert step == 3
        got = dict(leaves_with_paths(jax.tree.map(np.asarray, back)))
        for k, t in leaves_with_paths(ttree):
            a = got[k]
            if t.dtype == torch.bfloat16:
                assert a.dtype.name == "bfloat16", k
                assert np.array_equal(a.view(np.int16),
                                      t.view(torch.int16).numpy()), k
            else:
                assert np.array_equal(a, t.numpy()), k
        jsaved = (jp, jopt.init_adamw(jp)._replace(
            v=jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
                a.shape), jnp.float32), jp)))
        jckpt.save_checkpoint(os.path.join(d, "jax"), 5, jsaved)
        back, step = restore_checkpoint(os.path.join(d, "jax"), ttree)
        assert step == 5
        want = dict(leaves_with_paths(jax.tree.map(np.asarray, jsaved)))
        for k, t in leaves_with_paths(back):
            a = want[k]
            if a.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16, k
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16)), k
            else:
                assert np.array_equal(t.numpy(), a), k


def test_data_stream_is_the_reference_and_resumes():
    dcfg = DataConfig(vocab=100, seq_len=16, global_batch=4)
    s1 = batches(dcfg, start_step=0)
    for _ in range(5):
        next(s1)
    b5 = next(s1)
    b5_resumed = next(batches(dcfg, start_step=5))
    np.testing.assert_array_equal(b5["tokens"], b5_resumed["tokens"])
    want = next(jbatches(JaxDataConfig(vocab=100, seq_len=16,
                                       global_batch=4), start_step=5))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b5[k], want[k])


def _launch(argv) -> tuple[object, list[str]]:
    out = StringIO()
    code = 0
    with redirect_stdout(out):
        try:
            launch.main(argv)
        except SystemExit as e:
            code = e.code
    return code, [ln.rsplit(" (", 1)[0] for ln in out.getvalue().splitlines()
                  if ln.startswith("step ")]


def test_launcher_kill_and_resume_on_cpu():
    """--kill-at 4 exits 42 after the step-3 checkpoint; --resume goes on
    from it and prints the losses of a run that was not killed."""
    base = ["--reduced", "--device", "cpu", "--steps", "7", "--seq", "32",
            "--ckpt-every", "3"]
    with tempfile.TemporaryDirectory() as d:
        code, _ = _launch(base + ["--ckpt-dir", os.path.join(d, "a"),
                                  "--kill-at", "4"])
        assert code == 42
        code, resumed = _launch(base + ["--ckpt-dir", os.path.join(d, "a"),
                                        "--resume"])
        assert code == 0
        code, whole = _launch(base + ["--ckpt-dir", os.path.join(d, "b")])
        assert code == 0
    assert resumed == whole[1:] and len(resumed) == 2, (resumed, whole)


def test_kernel_wrappers_refuse_autograd():
    """A kernel wrapper given an input that requires grad raises on the CPU
    as on the card (its Hopper kernel has no backward); under no_grad, or
    on inputs that do not require grad, it runs its plain version."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 6)
    g = torch.randn(2, 4, 8)
    calls = [
        lambda x: sg_ops.systolic_gemm(x, w),
        lambda x: sg_ops.systolic_gemm_t(x, w.T.contiguous()),
        lambda x: sg_ops.fused_lane_gemm(x, w),
        lambda x: sg_ops.grouped_gemm(g + 0 * x.sum(), torch.randn(2, 8, 6)),
        lambda x: fl_ops.flash_attention(
            x.reshape(1, 4, 2, 4), x.reshape(1, 4, 2, 4).detach(),
            x.reshape(1, 4, 2, 4).detach()),
        lambda x: ssd_ops.ssd(
            x.reshape(1, 4, 2, 4), torch.rand(1, 4, 2), -torch.rand(2),
            torch.randn(1, 4, 1, 4), torch.randn(1, 4, 1, 4), torch.ones(2),
            chunk=4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="Pallas kernels either"):
            call(x)
        with torch.no_grad():
            call(x)
        call(x.detach())


@pytest.mark.parametrize("kw", [dict(use_pallas=True),
                                dict(attention_impl="pallas"),
                                dict(ssd_impl="pallas")])
def test_train_step_refuses_a_kernel_model(kw):
    model = Model(t_reduced(t_get_arch("yi-6b")), device="cpu", **kw)
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(model, TrainConfig())
    with pytest.raises(ValueError, match="no backward"):
        grads_fn(model, TrainConfig(microbatches=2))
