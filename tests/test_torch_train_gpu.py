"""Training on the card (tests marked gpu; they skip without one).

_FlashVJP's gradients on CUDA tensors against autograd through
naive_attention in f32 (no TF32), within flash_vjp_f32 and
flash_vjp_bf16_card; and two AdamW steps of reduced yi-6b on the card
against the same steps on the CPU, within loss_bf16 and
params_after_steps_bf16. This file imports no JAX: the CPU parity with
the JAX package is tests/test_torch_train_grads.py and
tests/test_torch_train.py.
"""

import numpy as np
import pytest
import torch

from repro_torch import TOLERANCES
from repro_torch.configs import get_arch, reduced
from repro_torch.models.attention import chunked_attention, naive_attention
from repro_torch.models.model import Model
from repro_torch.runtime import no_tf32
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               batches, init_adamw, make_train_step)
from repro_torch.train.tree import leaves_with_paths, tree_map


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol_name", [
    (torch.float32, "flash_vjp_f32"), (torch.bfloat16, "flash_vjp_bf16_card")])
@pytest.mark.parametrize("shape", [(2, 300, 8, 2, 64, 64),
                                   (1, 257, 4, 4, 96, 64)])
def test_flash_vjp_on_card_matches_naive_autograd(cuda_device, shape, dtype,
                                                  tol_name):
    B, S, Hq, Hkv, D, Dv = shape
    g = torch.Generator(cuda_device).manual_seed(S)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
               for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    w = torch.randn((B, S, Hq, Dv), generator=g, device=cuda_device)
    with no_tf32():
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = chunked_attention(qs, ks, vs, causal=True, kv_block=64)
        got = torch.autograd.grad((out.float() * w).sum(), (qs, ks, vs))
        qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
        ref = torch.autograd.grad(
            (naive_attention(qf, kf, vf, causal=True) * w).sum(),
            (qf, kf, vf))
    tol = TOLERANCES[tol_name]
    for a, r in zip(got, ref):
        assert tol.ok(a.float(), r), tol.excess(a.float(), r)


def _params(model, seed: int):
    """Seeded numpy parameters for `model`'s schema (bf16), on the CPU."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, spec in leaves_with_paths(model.schema()):
        a = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init == "ones":
            a = np.ones(spec.shape, np.float32)
        elif len(spec.shape) >= 2:
            a = a / np.sqrt(spec.shape[-2])
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(a).to(spec.dtype)
    return out


@pytest.mark.gpu
def test_reduced_train_steps_on_card_match_the_cpu(cuda_device):
    cfg = reduced(get_arch("yi-6b"))
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for dev in ("cpu", cuda_device):
        model = Model(cfg, remat=True, device=dev)
        params = tree_map(lambda t: t.to(dev), _params(model, 0))
        state = init_adamw(params)
        step = make_train_step(model, TrainConfig(optimizer=opt))
        stream = batches(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4))
        losses, lrs = [], []
        for _ in range(2):
            b = {k: torch.from_numpy(v).to(dev) for k, v in
                 next(stream).items()}
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
        runs[str(dev)] = (losses, sum(lrs), params)
    (cl, lr_sum, cp), (gl, _, gp) = runs["cpu"], runs[str(cuda_device)]
    for a, b in zip(gl, cl):
        assert abs(a - b) <= TOLERANCES["loss_bf16"].rtol * abs(b), (gl, cl)
    p_tol = TOLERANCES["params_after_steps_bf16"].atol * lr_sum
    for (k, a), (_, b) in zip(leaves_with_paths(gp), leaves_with_paths(cp)):
        err = float((a.float().cpu() - b.float()).abs().max())
        assert err <= p_tol, (k, err)
