"""Training's gradients: the port's Model.loss and its gradients against
jax.value_and_grad of the JAX package's, on the CPU at reduced() size.

Parameters come from the reference's init through
bridge.model_params_from_jax; tokens (and whisper's frames, the vlm's
image embeddings) from numpy seeds. For each of the seven families (yi-6b,
dbrx-132b, deepseek-v2-236b, mamba2-370m, hymba-1.5b, whisper-small with
frames, llama-3.2-vision-90b with image embeddings), with the port's
remat on: the loss and every gradient leaf with every parameter in
f32 (loss_f32, grads_f32) and in bf16 (loss_bf16, grads_bf16, which
measures each leaf against the reference's own bf16 error: its bf16
gradient against its f32 one). Also _FlashVJP against the reference's
chunked_attention gradients on the cases of tests/test_flash_vjp.py, the
saved tensors O(S D), remat on against off (equal), and
cross_entropy_loss and load_balance_loss against the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import attention as jattn
from repro.models.layers import cross_entropy_loss as jax_cross_entropy
from repro.models.model import Model as JaxModel
from repro.models.moe import load_balance_loss as jax_load_balance
from repro_torch import TOLERANCES
from repro_torch.bridge import model_params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import attention as attn
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.model import Model
from repro_torch.models.moe import load_balance_loss
from repro_torch.train.tree import leaves_with_paths

ARCHS = ("yi-6b", "dbrx-132b", "deepseek-v2-236b", "mamba2-370m",
         "hymba-1.5b", "whisper-small", "llama-3.2-vision-90b")
B, S, SRC_LEN = 2, 16, 8


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    batch = {"tokens": toks, "labels": labels}
    if cfg.encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, SRC_LEN, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str):
    """The reference's init (jitted: one compile, not one per leaf), as
    numpy arrays."""
    jm = JaxModel(reduced(get_arch(arch)))
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))


def _jax_params(arch: str, dtype: str):
    """numpy leaves, bf16 as the reference draws them or cast to f32."""
    if dtype == "float32":
        return jax.tree.map(lambda a: a.astype(np.float32), _jax_init(arch))
    return _jax_init(arch)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(arch: str, dtype: str):
    """The reference's (loss, {leaf path: f32 gradient}), with its remat
    off: jax.checkpoint changes memory, not the function, and off halves
    the compile."""
    cfg = reduced(get_arch(arch))
    jm = JaxModel(cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    loss, g = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _jax_params(arch, dtype)), batch)
    return float(loss), {k: np.asarray(v, np.float32) for k, v in
                         leaves_with_paths(jax.tree.map(np.asarray, g))}


def _port_loss_grads(arch: str, dtype: str, remat: bool = True):
    """The port's (loss, {leaf path: f32 gradient}), one-layer segments
    unstacked as the reference keeps them."""
    model = Model(t_reduced(t_get_arch(arch)), remat=remat, device="cpu")
    tp = model_params_from_jax(model, _jax_params(arch, dtype))
    leaves = [(k, v.requires_grad_()) for k, v in leaves_with_paths(tp)]
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    loss = model.loss(tp, batch)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    one = {s.name for s in model.segs if s.n == 1 and s.kind != "vlm"}
    out = {}
    for (k, _), g in zip(leaves, grads):
        g = g.float()
        out[k] = (g[0] if k.split("/")[0] in one else g).numpy()
    return float(loss), out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_f32_match_jax(arch):
    jl, jg = _jax_loss_grads(arch, "float32")
    tl, tg = _port_loss_grads(arch, "float32")
    assert abs(tl - jl) <= TOLERANCES["loss_f32"].rtol * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    atol = TOLERANCES["grads_f32"].atol
    for k, ref in jg.items():
        err = float(np.abs(tg[k] - ref).max())
        assert err <= atol * float(np.abs(ref).max()), (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_bf16_match_jax(arch):
    jl, jg = _jax_loss_grads(arch, "bfloat16")
    _, jg32 = _jax_loss_grads(arch, "float32")
    tl, tg = _port_loss_grads(arch, "bfloat16")
    assert abs(tl - jl) <= TOLERANCES["loss_bf16"].rtol * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    tol = TOLERANCES["grads_bf16"]
    for k, ref in jg.items():
        err = float(np.linalg.norm(tg[k] - ref))
        own = float(np.linalg.norm(ref - jg32[k]))
        bound = tol.rtol * own + tol.atol * float(np.linalg.norm(ref))
        assert err <= bound, (k, err, own)


def test_remat_changes_no_number():
    """Remat on against off: the same loss and gradients, bit for bit (the
    dense loop, whisper's encoder and decoder, the vlm's groups)."""
    for arch in ("yi-6b", "whisper-small", "llama-3.2-vision-90b"):
        on_l, on_g = _port_loss_grads(arch, "bfloat16", remat=True)
        off_l, off_g = _port_loss_grads(arch, "bfloat16", remat=False)
        assert on_l == off_l, arch
        for k in on_g:
            assert np.array_equal(on_g[k], off_g[k]), (arch, k)


# the cases of tests/test_flash_vjp.py, B, S, Hq, Hkv, Dk, Dv, causal, and
# one with a window (the forward loop under autograd, as the reference
# differentiates its forward-only path)
FLASH_CASES = [(2, 96, 4, 2, 32, 32, True, None),
               (1, 64, 8, 8, 16, 16, False, None),
               (2, 80, 6, 2, 32, 48, True, None),       # Dv != Dk (MLA)
               (1, 33, 4, 1, 64, 64, True, None),       # ragged block edge
               (2, 96, 4, 2, 32, 32, True, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_vjp_matches_reference(case, dtype):
    Bq, Sq, Hq, Hkv, Dk, Dv, causal, window = case
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (Bq, Sq, Hq, Dk), (Bq, Sq, Hkv, Dk), (Bq, Sq, Hkv, Dv)))
    w = rng.standard_normal((Bq, Sq, Hq, Dv)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def f(q, k, v):
        out = jattn.chunked_attention(q, k, v, causal=causal, window=window,
                                      kv_block=32)
        return (out.astype(jnp.float32) * w).sum(), out
    (_, jout), jg = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = attn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                 kv_block=32)
    tg = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                             (tq, tk, tv))
    tol = TOLERANCES["attention_f32" if dtype == "float32"
                     else "flash_vjp_bf16"]
    for got, ref in zip((out, *tg), (jout, *jg)):
        ref_t = torch.from_numpy(np.asarray(ref, np.float32))
        assert tol.ok(got.float(), ref_t), tol.excess(got.float(), ref_t)


def _saved_numels(window, kv_block):
    Bq, Sq, H, D = 1, 256, 2, 16
    q, k, v = (torch.zeros((Bq, Sq, H, D), requires_grad=True)
               for _ in range(3))
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        attn.chunked_attention(q, k, v, causal=True, window=window,
                               kv_block=kv_block).sum()
    return max(sizes), Bq * Sq * H * D


def test_flash_vjp_saves_no_score_sized_tensor():
    """_FlashVJP saves (q, k, v, out, L): O(S D), the bound of the
    reference's own test. The forward loop under autograd (a window that
    covers every key: the same numbers) saves [B, Hkv, G, S, kv_block]
    scores, past that bound at kv_block 256."""
    biggest, qkv = _saved_numels(window=None, kv_block=64)
    assert biggest <= qkv * 4, biggest
    looped, _ = _saved_numels(window=10 ** 6, kv_block=256)
    assert looped > qkv * 4, looped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((3, 10, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 10)).astype(np.int32)
    labels[0, -4:] = -1
    labels[2, :] = -1
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_cross_entropy(jnp.asarray(logits, jdt), jnp.asarray(labels))
    got = cross_entropy_loss(torch.from_numpy(logits).to(getattr(
        torch, dtype)), torch.from_numpy(labels))
    tol = TOLERANCES["loss_f32"]
    assert abs(float(got) - float(want)) <= tol.rtol * abs(float(want))
    # every label ignored: the sum over max(count, 1) is 0
    none = cross_entropy_loss(torch.from_numpy(logits),
                              torch.full((3, 10), -1))
    assert float(none) == 0.0


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (64, 2)).astype(np.int32)
    want = float(jax_load_balance(jnp.asarray(logits), jnp.asarray(idx), 8))
    got = float(load_balance_loss(torch.from_numpy(logits),
                                  torch.from_numpy(idx), 8))
    assert abs(got - want) <= TOLERANCES["loss_f32"].rtol * abs(want)
    # balanced routing with uniform router probabilities gives 1
    flat = load_balance_loss(torch.zeros((8, 4)),
                             torch.arange(8)[:, None] % 4, 4)
    assert abs(float(flat) - 1.0) < 1e-6
