"""The vision-language family on the card (tests marked gpu; they skip
without one).

Reduced llama-3.2-vision-90b (one group: a dense block and a cross_layer
block, d 64, 4 heads over 2) on CUDA tensors with use_pallas and flash
prefill, against the same calls on the CPU (the kernels' plain versions),
within logits_bf16_vlm; the kernel launches of a prefill and a decode
step; a graphed engine against an eager one on requests that each carry
their own image. This file imports no JAX: the CPU parity with the JAX
package is tests/test_torch_vlm.py.
"""

import numpy as np
import pytest
import torch

from repro_torch import TOLERANCES
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.systolic_gemm.systolic_gemm import systolic_gemm_cuda
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "llama-3.2-vision-90b"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _close(got, ref, scale: float):
    tol = TOLERANCES["logits_bf16_vlm"]
    err = (got.float().cpu() - ref.float()).abs()
    assert bool((err <= tol.atol * scale + tol.rtol * ref.float().abs())
                .all()), f"max_abs_err {float(err.max())} of {scale}"


def _images(seed: int, cfg, device="cpu"):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)


@pytest.mark.gpu
def test_reduced_vlm_on_card_launches_the_kernels(cuda_device):
    """A 6-token prefill with bf16 image embeddings, then a decode step:
    logits within logits_bf16_vlm of the CPU's; a prefill launches 11
    pod GEMMs (the dense block's q, k, v, o, gate, up, down, the cross
    layer's gate, up, down, the head) and 1 flash, a decode step 11 and
    no flash."""
    cfg = reduced(get_arch(ARCH))
    cpu = Model(cfg, attention_impl="pallas", use_pallas=True, device="cpu")
    card = Model(cfg, attention_impl="pallas", use_pallas=True,
                 device=cuda_device)
    tp = cpu.init(torch.Generator().manual_seed(0))
    tp_card = _to(tp, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 6)))
    im = _images(60, cfg)
    counts = lambda: (systolic_gemm_cuda.launches,
                      flash_attention_cuda.launches)
    ref, rc = cpu.prefill(tp, {"tokens": toks, "image_embeds": im},
                          cpu.init_cache(1, 16))
    cache = card.init_cache(1, 16)
    n0 = counts()
    got, cache = card.prefill(tp_card, {"tokens": toks.to(cuda_device),
                                        "image_embeds": im.to(cuda_device)},
                              cache)
    torch.cuda.synchronize()
    n1 = counts()
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (11, 1)
    scale = float(ref.float().abs().max())
    _close(got, ref, scale)
    tok = ref.argmax(-1)
    ref, _ = cpu.decode_step(tp, tok, rc, 6)
    n0 = counts()
    got, _ = card.decode_step(tp_card, tok.to(cuda_device), cache, 6)
    torch.cuda.synchronize()
    n1 = counts()
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (11, 0)
    _close(got, ref, scale)


@pytest.mark.gpu
def test_reduced_vlm_graphed_equals_eager(cuda_device):
    """Three requests of 4, 9 and 6 tokens, each with its own image, 5 new
    tokens, slots 2: the graphed engine's tokens equal the eager engine's,
    and its cross cache holds n_image_tokens rows a slot."""
    cfg = reduced(get_arch(ARCH))
    model = Model(cfg, attention_impl="pallas", use_pallas=True,
                  device=cuda_device)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (4, 9, 6)]
    outs = []
    for eager in (False, True):
        eng = ServeEngine(model, params, slots=2, max_len=32, eager=eager)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=5, extras={
            "image_embeds": _images(80 + i, cfg, cuda_device)})
            for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_steps=100)
        assert all(r.done for r in reqs)
        outs.append([r.out for r in reqs])
        assert eng.cache["blocks"]["cross"].k.shape[2] == cfg.n_image_tokens
    assert outs[0] == outs[1]
