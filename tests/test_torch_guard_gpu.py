"""The SDC guard on the card (tests marked gpu; they skip without one).

The guarded GEMM launches the Hopper pod-GEMM kernel at the augmented,
ragged shape (abft) or at the GEMM's own (probe): held against its plain
version, with a planted element located and repaired (abft) or detected
(probe). A guarded engine, graphed and eager, with SDC injected: equal
tokens, guard events and injector counts. This file imports no JAX: the
CPU parity with the JAX package is tests/test_torch_guard.py.
"""

import numpy as np
import pytest
import torch

from repro_torch import TOLERANCES
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.kernels.systolic_gemm import guard as tguard
from repro_torch.kernels.systolic_gemm import ref as gemm_ref
from repro_torch.models.model import Model
from repro_torch.serve.chaos import ChaosConfig, VirtualClock
from repro_torch.serve.engine import Request, ServeEngine


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=500)
    assert all(s is None for s in eng.active), "slot leak"
    return {r.rid: (r.state, r.reason, list(r.out)) for r in reqs}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("mode", ["abft", "probe"])
def test_guarded_kernel_matches_plain_on_card(cuda_device, mode, transpose):
    """The guarded GEMM on the card (the Hopper kernel at the augmented,
    ragged shape) against its plain version on the same inputs; a planted
    element is located and repaired (abft) or detected (probe)."""
    g = torch.Generator(cuda_device).manual_seed(0)
    M, K, N = 4, 1024, 520
    x = torch.randn((M, K), generator=g, device=cuda_device).bfloat16()
    w = torch.randn((N, K) if transpose else (K, N), generator=g,
                    device=cuda_device).bfloat16()
    guard = tguard.PodGuard(mode=mode)
    got = tguard.guarded_gemm(x, w, guard=guard, activation="relu2",
                              transpose=transpose)
    plain = (gemm_ref.systolic_gemm_t_ref if transpose
             else gemm_ref.systolic_gemm_ref)(x, w, activation="relu2")
    tol = TOLERANCES["gemm_bf16_f32out"]
    assert tol.ok(got, plain), tol.excess(got, plain)
    plan = torch.tensor([0, 5, 1], device=cuda_device)
    with tguard.GuardTape(guard, inject=plan) as tape:
        hit = tguard.guarded_gemm(x, w, guard=guard, transpose=transpose)
    corr, unc = (int(t) for t in tape.totals())
    if mode == "abft":
        assert (corr, unc) == (1, 0)
        raw = (gemm_ref.systolic_gemm_t_ref if transpose
               else gemm_ref.systolic_gemm_ref)(x, w)
        assert tol.ok(hit, raw), tol.excess(hit, raw)
    else:
        assert (corr, unc) == (0, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-370m"])
def test_guarded_graphs_equal_guarded_eager(cuda_device, arch):
    """A guarded engine graphed and eager on the card, with SDC injected:
    equal tokens, guard events and injector counts, every call after a
    runner's first a replay."""
    model = Model(t_reduced(t_get_arch(arch)), use_pallas=True,
                  ssd_impl="pallas" if arch.startswith("mamba") else "jnp")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 60, 17, 9)]
    out = {}
    for eager in (True, False):
        eng = ServeEngine(model, params, slots=4, max_len=128,
                          guard="abft", clock=VirtualClock(), eager=eager,
                          chaos=ChaosConfig(seed=7, p_sdc=0.5,
                                            transient_tries=1))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        out[eager] = (_drain(eng, reqs), dict(eng.guard_events),
                      dict(eng._chaos.injected))
        if not eager:
            assert eng.stats["graphs"] == (eng.prefill_compiles +
                                           eng.decode_compiles)
    assert out[True] == out[False]
    assert out[False][2]["sdc"] > 0 and out[False][1]["corrected"] > 0
