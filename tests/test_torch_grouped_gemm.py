"""The port's grouped pod GEMM against the JAX package's.

On the CPU `repro_torch...ops.grouped_gemm` runs its plain version
(`grouped_systolic_gemm_ref`, per group the arithmetic of
`systolic_gemm_ref`); it is held against the JAX Pallas kernel
`grouped_gemm(..., interpret=True)` over the cases of tests/test_kernels.py
(int8 and f32 shapes, the per-group epilogue, an empty group, ragged
capacity fill, G = 1), with tolerances from `repro_torch.TOLERANCES`
(the values of tests/test_kernels.py; int8 without an epilogue is exact).
The wgmma mainloop's order of summation (per group the NN form's split
ranges, `grouped_systolic_gemm_splitk_ref`) is held to the NN form's and
to an empty group's exact zero. The Hopper kernel itself runs only on the
card (the `gpu` tests below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.systolic_gemm import ops as jops
from repro.kernels.systolic_gemm.ref import systolic_gemm_ref as jax_ref
from repro_torch import TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.kernels.systolic_gemm import ops
from repro_torch.kernels.systolic_gemm.ref import (
    grouped_systolic_gemm_ref, grouped_systolic_gemm_splitk_ref,
    systolic_gemm_ref, systolic_gemm_splitk_ref)
from repro_torch.kernels.systolic_gemm.systolic_gemm import (
    gemm_plan, grouped_systolic_gemm_cuda, systolic_gemm_cuda)

T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)
GROUPED_SHAPES = [(2, 32, 40, 24), (3, 64, 64, 64), (1, 5, 130, 17),
                  (4, 33, 17, 65)]
ACTS = [None, "relu", "gelu", "silu", "relu2"]


def _inputs(rng, G, M, K, N, dtype):
    if dtype == "int8":
        x = jnp.asarray(rng.integers(-50, 50, (G, M, K)), jnp.int8)
        w = jnp.asarray(rng.integers(-50, 50, (G, K, N)), jnp.int8)
    else:
        x = jnp.asarray(rng.standard_normal((G, M, K)), dtype)
        w = jnp.asarray(rng.standard_normal((G, K, N)) / np.sqrt(K), dtype)
    return x, w


def _assert_close(got: torch.Tensor, ref, tol):
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    assert tol.ok(got.float(), ref_t), (
        f"excess {tol.excess(got.float(), ref_t)} ({tol})")


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_grouped_gemm_matches_jax(shape, dtype):
    """G independent GEMMs == JAX's grouped Pallas kernel and its
    per-group oracle."""
    G, M, K, N = shape
    x, w = _inputs(np.random.default_rng(0), G, M, K, N,
                   jnp.float32 if dtype == "float32" else dtype)
    got = ops.grouped_gemm(T(x), T(w))
    assert got.dtype == torch.float32 and got.shape == (G, M, N)
    tol = TOLERANCES["gemm_int8_exact" if dtype == "int8" else "gemm_f32"]
    _assert_close(got, jops.grouped_gemm(x, w, interpret=True), tol)
    _assert_close(got, jnp.stack([jax_ref(x[g], w[g]) for g in range(G)]),
                  tol)


def test_grouped_gemm_bf16_matches_jax():
    """The served dtype: bf16 operands, bf16 out (f32 accumulation)."""
    x, w = _inputs(np.random.default_rng(1), 4, 33, 70, 65, jnp.bfloat16)
    got = ops.grouped_gemm(T(x), T(w), activation="silu",
                           out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_close(got, jops.grouped_gemm(x, w, activation="silu",
                                         out_dtype=jnp.bfloat16,
                                         interpret=True),
                  TOLERANCES["gemm_bf16"])


@pytest.mark.parametrize("act", ACTS)
def test_grouped_gemm_per_group_epilogue(act):
    """Per-group dequant scale and bias, one activation for all groups."""
    rng = np.random.default_rng(2)
    G, M, K, N = 3, 24, 48, 40
    x, w = _inputs(rng, G, M, K, N, "int8")
    s = jnp.asarray(rng.random((G, N)) * 0.1, jnp.float32)
    b = jnp.asarray(rng.standard_normal((G, N)), jnp.float32)
    got = ops.grouped_gemm(T(x), T(w), T(s), T(b), activation=act)
    tol = TOLERANCES["gemm_int8_epilogue"]
    _assert_close(got, jops.grouped_gemm(x, w, s, b, activation=act,
                                         interpret=True), tol)
    _assert_close(got, jnp.stack([jax_ref(x[g], w[g], s[g], b[g],
                                          activation=act)
                                  for g in range(G)]), tol)


@pytest.mark.parametrize("act", ACTS)
def test_grouped_gemm_empty_group_stays_zero(act):
    """An expert that received no token is an all-zero group: with zero
    bias its output is exactly zero, whatever the activation, and its
    neighbours are unaffected."""
    rng = np.random.default_rng(3)
    G, M, K, N = 3, 16, 32, 24
    x, w = _inputs(rng, G, M, K, N, jnp.float32)
    x = x.at[1].set(0.0)
    zero_bias = torch.zeros((G, N))
    got = ops.grouped_gemm(T(x), T(w), None, zero_bias, activation=act)
    assert torch.equal(got[1], torch.zeros((M, N)))
    ref = jops.grouped_gemm(x, w, activation=act, interpret=True)
    assert np.array_equal(np.asarray(ref[1]), np.zeros((M, N)))
    _assert_close(got, ref, TOLERANCES["gemm_f32"])


def test_grouped_gemm_ragged_fill():
    """Capacity buckets are ragged: each group has a different number of
    real rows and zero rows after them. Real rows match the JAX kernel,
    the zero rows stay exactly zero."""
    rng = np.random.default_rng(4)
    G, M, K, N = 4, 12, 20, 16
    fills = [12, 5, 1, 0]
    x, w = _inputs(rng, G, M, K, N, jnp.float32)
    mask = np.arange(M)[None, :] < np.asarray(fills)[:, None]
    x = x * jnp.asarray(mask[..., None], jnp.float32)
    got = ops.grouped_gemm(T(x), T(w))
    _assert_close(got, jops.grouped_gemm(x, w, interpret=True),
                  TOLERANCES["gemm_f32"])
    for g, f in enumerate(fills):
        assert torch.equal(got[g, f:], torch.zeros((M - f, N)))


def test_grouped_gemm_single_group_is_the_pod_gemm():
    """G == 1 equals the port's plain pod GEMM and JAX's Pallas one."""
    rng = np.random.default_rng(5)
    x, w = _inputs(rng, 1, 40, 56, 33, "int8")
    got = ops.grouped_gemm(T(x), T(w))
    assert torch.equal(got[0], ops.systolic_gemm(T(x[0]), T(w[0])))
    _assert_close(got[0], jops.systolic_gemm(x[0], w[0], interpret=True),
                  TOLERANCES["gemm_int8_exact"])


@pytest.mark.parametrize("act", ACTS)
def test_grouped_split_order_is_nn_split_order_per_group(act):
    """The wgmma mainloop's arithmetic in plain torch: each group summed in
    the NN form's split ranges, bit for bit the NN emulation of that group
    (so G = 1 equals the NN launch), and an empty group with a zero bias
    exactly 0 under every activation."""
    g = torch.Generator().manual_seed(6)
    G, M, K, N = 3, 65, 520, 24          # 17 k-steps in ranges 6, 6, 5
    x = torch.randn((G, M, K), generator=g).to(torch.bfloat16)
    w = (torch.randn((G, K, N), generator=g) / K ** 0.5).to(torch.bfloat16)
    s = torch.rand((G, N), generator=g) + 0.5
    b = torch.randn((G, N), generator=g)
    x[1] = 0
    b[1] = 0
    got = grouped_systolic_gemm_splitk_ref(x, w, s, b, splits=3,
                                           activation=act)
    for i in range(G):
        assert torch.equal(got[i], systolic_gemm_splitk_ref(
            x[i], w[i], s[i], b[i], splits=3, activation=act))
    assert torch.equal(got[1], torch.zeros((M, N)))
    tol = TOLERANCES["gemm_bf16_f32out"]
    assert tol.ok(got, grouped_systolic_gemm_ref(x, w, s, b, activation=act))


def test_grouped_wrapper_checks_its_inputs():
    """The kernel wrapper never takes the plain version itself, and refuses
    what the kernel does not take before it looks for a card."""
    x = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    w = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_systolic_gemm_cuda(x, w)
    with pytest.raises(ValueError, match="do not form"):
        grouped_systolic_gemm_cuda(x, w[:1])
    with pytest.raises(ValueError, match="do not form"):
        grouped_systolic_gemm_cuda(x[0], w[0])
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.grouped_gemm(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="positive"):
        ops.grouped_gemm(x, w, block_m=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """The grouped kernel against grouped_systolic_gemm_ref on the card:
    ragged shapes, every activation with per-group scale and bias, an
    all-zero group exactly zero, G = 1 equal to the pod-GEMM kernel."""
    g = torch.Generator(cuda_device).manual_seed(0)
    for G, M, K, N in [(3, 37, 100, 130), (16, 1, 512, 200), (1, 70, 64, 33)]:
        if dtype == torch.int8:
            x = torch.randint(-128, 128, (G, M, K), generator=g,
                              device=cuda_device, dtype=torch.int8)
            w = torch.randint(-128, 128, (G, K, N), generator=g,
                              device=cuda_device, dtype=torch.int8)
        else:
            x = torch.randn((G, M, K), generator=g,
                            device=cuda_device).to(dtype)
            w = (torch.randn((G, K, N), generator=g, device=cuda_device)
                 / K ** 0.5).to(dtype)
        s = torch.rand((G, N), generator=g, device=cuda_device) + 0.5
        b = torch.randn((G, N), generator=g, device=cuda_device)
        empty = G // 2 if G > 1 else None      # an expert with no token
        if empty is not None:
            x[empty] = 0
            b[empty] = 0
        for act in ACTS:
            got = grouped_systolic_gemm_cuda(x, w, s, b, activation=act)
            ref = grouped_systolic_gemm_ref(x, w, s, b, activation=act)
            torch.cuda.synchronize()
            if dtype == torch.int8:
                tol = TOLERANCES["gemm_int8_epilogue"]
            else:
                tol = TOLERANCES["gemm_f32" if dtype == torch.float32
                                 else "gemm_bf16_f32out"]
            assert tol.ok(got, ref), (G, M, K, N, act)
            if empty is not None:
                assert torch.equal(got[empty], torch.zeros_like(got[empty]))
        if G == 1:
            assert torch.equal(grouped_systolic_gemm_cuda(x, w)[0],
                               systolic_gemm_cuda(x[0], w[0]))
            assert torch.equal(grouped_systolic_gemm_ref(x, w)[0],
                               systolic_gemm_ref(x[0], w[0]))


@pytest.mark.gpu
def test_kernel_refuses_more_groups_than_the_grid_holds(cuda_device):
    """The launcher refuses G > 65535 (the grid's z limit) and the wrapper
    raises; G = 65535 runs."""
    x = torch.ones((65536, 1, 1), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(RuntimeError, match="G=65536"):
        grouped_systolic_gemm_cuda(x, x)
    got = grouped_systolic_gemm_cuda(x[1:], x[1:])
    torch.cuda.synchronize()
    assert torch.equal(got, torch.ones_like(got, dtype=torch.float32))


@pytest.mark.gpu
def test_wgmma_rows_and_single_group_are_bit_equal_on_card(cuda_device):
    """The grouped wgmma mainloop: a group's rows are bit-equal at every M
    above 64 (dbrx's ragged capacities), and G = 1 equals the NN launch of
    the same shape bit for bit (both wgmma, one order of summation)."""
    g = torch.Generator(cuda_device).manual_seed(2)
    G, K, N = 4, 1032, 264
    x = torch.randn((G, 200, K), generator=g, device=cuda_device).bfloat16()
    w = (torch.randn((G, K, N), generator=g, device=cuda_device)
         / K ** 0.5).bfloat16()
    full = grouped_systolic_gemm_cuda(x, w, out_dtype=torch.bfloat16)
    for M in (129, 65):
        assert gemm_plan("grouped", M, N, K, torch.bfloat16,
                         True).mainloop == "wgmma"
        part = grouped_systolic_gemm_cuda(x[:, :M].contiguous(), w,
                                          out_dtype=torch.bfloat16)
        assert torch.equal(part, full[:, :M]), M
    one = grouped_systolic_gemm_cuda(x[:1], w[:1])
    assert torch.equal(one[0], systolic_gemm_cuda(x[0], w[0]))
