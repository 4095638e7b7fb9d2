"""The port's pod GEMM against the JAX package's.

On the CPU `repro_torch...ops.systolic_gemm` runs its plain version; it is
held against the JAX Pallas kernel in interpret mode and against the JAX
oracle `systolic_gemm_ref`, over f32/bf16/int8 x every activation x ragged
M/K/N. The transposed-weight form (`systolic_gemm_t`, w [N, K]: the tied LM
head) is held the same way against JAX's `systolic_gemm_t`. Tolerances
come from `repro_torch.TOLERANCES` (the values of tests/test_kernels.py);
int8 accumulation without an epilogue must be exact.

The mainloop plan of every form (`gemm_plan`; `nn_plan` for NN) is pure
Python and is held here to its rules at granite-8b's, mamba2-370m's and
dbrx-132b's served shapes, and the splitk/wgmma order of summation,
emulated in plain torch, against the NN, NT and grouped Pallas kernels.
The Hopper kernels themselves run only on the card (the gpu-marked tests:
`python -m pytest -m gpu tests/test_torch_*.py` there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.systolic_gemm import ops as jops
from repro.kernels.systolic_gemm.ref import systolic_gemm_ref as jax_ref
from repro.kernels.systolic_gemm.ref import systolic_gemm_t_ref as jax_t_ref
from repro_torch import TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.kernels.systolic_gemm import ops
from repro_torch.kernels.systolic_gemm.ref import (
    grouped_systolic_gemm_ref, grouped_systolic_gemm_splitk_ref,
    splitk_partials, systolic_gemm_ref, systolic_gemm_splitk_ref,
    systolic_gemm_t_ref, systolic_gemm_t_splitk_ref)
from repro_torch.kernels.systolic_gemm.systolic_gemm import (
    FORMS, SPLITK_K_STEP, gemm_plan, grouped_systolic_gemm_cuda, nn_plan,
    splitk_ranges, systolic_gemm_cuda, systolic_gemm_nt_cuda)

SHAPES = [(1, 1, 1), (33, 57, 29), (100, 130, 70), (5, 260, 130)]
ACTS = [None, "relu", "gelu", "silu", "relu2"]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


def _inputs(rng, M, K, N, dtype, transposed=False):
    """w [K, N], or [N, K] when transposed."""
    w_shape = (N, K) if transposed else (K, N)
    if dtype == "int8":
        x = rng.integers(-128, 128, (M, K))
        w = rng.integers(-128, 128, w_shape)
    else:
        x = rng.standard_normal((M, K))
        w = rng.standard_normal(w_shape) / np.sqrt(K)
    s = (rng.random(N) + 0.5).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    jx, jw = jnp.asarray(x, DTYPES[dtype]), jnp.asarray(w, DTYPES[dtype])
    to_t = lambda a: params_from_jax(np.asarray(a))
    return (jx, jw, jnp.asarray(s), jnp.asarray(b)), \
        (to_t(jx), to_t(jw), torch.from_numpy(s), torch.from_numpy(b))


def _tol(dtype, act):
    if dtype == "int8":
        # exact without an epilogue; scale/bias may be fused into one FMA
        return TOLERANCES["gemm_int8_exact" if act is None
                          else "gemm_int8_epilogue"]
    return TOLERANCES["gemm_" + ("f32" if dtype == "float32" else "bf16")]


def _assert_close(got: torch.Tensor, ref, tol):
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    assert tol.ok(got.float(), ref_t), (
        f"max_abs_err {(got.float() - ref_t).abs().max()} ({tol})")


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_systolic_gemm_matches_jax(dtype, act):
    rng = np.random.default_rng(0)
    tol = _tol(dtype, act)
    for M, K, N in SHAPES:
        (jx, jw, js, jb), (tx, tw, ts, tb) = _inputs(rng, M, K, N, dtype)
        sb_j = (js, jb) if act else (None, None)
        sb_t = (ts, tb) if act else (None, None)
        got = ops.systolic_gemm(tx, tw, *sb_t, activation=act)
        assert got.dtype == torch.float32
        _assert_close(got, jax_ref(jx, jw, *sb_j, activation=act), tol)
        if (M, K, N) == (33, 57, 29):       # one ragged shape through Pallas
            pallas = jops.systolic_gemm(jx, jw, *sb_j, activation=act,
                                        interpret=True)
            _assert_close(got, pallas, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_systolic_gemm_bf16_out_and_blocks(dtype):
    """out_dtype=bf16 rounds once, like the reference; explicit blocks are
    accepted and change nothing."""
    rng = np.random.default_rng(1)
    (jx, jw, js, jb), (tx, tw, ts, tb) = _inputs(rng, 37, 100, 130, dtype)
    ref = jax_ref(jx, jw, js, jb, activation="silu", out_dtype=jnp.bfloat16)
    got = ops.systolic_gemm(tx, tw, ts, tb, activation="silu",
                            out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_close(got, ref, TOLERANCES["gemm_bf16"])
    blocked = ops.systolic_gemm(tx, tw, ts, tb, activation="silu",
                                out_dtype=torch.bfloat16, block_m=32,
                                block_n=64, block_k=16)
    assert torch.equal(blocked, got)


def test_fused_lane_gemm_folds_leading_axes():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) / 7).astype(np.float32)
    ref = jops.fused_lane_gemm(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16),
                               activation="gelu", out_dtype=jnp.bfloat16,
                               interpret=True)
    tx = params_from_jax(np.asarray(jnp.asarray(x, jnp.bfloat16)))
    tw = params_from_jax(np.asarray(jnp.asarray(w, jnp.bfloat16)))
    got = ops.fused_lane_gemm(tx, tw, activation="gelu",
                              out_dtype=torch.bfloat16)
    assert got.shape == (2, 3, 5, 40) and got.dtype == torch.bfloat16
    _assert_close(got, ref, TOLERANCES["gemm_bf16"])
    # out_dtype=None means f32, and the fold equals the 2-D call row for row
    got32 = ops.fused_lane_gemm(tx, tw)
    assert got32.dtype == torch.float32
    flat = ops.systolic_gemm(tx.reshape(30, 48), tw)
    assert torch.equal(got32.reshape(30, 40), flat)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_systolic_gemm_t_matches_jax(dtype, act):
    """x @ w^T with w [N, K] in its stored layout, against JAX's oracle on
    every shape and JAX's transposed Pallas kernel on a ragged one."""
    rng = np.random.default_rng(3)
    tol = _tol(dtype, act)
    for M, K, N in SHAPES:
        (jx, jw, js, jb), (tx, tw, ts, tb) = _inputs(rng, M, K, N, dtype,
                                                     transposed=True)
        sb_j = (js, jb) if act else (None, None)
        sb_t = (ts, tb) if act else (None, None)
        got = ops.systolic_gemm_t(tx, tw, *sb_t, activation=act)
        assert got.dtype == torch.float32
        _assert_close(got, jax_t_ref(jx, jw, *sb_j, activation=act), tol)
        if (M, K, N) == (33, 57, 29):
            pallas = jops.systolic_gemm_t(jx, jw, *sb_j, activation=act,
                                          interpret=True)
            _assert_close(got, pallas, tol)


def test_fused_lane_gemm_t_folds_leading_axes():
    """The LM-head form: [B, S, d] @ [vocab, d]^T -> [B, S, vocab] in bf16
    (a ragged vocab), against JAX's fused_lane_gemm_t in interpret mode."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    w = rng.standard_normal((100, 48)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = jops.fused_lane_gemm_t(jx, jw, out_dtype=jnp.bfloat16,
                                 interpret=True)
    tx, tw = params_from_jax(np.asarray(jx)), params_from_jax(np.asarray(jw))
    got = ops.fused_lane_gemm_t(tx, tw, out_dtype=torch.bfloat16)
    assert got.shape == (2, 3, 100) and got.dtype == torch.bfloat16
    _assert_close(got, ref, TOLERANCES["gemm_bf16"])
    flat = ops.systolic_gemm_t(tx.reshape(6, 48), tw)
    assert torch.equal(ops.fused_lane_gemm_t(tx, tw).reshape(6, 100), flat)


def test_int8_plain_version_is_exact_past_f32_range():
    """K * 127**2 > 2**24: an f32 accumulation would round, int64 does not."""
    K = 2048
    x = torch.full((2, K), 127, dtype=torch.int8)
    w = torch.full((K, 3), 127, dtype=torch.int8)
    x[0, 0] = 126
    got = systolic_gemm_ref(x, w)
    exact = np.array(np.full((2, K), 127, np.int64) @ np.full((K, 3), 127),
                     dtype=np.float64)
    exact[0] -= 127
    assert np.array_equal(got.numpy(), exact.astype(np.float32))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never takes the plain version itself."""
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    w = torch.zeros((8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        systolic_gemm_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        systolic_gemm_nt_cuda(x, w.t().contiguous())


# (K, N) of every pod GEMM the served models run: granite-8b's q, k/v, o,
# gate/up, down and head; dbrx-132b's q/o, k/v and untied head
SERVED_KN = {"granite-8b": [(4096, 4096), (4096, 1024), (4096, 14336),
                            (14336, 4096), (4096, 49152)],
             "dbrx-132b": [(6144, 6144), (6144, 1024), (6144, 100352)]}
# decode lanes (1, 4), dbrx's exact-length prefills (29, 64, 65, 1277) and
# granite's bucketed prefills ([4, 256] and [4, 2048])
SERVED_M = [1, 4, 29, 64, 65, 1024, 1277, 8192]


@pytest.mark.parametrize("arch", list(SERVED_KN))
def test_nn_plan_puts_served_shapes_on_splitk_or_wgmma(arch):
    """bf16, TMA-aligned: M <= 64 on splitk, M > 64 on wgmma, never wmma;
    the split ranges (so the order of summation) the same at every M."""
    for K, N in SERVED_KN[arch]:
        decode = nn_plan(1, N, K, torch.bfloat16, True)
        for M in SERVED_M:
            plan = nn_plan(M, N, K, torch.bfloat16, True)
            assert plan.splits == decode.splits, (M, K, N)
            if M <= 64:
                assert plan == decode and plan.mainloop == "splitk", (M, K, N)
            else:
                assert plan == ("wgmma", decode.splits, 128), (M, K, N)


# mamba2-370m's tied head, x [M, 1024] @ tok [50280, 1024]^T: decode (4
# lanes) and the largest bucketed prefill ([4, 2048], every position)
MAMBA2_HEAD_KN = (1024, 50280)
# dbrx-132b's expert GEMMs (K, N): up and gate, then down; rows per expert
# at decode (1) and at exact-length prefills (9, 320, 399)
DBRX_EXPERT_KN = [(6144, 10752), (10752, 6144)]


def test_gemm_plan_puts_mamba2_head_and_dbrx_experts_on_hopper_mainloops():
    """The NT head on splitk at decode and wgmma at prefill; the grouped
    experts on wmma at M <= 64 and wgmma above; each with NN's splits."""
    K, N = MAMBA2_HEAD_KN
    nn = nn_plan(1, N, K, torch.bfloat16, True)
    assert gemm_plan("nt", 4, N, K, torch.bfloat16, True) == nn
    assert gemm_plan("nt", 8192, N, K, torch.bfloat16, True) == \
        ("wgmma", nn.splits, 128)
    for K, N in DBRX_EXPERT_KN:
        nn = nn_plan(1, N, K, torch.bfloat16, True)
        for M in (1, 9):
            assert gemm_plan("grouped", M, N, K, torch.bfloat16, True) == \
                ("wmma", 1, 0), (M, K, N)
        for M in (320, 399):
            assert gemm_plan("grouped", M, N, K, torch.bfloat16, True) == \
                ("wgmma", nn.splits, 128), (M, K, N)


@pytest.mark.parametrize("form", FORMS)
def test_gemm_plan_splits_are_nn_splits_for_every_form(form):
    """splits is a function of N and K only: a form's splitk or wgmma plan
    sums K in NN's ranges at every M, so rows are bit-equal across M and a
    grouped launch with G = 1 equals the NN launch; ragged shapes stay on
    wmma and f32/int8 on simt in every form."""
    kns = [kn for arch in SERVED_KN.values() for kn in arch] + \
        [MAMBA2_HEAD_KN, *DBRX_EXPERT_KN, (4104, 1032), (520, 136)]
    for K, N in kns:
        for M in SERVED_M:
            nn = nn_plan(M, N, K, torch.bfloat16, True)
            plan = gemm_plan(form, M, N, K, torch.bfloat16, True)
            assert plan.mainloop in ("splitk", "wgmma", "wmma"), plan
            if plan.mainloop != "wmma":
                assert plan == nn, (form, M, K, N)
            else:
                assert form == "grouped" and M <= 64, (M, K, N)
    assert gemm_plan(form, 300, 130, 100, torch.bfloat16, True).mainloop \
        == "wmma"
    assert gemm_plan(form, 300, 4096, 4096, torch.bfloat16,
                     False).mainloop == "wmma"
    for dtype in (torch.float32, torch.int8):
        assert gemm_plan(form, 300, 4096, 4096, dtype, True).mainloop == \
            "simt"


def test_gemm_plan_refuses_an_unknown_form():
    with pytest.raises(ValueError, match="form"):
        gemm_plan("tn", 4, 8, 8, torch.bfloat16, True)


def test_nn_plan_other_shapes():
    """The ragged case and misaligned pointers stay on wmma; f32 and int8
    on simt."""
    assert nn_plan(37, 130, 100, torch.bfloat16, True).mainloop == "wmma"
    assert nn_plan(4, 4096, 4096, torch.bfloat16, False).mainloop == "wmma"
    assert nn_plan(4, 4096, 4100, torch.bfloat16, True).mainloop == "wmma"
    assert nn_plan(1024, 4100, 4096, torch.bfloat16, True).mainloop == "wmma"
    for dtype in (torch.float32, torch.int8):
        assert nn_plan(4, 4096, 4096, dtype, True).mainloop == "simt"


@pytest.mark.parametrize("K", [8, 256, 520, 4096, 4104, 6144, 14336])
def test_splitk_ranges_cover_k_in_whole_k_steps(K):
    """Every split range is non-empty, starts on a k-step and, but for the
    last, spans an even number of k-steps (whole 64-deep wgmma stages);
    together they cover [0, K) in order."""
    for N in (8, 1024, 1032, 4096, 49152):
        plan = nn_plan(4, N, K, torch.bfloat16, True)
        ranges = splitk_ranges(K, plan.splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        for (a, b), (c, _) in zip(ranges, ranges[1:] + [(K, K)]):
            assert a < b and b == c and a % SPLITK_K_STEP == 0
            assert b == K or (b - a) % (2 * SPLITK_K_STEP) == 0


def _grouped_inputs(rng, G, M, K, N):
    """bf16 x [G, M, K], w [G, K, N]; f32 scale and bias [G, N]."""
    x = rng.standard_normal((G, M, K))
    w = rng.standard_normal((G, K, N)) / np.sqrt(K)
    s = (rng.random((G, N)) + 0.5).astype(np.float32)
    b = rng.standard_normal((G, N)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    to_t = lambda a: params_from_jax(np.asarray(a))
    return (jx, jw, jnp.asarray(s), jnp.asarray(b)), \
        (to_t(jx), to_t(jw), torch.from_numpy(s), torch.from_numpy(b))


def _splitk_case(form, M, K, N, splits, G=1):
    return pytest.param(form, G, M, K, N, splits,
                        id=f"{M}-{K}-{N}-{splits}" if form == "nn"
                        else f"{form}-{G}-{M}-{K}-{N}-{splits}")


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form,G,M,K,N,splits", [
    _splitk_case("nn", 4, 520, 72, 3), _splitk_case("nn", 29, 256, 40, 8),
    _splitk_case("nn", 64, 200, 16, 2),
    # NT (w [N, K]): splitk rows at decode, wgmma rows past 64, uneven ranges
    _splitk_case("nt", 4, 520, 72, 3), _splitk_case("nt", 65, 264, 40, 4),
    # grouped (wgmma only): ragged rows per group, an uneven last range
    _splitk_case("grouped", 65, 200, 24, 2, G=3),
    _splitk_case("grouped", 70, 520, 16, 3, G=2)])
def test_splitk_summation_order_matches_jax(form, G, M, K, N, splits,
                                            out_dtype):
    """f32 partials per K range, added in split order, then the epilogue:
    within gemm_bf16_f32out / gemm_bf16out of the form's Pallas kernel
    (NN, NT or grouped, interpret mode), SiLU with scale and bias."""
    rng = np.random.default_rng(M + K)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[out_dtype]
    tdt = getattr(torch, out_dtype)
    kw = dict(activation="silu")
    if form == "grouped":
        (jx, jw, js, jb), (tx, tw, ts, tb) = _grouped_inputs(rng, G, M, K, N)
        pallas = jops.grouped_gemm(jx, jw, js, jb, out_dtype=jdt,
                                   interpret=True, **kw)
        got = grouped_systolic_gemm_splitk_ref(tx, tw, ts, tb, splits=splits,
                                               out_dtype=tdt, **kw)
        parts = [splitk_partials(tx[g], tw[g], splits) for g in range(G)]
    else:
        nt = form == "nt"
        (jx, jw, js, jb), (tx, tw, ts, tb) = _inputs(rng, M, K, N, "bfloat16",
                                                     transposed=nt)
        pallas = (jops.systolic_gemm_t if nt else jops.systolic_gemm)(
            jx, jw, js, jb, out_dtype=jdt, interpret=True, **kw)
        got = (systolic_gemm_t_splitk_ref if nt else systolic_gemm_splitk_ref)(
            tx, tw, ts, tb, splits=splits, out_dtype=tdt, **kw)
        parts = [splitk_partials(tx, tw.t() if nt else tw, splits)]
    assert got.dtype == tdt
    _assert_close(got, pallas, TOLERANCES["gemm_bf16_f32out"
                                          if out_dtype == "float32"
                                          else "gemm_bf16out"])
    assert all(len(p) == splits for p in parts)


def test_splitk_controls_fail_the_card_tolerance():
    """chip_smoke.py's split-K controls at a CPU size: the last split's
    partial left out, and each k-step read with the previous step's w
    tile, both miss gemm_bf16_f32out; the emulation itself does not."""
    import chip_smoke
    g = torch.Generator().manual_seed(7)
    x = torch.randn((4, 1024), generator=g).to(torch.bfloat16)
    w = (torch.randn((1024, 256), generator=g) / 32).to(torch.bfloat16)
    ref = systolic_gemm_ref(x, w)
    tol = TOLERANCES["gemm_bf16_f32out"]
    assert tol.ok(systolic_gemm_splitk_ref(x, w, splits=4), ref)
    assert not tol.ok(chip_smoke.last_split_dropped(x, w, 4), ref)
    assert not tol.ok(chip_smoke.stale_w_tile(x, w, SPLITK_K_STEP), ref)


def test_nt_splitk_controls_fail_the_card_tolerance():
    """The same controls planted on an NT weight w [N, K] through its
    [K, N] view, as chip_smoke.py's NT phase plants them: both miss
    gemm_bf16_f32out of the NT plain version; the NT split-order
    emulation does not."""
    import chip_smoke
    g = torch.Generator().manual_seed(8)
    x = torch.randn((4, 1024), generator=g).to(torch.bfloat16)
    w = (torch.randn((256, 1024), generator=g) / 32).to(torch.bfloat16)
    ref = systolic_gemm_t_ref(x, w)
    tol = TOLERANCES["gemm_bf16_f32out"]
    assert tol.ok(systolic_gemm_t_splitk_ref(x, w, splits=4), ref)
    assert not tol.ok(chip_smoke.last_split_dropped(x, w.t(), 4), ref)
    assert not tol.ok(chip_smoke.stale_w_tile(x, w.t(), SPLITK_K_STEP), ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True], ids=["nn", "nt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_matches_plain_on_card(cuda_device, dtype, transposed):
    g = torch.Generator(cuda_device).manual_seed(0)
    kernel, plain = ((systolic_gemm_nt_cuda, systolic_gemm_t_ref)
                     if transposed else (systolic_gemm_cuda,
                                         systolic_gemm_ref))
    for M, K, N in [(37, 100, 130), (4, 4096, 1024), (300, 520, 200),
                    (4, 1024, 50280)]:
        w_shape = (N, K) if transposed else (K, N)
        if dtype == torch.int8:
            x = torch.randint(-128, 128, (M, K), generator=g,
                              device=cuda_device, dtype=torch.int8)
            w = torch.randint(-128, 128, w_shape, generator=g,
                              device=cuda_device, dtype=torch.int8)
        else:
            x = torch.randn((M, K), generator=g, device=cuda_device).to(dtype)
            w = (torch.randn(w_shape, generator=g, device=cuda_device)
                 / K ** 0.5).to(dtype)
        for act in ACTS:
            got = kernel(x, w, activation=act)
            ref = plain(x, w, activation=act)
            torch.cuda.synchronize()
            # bf16 inputs on the card: f32 sums only (see TOLERANCES)
            tol = (TOLERANCES["gemm_bf16_f32out"] if dtype == torch.bfloat16
                   else _tol("float32" if dtype == torch.float32 else "int8",
                             act))
            assert tol.ok(got, ref)


# (M, K, N, mainloop) per form: ragged M, N and K (N and K multiples of 8,
# not of a tile; NT and grouped also N and K below one TMA box); the
# grouped cases have G = 3 with an empty middle group
NEW_MAINLOOP_CASES = {
    "nn": [(29, 4104, 1032, "splitk"), (4, 4104, 4096, "splitk"),
           (65, 520, 136, "wgmma"), (1277, 4104, 1032, "wgmma")],
    "nt": [(29, 4104, 1032, "splitk"), (4, 1024, 50280, "splitk"),
           (65, 520, 136, "wgmma"), (300, 1024, 50280, "wgmma"),
           (65, 40, 72, "wgmma")],
    "grouped": [(65, 256, 136, "wgmma"), (129, 1032, 264, "wgmma"),
                (70, 40, 16, "wgmma"), (33, 256, 136, "wmma")]}
KERNELS = {"nn": (systolic_gemm_cuda, systolic_gemm_ref),
           "nt": (systolic_gemm_nt_cuda, systolic_gemm_t_ref),
           "grouped": (grouped_systolic_gemm_cuda, grouped_systolic_gemm_ref)}


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_new_mainloops_match_plain_on_card(cuda_device, out_dtype, form):
    """splitk and wgmma at ragged M, N and K, with scale, bias and SiLU,
    against the plain version; each shape takes the mainloop gemm_plan
    names. A grouped launch's empty group comes out exactly 0."""
    g = torch.Generator(cuda_device).manual_seed(1)
    tol = TOLERANCES["gemm_bf16_f32out" if out_dtype == torch.float32
                     else "gemm_bf16out"]
    kernel, plain = KERNELS[form]
    lead = (3,) if form == "grouped" else ()
    for M, K, N, mainloop in NEW_MAINLOOP_CASES[form]:
        assert gemm_plan(form, M, N, K, torch.bfloat16, True).mainloop == \
            mainloop
        x = torch.randn(lead + (M, K), generator=g,
                        device=cuda_device).bfloat16()
        w_shape = lead + ((N, K) if form == "nt" else (K, N))
        w = (torch.randn(w_shape, generator=g, device=cuda_device)
             / K ** 0.5).bfloat16()
        scale = torch.rand(lead + (N,), generator=g, device=cuda_device) + 0.5
        bias = torch.randn(lead + (N,), generator=g, device=cuda_device)
        if lead:                                 # an expert with no token
            x[1] = 0
            bias[1] = 0
        before = dict(kernel.mainloop_launches)
        got = kernel(x, w, scale, bias, activation="silu",
                     out_dtype=out_dtype)
        ref = plain(x, w, scale, bias, activation="silu",
                    out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert tol.ok(got, ref), (M, K, N, tol.excess(got, ref))
        if lead:
            assert torch.equal(got[1], torch.zeros_like(got[1]))
        assert kernel.mainloop_launches[mainloop] == before[mainloop] + 1
