"""The port's SSD chunk scan against the JAX package's.

On the CPU `repro_torch...ssd.ops.ssd` runs `ssd_kernel_ref`, the plain
version of the Pallas kernel's arithmetic; it is held against the JAX
wrapper `repro.kernels.ssd.ops.ssd` (Pallas in interpret mode) on the
shapes of tests/test_kernels.py::SSD_CASES, in f32 and bf16, for y and the
final state. `ssd_ref` (the port of ssd_reference) is held against the JAX
reference, and the recurrent decode step against JAX's and against the
chunked prefill. Tolerances come from `repro_torch.TOLERANCES`:

* f32: `ssd_f32` (the 2e-4 of tests/test_kernels.py);
* bf16, y against Pallas and ssd_ref against ssd_reference:
  `ssd_bf16_kernel` (one bf16 ulp, and M entries that round the other
  way);
* bf16, the final state against the JAX wrapper's: `ssd_bf16_reference`.
  The JAX wrapper recomputes its final state with ssd_reference, whose
  state is bf16; the port's comes from the kernel's f32 state. That drift
  is stated here, not hidden: the two are not one ulp apart.

The chunked mainloop's order (chunk states, a sequential f32 state pass,
the chunk scan) has its own plain version, `ssd_chunked_ref`: it is held
against the Pallas kernel the same way, gives a prompt's rows and state
bit for bit alone and padded into a bucket, and its planted faults fail
`ssd_bf16_kernel`. `ssd_plan` is read for every served and test shape, and
the kernel wrapper's input check for the strided views apply_ssm hands it.

The Hopper kernel itself runs only on the card (the gpu-marked tests).
`PYTHONPATH=src:. python tests/test_torch_ssd.py` prints the CPU readings
behind ssd_bf16_reference (drift_readings).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jops
from repro.models.ssm import ssd_decode_step as jax_decode_step
from repro.models.ssm import ssd_reference as jax_ssd_reference
from repro_torch import TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.kernels.ssd import ops
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.ssd import ssd as ssd_mod
from repro_torch.kernels.ssd.ref import (CHUNKED_FAULTS, ssd_chunked_ref,
                                         ssd_kernel_ref, ssd_ref)
from repro_torch.kernels.ssd.ssd import run_chunk, ssd_cuda, ssd_plan
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model
from repro_torch.models.ssm import ssd_decode_step

# tests/test_kernels.py::SSD_CASES: (b, S, H, P, G, N, chunk)
SSD_CASES = [(2, 64, 4, 16, 1, 32, 16), (1, 100, 2, 8, 2, 16, 32),
             (1, 32, 4, 16, 4, 8, 32), (2, 48, 8, 32, 1, 64, 16)]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)


def _inputs(case, dtype, seed=0):
    """The generator of tests/test_kernels.py: x, B, C in `dtype`; dt, A,
    D in f32. Returns (jax arrays, torch tensors)."""
    b, S, H, P, G, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P))
    dt = (rng.random((b, S, H)) * 0.5 + 0.1).astype(np.float32)
    A = (-rng.random(H) - 0.1).astype(np.float32)
    B = rng.standard_normal((b, S, G, N))
    C = rng.standard_normal((b, S, G, N))
    D = rng.random(H).astype(np.float32)
    j = (jnp.asarray(x, DTYPES[dtype]), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B, DTYPES[dtype]), jnp.asarray(C, DTYPES[dtype]),
         jnp.asarray(D))
    return j, tuple(T(a) for a in j)


def _tols(dtype):
    if dtype == "float32":
        return TOLERANCES["ssd_f32"], TOLERANCES["ssd_f32"]
    return TOLERANCES["ssd_bf16_kernel"], TOLERANCES["ssd_bf16_reference"]


def _assert_close(got: torch.Tensor, ref, tol):
    ref_t = T(ref) if not isinstance(ref, torch.Tensor) else ref
    assert got.shape == ref_t.shape and got.dtype == ref_t.dtype
    assert tol.ok(got.float(), ref_t.float()), (
        f"excess {tol.excess(got.float(), ref_t.float())} ({tol})")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_matches_jax_pallas(case, dtype):
    """y against the Pallas kernel (interpret mode) at one bf16 ulp; the
    final state against the JAX wrapper's (the bf16-state reference) at
    the stated drift."""
    j, t = _inputs(case, dtype)
    chunk = case[-1]
    jy, jh = jops.ssd(*j, chunk=chunk, interpret=True)
    y, h = ops.ssd(*t, chunk=chunk)
    tol_y, tol_h = _tols(dtype)
    _assert_close(y, jy, tol_y)
    _assert_close(h, jh, tol_h)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_ref_matches_jax_reference(case, dtype):
    """The port of ssd_reference rounds where the reference rounds: y and
    its (x-dtype) final state within one bf16 ulp."""
    j, t = _inputs(case, dtype, seed=1)
    chunk = case[-1]
    jy, jh = jax_ssd_reference(*j, chunk)
    y, h = ssd_ref(*t, chunk)
    tol = _tols(dtype)[0]
    _assert_close(y, jy, tol)
    _assert_close(h, jh, tol)


def test_ssd_kernel_ref_and_ssd_ref_agree_in_f32():
    """In f32 the two plain versions are one function: the reference's
    bf16 roundings are the only thing between them."""
    case = (1, 200, 4, 16, 2, 32, 64)
    _, t = _inputs(case, "float32", seed=2)
    y1, h1 = ssd_kernel_ref(*t, chunk=64)
    y2, h2 = ssd_ref(*t, 64)
    tol = TOLERANCES["ssd_f32"]
    assert tol.ok(y1, y2) and tol.ok(h1, h2)


def test_f32_sub_chunks_give_the_chunk_result():
    """In f32 the kernel runs a chunk of 256 at mamba2's tiles (P 64, N
    128) as 128-token sub-chunks, whose tiles fit a block's shared memory:
    in f32 that is the same function. The plain version at chunk 128
    agrees with itself at 256 and with the Pallas kernel (interpret mode)
    at 256, y and the final state, within ssd_f32."""
    j, t = _inputs((1, 512, 2, 64, 1, 128, 256), "float32", seed=8)
    y256, h256 = ssd_kernel_ref(*t, chunk=256)
    y128, h128 = ssd_kernel_ref(*t, chunk=128)
    tol = TOLERANCES["ssd_f32"]
    assert tol.ok(y128, y256) and tol.ok(h128, h256)
    jy, jh = jops.ssd(*j, chunk=256, interpret=True)
    _assert_close(y128, jy, tol)
    _assert_close(h128, jh, tol)


def test_mask_before_exp_keeps_long_chunks_finite():
    """Above the diagonal cum_t - cum_s grows to ~ +180 over a 256-token
    chunk at mamba2-like dt and A; exp overflows there. The plain version
    masks before exp, so its output is finite and equals Pallas's, which
    selects with where(tri, exp(seg), 0)."""
    rng = np.random.default_rng(3)
    b, S, H, P, N, chunk = 1, 256, 2, 16, 32, 256
    x = jnp.asarray(rng.standard_normal((b, S, H, P)), jnp.bfloat16)
    dt = jnp.asarray(np.log1p(np.exp(rng.standard_normal((b, S, H)) + 1)),
                     jnp.float32)
    A = jnp.asarray([-1.0, -1.5], jnp.float32)
    B = jnp.asarray(rng.standard_normal((b, S, 1, N)), jnp.bfloat16)
    C = jnp.asarray(rng.standard_normal((b, S, 1, N)), jnp.bfloat16)
    D = jnp.ones((H,), jnp.float32)
    assert float(jnp.sum(dt[0, :, 0])) > 89      # exp(seg) overflows f32
    jy, _ = jops.ssd(x, dt, A, B, C, D, chunk=chunk, interpret=True)
    y, h = ops.ssd(T(x), T(dt), T(A), T(B), T(C), T(D), chunk=chunk)
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(h.float()).all())
    _assert_close(y, jy, TOLERANCES["ssd_bf16_kernel"])


def test_ssd_decode_step_matches_jax():
    """One recurrent step in bf16, N > P and N < P (the reference's
    3-operand outer product rounds another pair in each)."""
    for P, N in ((8, 16), (16, 8)):
        rng = np.random.default_rng(P)
        b, H, G = 2, 4, 2
        j = (jnp.asarray(rng.standard_normal((b, H, P)), jnp.bfloat16),
             jnp.asarray(rng.random((b, H)) * 0.5, jnp.float32),
             jnp.asarray(-rng.random(H) - 0.1, jnp.float32),
             jnp.asarray(rng.standard_normal((b, G, N)), jnp.bfloat16),
             jnp.asarray(rng.standard_normal((b, G, N)), jnp.bfloat16),
             jnp.asarray(rng.random(H), jnp.bfloat16),
             jnp.asarray(rng.standard_normal((b, H, P, N)), jnp.bfloat16))
        jy, jh = jax_decode_step(*j)
        y, h = ssd_decode_step(*(T(a) for a in j))
        _assert_close(y, jy, TOLERANCES["ssd_bf16_kernel"])
        _assert_close(h, jh, TOLERANCES["ssd_bf16_kernel"])


def test_sequential_decode_equals_chunked_prefill():
    """tests/test_kernels.py::test_ssd_decode_consistency on the port:
    decode steps from a zero state give the chunked prefill's y and
    state (f32, its tolerance 1e-3), for both plain versions."""
    b, S, H, P, N = 1, 24, 2, 8, 16
    _, (x, dt, A, B, C, D) = _inputs((b, S, H, P, H, N, 8), "float32",
                                     seed=4)
    h = torch.zeros((b, H, P, N))
    ys = []
    for t in range(S):
        y, h = ssd_decode_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], D, h)
        ys.append(y)
    y_seq = torch.stack(ys, dim=1)
    for y_chunk, h_chunk in (ssd_ref(x, dt, A, B, C, D, 8),
                             ops.ssd(x, dt, A, B, C, D, chunk=8)):
        assert torch.allclose(y_seq, y_chunk, rtol=1e-3, atol=1e-3)
        assert torch.allclose(h, h_chunk, rtol=1e-3, atol=1e-3)


def test_chunk_invariance():
    """tests/test_kernels.py::test_ssd_chunk_invariance on the port: the
    chunk is a tiling knob and does not change y (its 5e-4)."""
    _, t = _inputs((1, 96, 2, 16, 1, 32, 16), "float32", seed=5)
    outs = [ops.ssd(*t, chunk=c)[0] for c in (16, 32, 96)]
    assert torch.allclose(outs[0], outs[1], rtol=5e-4, atol=5e-4)
    assert torch.allclose(outs[0], outs[2], rtol=5e-4, atol=5e-4)


def test_planted_controls_fail_the_one_ulp_tolerance():
    """The controls of chip_smoke.py at a CPU size with mamba2's head
    shape (P 64, N 128, chunk 256, 4 chunks): no state carried across
    chunks, and y_inter from the updated state, each fail ssd_bf16_kernel
    against ssd_kernel_ref; the mask applied after exp gives NaN."""
    import chip_smoke
    g = torch.Generator().manual_seed(6)
    args = chip_smoke.ssd_inputs((1, 1024, 2, 64, 1, 128), torch.bfloat16,
                                 g, "cpu")
    y, h = ssd_kernel_ref(*args, chunk=256)
    tol = TOLERANCES["ssd_bf16_kernel"]
    for fault in chip_smoke.SSD_FAULTS:
        py, ph = chip_smoke.ssd_planted(*args, chunk=256, fault=fault)
        excess = max(tol.excess(py, y), tol.excess(ph, h))
        assert not excess <= 1.0, (fault, excess)
    hy, hh = chip_smoke.ssd_planted(*args, chunk=256, fault=None)
    assert tol.ok(hy, y) and tol.ok(hh, h)       # the harness itself is honest


def test_ssd_cuda_refuses_cpu_tensors():
    """The kernel wrapper never takes the plain version itself."""
    _, t = _inputs(SSD_CASES[0], "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(*t, chunk=16)


def test_ssd_runs_only_on_cpu_or_cuda():
    x = torch.zeros((1, 16, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd(x, x[..., 0], x[0, 0, :, 0], x, x, x[0, 0, :, 0], chunk=16)


# (b, S, H, P, G, N, chunk): a G > 1 shape beside the four of SSD_CASES
CHUNKED_REF_CASES = SSD_CASES + [(1, 96, 4, 16, 2, 32, 32)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CHUNKED_REF_CASES)
def test_chunked_ref_matches_jax_pallas(case, dtype):
    """The chunked mainloop's order against the Pallas kernel (interpret
    mode): y within ssd_f32 / ssd_bf16_kernel, the final state against the
    JAX wrapper's as test_ssd_matches_jax_pallas holds it."""
    j, t = _inputs(case, dtype, seed=11)
    chunk = case[-1]
    jy, jh = jops.ssd(*j, chunk=chunk, interpret=True)
    y, h = ssd_chunked_ref(*t, chunk=chunk)
    tol_y, tol_h = _tols(dtype)
    _assert_close(y, jy, tol_y)
    _assert_close(h, jh, tol_h)


@pytest.mark.parametrize("lens", [(5, 64), (100, 160), (33, 32)])
def test_chunked_ref_rows_equal_alone_and_in_a_bucket(lens):
    """A prompt of S real tokens, alone ([1, S]) and right-padded with
    dt = 0 (random x, B, C past S) into a [2, bucket] launch beside another
    lane, gives the same y rows and final state bit for bit: a padded step
    adds exactly 0 to its chunk's state and the state pass leaves h as it
    is through a padded chunk."""
    S, bucket = lens[0], max(lens)
    bucket = -(-bucket // 32) * 32 + 32          # at least one padded chunk
    case = (2, bucket, 4, 16, 1, 32, 32)
    _, (x, dt, A, B, C, D) = _inputs(case, "bfloat16", seed=12)
    dt = dt.clone()
    dt[0, S:] = 0.0
    y, h = ssd_chunked_ref(x, dt, A, B, C, D, chunk=32)
    ya, ha = ssd_chunked_ref(x[:1, :S].clone(), dt[:1, :S].clone(), A,
                             B[:1, :S].clone(), C[:1, :S].clone(), D,
                             chunk=32)
    assert torch.equal(y[:1, :S], ya) and torch.equal(h[:1], ha)


def test_chunked_ref_controls_fail_the_one_ulp_tolerance():
    """At mamba2's head shape (P 64, N 128, chunk 256, 4 chunks) the plain
    three-phase version equals ssd_kernel_ref within ssd_bf16_kernel, and
    each of its planted faults (the state pass without its exp(cum_end)
    decay; cum carried across chunk boundaries) fails it, in y or h."""
    import chip_smoke
    g = torch.Generator().manual_seed(13)
    args = chip_smoke.ssd_inputs((1, 1024, 2, 64, 1, 128), torch.bfloat16,
                                 g, "cpu")
    y, h = ssd_kernel_ref(*args, chunk=256)
    tol = TOLERANCES["ssd_bf16_kernel"]
    cy, ch = ssd_chunked_ref(*args, chunk=256)
    assert tol.ok(cy, y) and tol.ok(ch, h)
    for fault in CHUNKED_FAULTS:
        py, ph = ssd_chunked_ref(*args, chunk=256, fault=fault)
        excess = max(tol.excess(py, y), tol.excess(ph, h))
        assert not excess <= 1.0, (fault, excess)


@pytest.mark.parametrize("shape, dtype, mainloop", [
    # mamba2-370m's served tiles (P, N, chunk) and hymba-1.5b's SSM heads
    ((64, 128, 256), torch.bfloat16, "chunked"),
    ((64, 128, 256), torch.float32, "serial"),
    ((64, 16, 256), torch.bfloat16, "serial"),
    # reduced(mamba2-370m) in the CPU model tests
    ((16, 16, 32), torch.bfloat16, "serial"),
    ((16, 16, 32), torch.float32, "serial"),
    # other chunks at mamba2's P and N
    ((64, 128, 128), torch.bfloat16, "serial"),
    ((64, 128, 512), torch.bfloat16, "serial"),
] + [((c[3], c[5], c[6]), dt, "serial") for c in SSD_CASES
     for dt in (torch.float32, torch.bfloat16)])
def test_ssd_plan(shape, dtype, mainloop):
    """chunked takes bf16 at mamba2's tiles only; f32 (sub-chunks
    included) and every other shape stay on serial."""
    assert ssd_plan(*shape, dtype) == mainloop


def test_ssd_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="ssd takes"):
        ssd_plan(64, 128, 256, torch.float16)


def _apply_ssm_views():
    """The (x, dt, A, B, C, D, chunk) that apply_ssm hands the SSD kernel's
    entry point in a reduced(mamba2-370m) prefill of 64 tokens (two chunks
    of 32), recorded on the CPU."""
    cfg = reduced(get_arch("mamba2-370m"))
    model = Model(cfg, device="cpu", use_pallas=True, ssd_impl="pallas")
    params = model.init(torch.Generator().manual_seed(0))
    seen = []

    def record(x, dt, A, B, C, D, *, chunk):
        seen.append((x, dt, A, B, C, D, chunk))
        return ops.ssd(x, dt, A, B, C, D, chunk=chunk)

    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (2, 64)))
    orig, tssm.ssd_kernel = tssm.ssd_kernel, record
    try:
        model.forward(params, {"tokens": tokens})
    finally:
        tssm.ssd_kernel = orig
    assert len(seen) == cfg.n_layers
    return seen[0]


def test_ssd_cuda_takes_apply_ssm_views_by_stride():
    """x, B and C reach the kernel wrapper as views into one projection
    (rows of di + 2 G N elements), not copies: its input check takes them
    as they are, rows 16-byte aligned for the chunked mainloop; a view
    whose last dim is not contiguous is refused."""
    x, dt, A, B, C, D, chunk = _apply_ssm_views()
    assert not x.is_contiguous() and not B.is_contiguous()
    assert x.stride(1) == B.stride(1) == C.stride(1) > x.shape[2] * x.shape[3]
    dt, A, D = dt.float().contiguous(), A.float(), D.float()
    ssd_mod.check_inputs(x, dt, A, B, C, D, chunk=chunk)
    assert all(ssd_mod._vector_ready(t) for t in (x, B, C))
    for bad in ("x", "B", "C"):
        args = {"x": x, "B": B, "C": C}
        t = args[bad]
        wide = t.new_zeros(*t.shape[:3], 2 * t.shape[3])
        wide[..., ::2] = t
        args[bad] = wide[..., ::2]                # last stride 2
        with pytest.raises(ValueError, match="contiguous last dim"):
            ssd_mod.check_inputs(args["x"], dt, A, args["B"], args["C"], D,
                                 chunk=chunk)


def test_mainloop_override_is_held_to_the_plan():
    """serial may be asked for at any shape (to time it beside chunked);
    chunked only where the plan picks it."""
    bf16 = torch.bfloat16
    assert ssd_mod.resolve_mainloop(64, 128, 256, bf16, None) == "chunked"
    assert ssd_mod.resolve_mainloop(64, 128, 256, bf16, "serial") == "serial"
    for P, N, chunk, dtype in ((64, 128, 256, torch.float32),
                               (16, 32, 32, bf16), (64, 128, 128, bf16)):
        with pytest.raises(ValueError, match="does not take"):
            ssd_mod.resolve_mainloop(P, N, chunk, dtype, "chunked")
    with pytest.raises(ValueError, match="does not take"):
        ssd_mod.resolve_mainloop(64, 128, 256, bf16, "wgmma")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """ops.ssd on CUDA tensors (padding, then the kernel) against the
    Pallas kernel's arithmetic, y and the final state; in f32 at mamba2's
    tiles too (the kernel's sub-chunks)."""
    before = ssd_cuda.launches
    for case in SSD_CASES + [(2, 600, 8, 64, 2, 128, 256)]:
        _, t = _inputs(case, dtype)
        t = tuple(a.to(cuda_device) for a in t)
        y, h = ops.ssd(*t, chunk=case[-1])
        # the plain version at the chunk the kernel runs (f32 sub-chunks)
        ry, rh = ssd_kernel_ref(*t, chunk=run_chunk(case[-1], case[3],
                                                    case[5], t[0].dtype))
        torch.cuda.synchronize()
        tol = _tols(dtype)[0]
        if dtype == "float32" and case[-1] >= 128:
            tol = TOLERANCES["ssd_f32_rows"]   # mamba2-sized f32 chunks
        assert tol.ok(y.float(), ry.float()) and tol.ok(h.float(), rh.float())
    assert ssd_cuda.launches > before


@pytest.mark.gpu
def test_chunked_mainloop_on_card(cuda_device):
    """mamba2's tiles in bf16 run the chunked mainloop, within
    ssd_bf16_kernel of the Pallas kernel's arithmetic and of the serial
    mainloop; a prompt's rows and state are bit-equal alone and in a
    bucket; strided views of one projection equal contiguous copies."""
    import chip_smoke
    g = torch.Generator("cuda").manual_seed(15)
    shape = (2, 768, 8, 64, 1, 128)
    x, dt, A, B, C, D = chip_smoke.ssd_inputs(shape, torch.bfloat16, g)
    dt[1, 600:] = 0.0
    before = dict(ssd_cuda.mainloop_launches)
    y, h = ops.ssd(x, dt, A, B, C, D, chunk=256)
    assert ssd_cuda.mainloop_launches["chunked"] == before["chunked"] + 1
    sy, sh = ssd_cuda(x, dt, A, B, C, D, chunk=256, mainloop="serial")
    ky, kh = ssd_kernel_ref(x, dt, A, B, C, D, chunk=256)
    torch.cuda.synchronize()
    tol = TOLERANCES["ssd_bf16_kernel"]
    for got, ref in ((y, ky), (h, kh), (y, sy), (h, sh)):
        assert tol.ok(got, ref), tol.excess(got, ref)
    ya, ha = ops.ssd(*(t[1:2, :600].contiguous() for t in (x, dt)), A,
                     *(t[1:2, :600].contiguous() for t in (B, C)), D,
                     chunk=256)
    assert torch.equal(y[1:2, :600], ya) and torch.equal(h[1:2], ha)
    b, S, H, P, G, N = shape
    proj = torch.randn((b, S, H * P + 2 * G * N), generator=g,
                       device="cuda").to(torch.bfloat16)
    xs, Bs, Cs = torch.split(proj, [H * P, G * N, G * N], dim=-1)
    views = (xs.reshape(b, S, H, P), Bs.reshape(b, S, G, N),
             Cs.reshape(b, S, G, N))
    yv, hv = ssd_cuda(views[0], dt, A, views[1], views[2], D, chunk=256)
    yc, hc = ssd_cuda(*(t.contiguous() for t in views[:1]), dt, A,
                      *(t.contiguous() for t in views[1:]), D, chunk=256)
    assert torch.equal(yv, yc) and torch.equal(hv, hc)


def drift_readings(seeds=(0, 1)) -> list[dict]:
    """The CPU readings behind ssd_bf16_reference: the excess of the
    Pallas kernel's arithmetic (ssd_kernel_ref, f32 state) against the
    reference (ssd_ref, bf16 state) on mamba2-like inputs, y and the final
    state, and the excess of y under a row-rms atol instead, which rows
    whose terms cancel (M x against D x) blow up. `ssd_ref_vs_kernel_tol`
    is the bf16-state reference held to ssd_bf16_kernel, as chip_smoke.py
    holds it as a planted control at the served shape;
    `state_in_bf16_vs_kernel_tol` rounds only the state and y_inter."""
    import chip_smoke
    from repro_torch.runtime import RowTol
    row = RowTol(2 ** -6, 2 ** -2, "row-rms alternative")
    tol = TOLERANCES["ssd_bf16_reference"]
    kernel_tol = TOLERANCES["ssd_bf16_kernel"]
    out = []
    for seed in seeds:
        for shape in [(2, 2048, 32, 64, 1, 128), (2, 1000, 32, 64, 1, 128),
                      (2, 512, 32, 64, 4, 128)]:
            g = torch.Generator().manual_seed(seed)
            args = chip_smoke.ssd_inputs(shape, torch.bfloat16, g, "cpu")
            ky, kh = ssd_kernel_ref(*args, chunk=256)
            ry, rh = ssd_ref(*args, 256)
            py, ph = chip_smoke.ssd_planted(*args, chunk=256,
                                            fault="state_in_bf16")
            out.append({"seed": seed, "shape": list(shape),
                        "y": tol.excess(ky, ry), "h": tol.excess(kh, rh),
                        "y_row_rms_atol": row.excess(ky, ry),
                        "ssd_ref_vs_kernel_tol": {
                            "y": kernel_tol.excess(ry, ky),
                            "h": kernel_tol.excess(rh, kh)},
                        "state_in_bf16_vs_kernel_tol": {
                            "y": kernel_tol.excess(py, ky),
                            "h": kernel_tol.excess(ph, kh)}})
    return out


if __name__ == "__main__":
    import json
    for r in drift_readings():
        print(json.dumps(r))
