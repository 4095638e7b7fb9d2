"""The port's flash attention against the JAX package's.

On the CPU `repro_torch...flash_attention.ops.flash_attention` runs its
plain version (naive attention); it is held against the JAX Pallas kernel
in interpret mode over the cases of tests/test_kernels.py, f32 and bf16,
plus Sq != Skv, at TOLERANCES["flash_f32"] / ["flash_bf16"]. The plain
version of the Pallas kernel's own arithmetic (`flash_attention_tiled_ref`,
which the card holds the Hopper kernel to) matches Pallas at about one
bf16 ulp at every key tile `flash_plan` can pick (the Pallas kernel run
with that tile), and that tolerance rejects faults on late KV tiles. The
plan itself is a pure function of the head dim and dtype. The model
with `attention_impl="pallas"` is held against the JAX Model built the same
way, on bridged parameters. The Hopper kernel itself runs only on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.models.model import Model as JaxModel
from repro_torch import TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.flash_attention import (
    MAX_HEAD_DIM, flash_attention_cuda, flash_plan)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_tiled_ref)
from repro_torch.models import attention as tatt
from repro_torch.models.model import Model

ATTN_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window: tests/test_kernels.py's six
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 100, 100, 8, 8, 16, True, None),
    (2, 33, 33, 4, 1, 64, False, None),
    (1, 128, 128, 5, 5, 32, True, 48),
    (1, 256, 256, 16, 2, 64, True, None),
    (1, 80, 80, 6, 3, 128, True, 16),
    # Sq != Skv: causal positions count from 0 on both sides
    (2, 48, 80, 4, 2, 32, True, None),
]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
HEAD_DIMS = range(8, MAX_HEAD_DIM + 1, 8)
# every key tile the kernel's bf16 mainloops use
BLOCK_KS = sorted({flash_plan(D, torch.bfloat16).block_k for D in HEAD_DIMS})


def _tol(dtype):
    return TOLERANCES["flash_f32" if dtype == "float32" else "flash_bf16"]


def _qkv(rng, B, Sq, Skv, Hq, Hkv, D, dtype):
    j = [jnp.asarray(rng.standard_normal(s), DTYPES[dtype])
         for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    return j, [params_from_jax(np.asarray(a)) for a in j]


def _assert_close(got: torch.Tensor, ref, tol):
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    assert tol.ok(got.float(), ref_t), (
        f"max_abs_err {(got.float() - ref_t).abs().max()} ({tol})")


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_jax_pallas(case, dtype):
    B, Sq, Skv, Hq, Hkv, D, causal, win = case
    rng = np.random.default_rng(sum(case[:6]))
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, B, Sq, Skv, Hq, Hkv, D, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=win)
    assert got.dtype == tq.dtype
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=win,
                                  block_q=64, block_k=64, interpret=True)
    _assert_close(got, pallas, _tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kv_len_tail_matches_jax_pallas(dtype):
    """The plain version's kv_len mask against the Pallas kernel's (keys at
    or past kv_len are padding), non-causal so every key would count."""
    rng = np.random.default_rng(11)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 2, 64, 64, 4, 2, 32, dtype)
    got = flash_attention_ref(tq, tk, tv, causal=False, kv_len=50)
    pallas = flash_attention_pallas(jq, jk, jv, causal=False, block_q=32,
                                    block_k=32, kv_len=50, interpret=True)
    _assert_close(got, pallas, _tol(dtype))
    full = flash_attention_ref(tq, tk, tv, causal=False)
    assert not torch.equal(got, full)


def test_flash_plan_mainloops():
    """bf16 at D = 64 and 128 (every served head dim) on wgmma, every other
    bf16 D on mma, f32 on simt; no other dtype."""
    for D in HEAD_DIMS:
        plan = flash_plan(D, torch.bfloat16)
        want = "wgmma" if D in (64, 128) else "mma"
        assert plan.mainloop == want, (D, plan)
        assert plan.block_q == (128 if want == "wgmma" else 64), (D, plan)
        assert flash_plan(D, torch.float32).mainloop == "simt"
    with pytest.raises(ValueError, match="flash attention takes"):
        flash_plan(64, torch.float16)


def test_flash_plan_key_tile_depends_on_head_dim_and_dtype_only():
    """The key tile is a multiple of 16 (one k16 step of PV) that the plan
    reads from D and the dtype alone: no sequence length or batch enters
    it, so a row rounds p at the same keys in a bucket or alone."""
    import inspect
    assert list(inspect.signature(flash_plan).parameters) == ["D", "dtype"]
    for D in HEAD_DIMS:
        bk = flash_plan(D, torch.bfloat16).block_k
        assert bk % 16 == 0 and bk >= 32, (D, bk)
    assert flash_plan(128, torch.bfloat16).block_k == 128
    assert flash_plan(192, torch.bfloat16).block_k == 32
    assert flash_plan(128, torch.float32).block_k == 1
    assert BLOCK_KS == [32, 64, 128]


@pytest.mark.parametrize("block_k", BLOCK_KS)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_tiled_plain_matches_jax_pallas(case, block_k):
    """The Pallas kernel's arithmetic block by block, in torch ops, against
    Pallas itself run with the same key tile (bf16, block_k as the JAX
    wrapper clamps it): equal up to f32 sums in another order, at
    flash_bf16_tiled, at every tile the kernel's mainloops use. The naive
    version's bf16 scores miss that tolerance, so the card gates the kernel
    on the tiled version."""
    B, Sq, Skv, Hq, Hkv, D, causal, win = case
    rng = np.random.default_rng(sum(case[:6]))
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, B, Sq, Skv, Hq, Hkv, D,
                                      "bfloat16")
    got = flash_attention_tiled_ref(tq, tk, tv, causal=causal, window=win,
                                    block_k=min(block_k, max(8, Skv)))
    assert got.dtype == tq.dtype
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=win,
                                  block_q=64, block_k=block_k,
                                  interpret=True)
    _assert_close(got, pallas, TOLERANCES["flash_bf16_tiled"])


@pytest.mark.parametrize("bk", BLOCK_KS)
def test_tiled_tolerance_rejects_late_tile_faults(bk):
    """The late-tile controls of chip_smoke.py at a CPU size, at each key
    tile of the kernel: a stale last K tile and PV summed in bf16 each fail
    flash_bf16_tiled against the tiled plain version."""
    import chip_smoke
    g = torch.Generator().manual_seed(5)
    S = 1024
    q, k, v = (torch.randn((1, S, h, 64), generator=g).to(torch.bfloat16)
               for h in (8, 2, 2))
    tiled = flash_attention_tiled_ref(q, k, v, causal=True, block_k=bk)
    stale = k.clone()
    stale[:, S - bk:] = k[:, S - 2 * bk:S - bk]
    tol = TOLERANCES["flash_bf16_tiled"]
    assert tol.excess(flash_attention_tiled_ref(
        q, stale, v, causal=True, block_k=bk), tiled) > 10
    assert tol.excess(chip_smoke.pv_summed_in_bf16(q, k, v, bk), tiled) > 1


def _served_case(seed, shape=(1, 1277, 48, 8, 128), bk=None):
    """dbrx-132b's longest exact-length prefill: the tiled plain version,
    the same with its scores summed in f64, and the two late-tile
    controls of chip_smoke.py, at key tile bk (the plan's for D by
    default)."""
    import chip_smoke
    B, S, Hq, Hkv, D = shape
    bk = flash_plan(D, torch.bfloat16).block_k if bk is None else bk
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, D), generator=g).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    tiled = flash_attention_tiled_ref(q, k, v, causal=True, block_k=bk)
    other = flash_attention_tiled_ref(q, k, v, causal=True, block_k=bk,
                                      score_dtype=torch.float64)
    stale = k.clone()
    stale[:, S - bk:] = k[:, S - 2 * bk:S - bk]
    controls = {"stale_last_k_tile": flash_attention_tiled_ref(
                    q, stale, v, causal=True, block_k=bk),
                "pv_summed_in_bf16": chip_smoke.pv_summed_in_bf16(q, k, v,
                                                                  bk)}
    return tiled, other, controls


@pytest.mark.parametrize("bk", BLOCK_KS)
def test_served_tolerance_holds_sum_order_and_rejects_late_tile_faults(bk):
    """flash_bf16_tiled_served, the card's gate at served sizes, at each
    key tile of the kernel: the tiled plain version against itself with its
    scores summed in f64 (another order of the f32 sums, all that
    separates two right kernels) stays within it; a stale last K tile and
    PV summed in bf16 fail it."""
    tol = TOLERANCES["flash_bf16_tiled_served"]
    tiled, other, controls = _served_case(1, bk=bk)
    assert tol.ok(tiled, other), tol.excess(tiled, other)
    assert tol.excess(controls["stale_last_k_tile"], tiled) > 10
    assert tol.excess(controls["pv_summed_in_bf16"], tiled) > 1


def order_readings(seeds=(0, 1, 2, 3)) -> list[dict]:
    """The CPU readings behind flash_bf16_tiled_served: the tiled plain
    version against itself with f64-summed scores, and each late-tile
    control against it, at flash_bf16_tiled and at the served tolerance,
    on granite-8b's heads ([1, 2048, 32 over 8, 128]) and dbrx-132b's, at
    the kernel's key tile for their head dim (flash_plan)."""
    one_ulp = TOLERANCES["flash_bf16_tiled"]
    served = TOLERANCES["flash_bf16_tiled_served"]
    out = []
    for shape in [(1, 2048, 32, 8, 128), (1, 1277, 48, 8, 128)]:
        for seed in seeds:
            tiled, other, controls = _served_case(seed, shape)
            out.append({"shape": list(shape), "seed": seed,
                        "block_k": flash_plan(shape[-1],
                                              torch.bfloat16).block_k,
                        "plain_vs_itself": {
                            "flash_bf16_tiled": one_ulp.excess(other, tiled),
                            "served": served.excess(other, tiled)},
                        "controls_at_served": {
                            n: served.excess(c, tiled)
                            for n, c in controls.items()}})
    return out


def test_attention_dispatch_by_impl():
    """attention(impl=...) reaches chunked attention or the flash entry
    point; on the CPU both compute the same function."""
    rng = np.random.default_rng(13)
    _, (tq, tk, tv) = _qkv(rng, 2, 20, 20, 4, 2, 16, "float32")
    tol = TOLERANCES["attention_f32"]
    ref = tatt.naive_attention(tq, tk, tv, window=6)
    for impl in ("chunked", "pallas"):
        got = tatt.attention(tq, tk, tv, impl=impl, window=6)
        assert tol.ok(got, ref), impl
    with pytest.raises(ValueError):
        tatt.attention(tq, tk, tv, impl="cudnn")


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """The kernel wrapper never takes the plain version itself, and raises
    on what the kernel does not take."""
    q = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    for D in (12, 264):
        qd = torch.zeros((1, 8, 4, D), dtype=torch.bfloat16)
        kd = torch.zeros((1, 8, 2, D), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention_cuda(qd, kd, kd)
    with pytest.raises(ValueError, match="share"):
        flash_attention_cuda(q, k.float(), k)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention_cuda(q, torch.zeros((1, 8, 3, 16),
                                            dtype=torch.bfloat16),
                             torch.zeros((1, 8, 3, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_cuda(q, k, k, kv_len=9)
    with pytest.raises(ValueError, match="window"):
        flash_attention_cuda(q, k, k, window=0)


def test_flash_runs_only_on_cpu_or_cuda():
    x = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(x, x, x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_model_with_flash_prefill_matches_jax(dtype):
    """Model(attention_impl="pallas", use_pallas=True) against the JAX
    Model built the same way (Pallas flash attention and pod GEMM in
    interpret mode), one prefill plus 4 decode steps on bridged params."""
    cfg = reduced(get_arch("granite-8b"))
    jm = JaxModel(cfg, attention_impl="pallas", use_pallas=True)
    tm = Model(t_reduced(t_get_arch("granite-8b")), attention_impl="pallas",
               use_pallas=True, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jdt, tdt = jnp.float32, torch.float32
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tol = TOLERANCES["logits_bf16" if dtype == "bfloat16" else "logits_f32"]

    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                 jm.init_cache(2, 16, dtype=jdt))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, 16, dtype=tdt))
    scale = float(np.abs(np.asarray(jl, np.float32)).max())

    def close(a, b):
        ref = torch.from_numpy(np.array(b, np.float32))
        err = (a.float() - ref).abs()
        assert bool((err <= tol.atol * scale + tol.rtol * ref.abs()).all()), \
            f"max_abs_err {float(err.max())} ({tol})"
    close(tl, jl)
    tok = np.asarray(jl, np.float32).argmax(-1)
    jit_decode = jax.jit(jm.decode_step)
    for s in range(4):
        pos = np.array([12 + s, 12 + s])
        jl, jc = jit_decode(jp, jnp.asarray(tok, jnp.int32), jc,
                            jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        close(tl, jl)
        tok = np.asarray(jl, np.float32).argmax(-1)


def _prefill_logits(model, params, toks):
    if isinstance(model, JaxModel):
        logits, _ = jax.jit(model.forward)(
            params, {"tokens": jnp.asarray(toks, jnp.int32)})
        return np.asarray(logits[0], np.float32)
    logits, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    return logits[0].float().numpy()


def test_flash_and_chunked_drift_apart_in_bf16_as_in_the_reference():
    """Flash attention keeps f32 scores; chunked attention rounds them to
    bf16. Random weights with the reference's fan-in (the [d, H, hd]
    projections scale by H) give large scores and a nearly one-hot
    softmax, so the bf16-rounded scores pick other keys wherever two are
    close, and two layers carry that into logit differences that flip
    near-tied tokens. The JAX reference does so itself: its Pallas against
    its chunked prefill drifts in bf16 by orders of magnitude more than in
    f32. The port's flash against chunked drift stays within the
    reference's own. This is why chip_smoke.py reports flash-vs-chunked
    tokens and holds the paged flash engine to the margin rule against the
    oracle of the same model."""
    cfg = reduced(get_arch("granite-8b"))
    tcfg = t_reduced(t_get_arch("granite-8b"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 154))
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))     # noqa: E731
    drift = {}
    for dtype in ("float32", "bfloat16"):
        jp = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)),
                          JaxModel(cfg).init(jax.random.PRNGKey(0)))
        tp = params_from_jax(jax.tree.map(np.asarray, jp))
        for side, p in (("jax", jp), ("port", tp)):
            logits = {}
            for impl in ("pallas", "chunked"):
                m = (JaxModel(cfg, attention_impl=impl, use_pallas=True)
                     if side == "jax" else
                     Model(tcfg, attention_impl=impl, use_pallas=True,
                           device="cpu"))
                logits[impl] = _prefill_logits(m, p, toks)
            drift[side, dtype] = rms(logits["pallas"] - logits["chunked"])
    assert drift["jax", "bfloat16"] > 1000 * drift["jax", "float32"], drift
    assert drift["port", "bfloat16"] <= 2 * drift["jax", "bfloat16"], drift
    assert drift["port", "float32"] <= 10 * drift["jax", "float32"] + \
        TOLERANCES["logits_f32"].atol, drift


def test_model_rejects_unknown_attention_impl():
    with pytest.raises(ValueError, match="attention_impl"):
        Model(t_reduced(t_get_arch("granite-8b")), attention_impl="sdpa",
              device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    g = torch.Generator(cuda_device).manual_seed(0)
    tol = TOLERANCES["flash_f32" if dtype == torch.float32 else "flash_bf16"]
    tight = TOLERANCES["flash_bf16_tiled"]
    for B, Sq, Skv, Hq, Hkv, D, causal, win in ATTN_CASES + [
            (2, 333, 333, 32, 8, 128, True, None),
            (1, 200, 200, 8, 8, 192, True, None)]:
        q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
                   for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                             (B, Skv, Hkv, D)))
        before = flash_attention_cuda.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=win)
        ref = flash_attention_ref(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == before + 1
        assert tol.ok(got, ref), (B, Sq, Skv, Hq, Hkv, D, causal, win)
        if dtype == torch.bfloat16:       # the kernel's key tile
            tiled = flash_attention_tiled_ref(
                q, k, v, causal=causal, window=win,
                block_k=flash_plan(D, dtype).block_k)
            assert tight.ok(got, tiled), (B, Sq, Skv, Hq, Hkv, D, causal, win)


@pytest.mark.gpu
def test_wgmma_rows_equal_alone_and_in_a_bucket_on_card(cuda_device):
    """bf16 at D = 128 runs on wgmma, and a prompt's rows come out bit-equal
    prefilled alone ([1, S]) and in lane 2 of a [4, 2S] bucket."""
    g = torch.Generator(cuda_device).manual_seed(1)
    for S, Hq, Hkv in ((200, 32, 8), (333, 48, 8)):
        q, k, v = (torch.randn((4, 2 * S, h, 128), generator=g,
                               device=cuda_device).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        before = dict(flash_attention_cuda.mainloop_launches)
        alone = flash_attention_cuda(*(t[2:3, :S].contiguous()
                                       for t in (q, k, v)), causal=True)
        bucket = flash_attention_cuda(q, k, v, causal=True)[2:3, :S]
        assert flash_attention_cuda.mainloop_launches["wgmma"] == \
            before["wgmma"] + 2
        assert torch.equal(alone, bucket), S


if __name__ == "__main__":
    import json
    for r in order_readings():
        print(json.dumps(r))
