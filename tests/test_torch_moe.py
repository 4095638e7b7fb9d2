"""The port's MoE family (dbrx) against the JAX package, on the CPU.

reduced(dbrx-132b) at dbrx's own norm and RoPE (layernorm, theta 500000):
2 layers, d 64, 4 heads over 2 KV heads, 4 experts of d_ff 32, top 2.
Parameters come from the JAX Model (bridge.params_from_jax); inputs from
numpy seeds.

* `_route` (expert ids, capacity positions, keep mask, capacity) is equal
  to JAX's on the same f32 input, for the sort and the one-hot position
  computations, with and without capacity drops;
* `apply_moe` against JAX's `apply_moe`, use_pallas off and on (JAX's
  grouped Pallas kernel in interpret mode, the port's plain version), on
  dbrx's MoE and on deepseek-v2's (shared experts) at module level;
* the use_pallas path runs three grouped GEMMs per layer and no einsum
  expert;
* Model logits, prefill then decode, f32 and bf16, use_pallas off and on;
* served tokens: the port's ServeEngine against JAX's ServeEngine and the
  port's ReferenceEngine against JAX's, on the serve-matrix prompts. At
  decode the whole batch is one routing group, so a dead lane's token
  takes capacity from live ones: engines are compared with the engine
  that feeds the same dead lanes. Where tokens differ, the margin rule
  (`token_margin`) holds at the first difference;
* exact-length prefill: `bucketed` False, one [1, S] prefill and one host
  sync per request; paging refused for moe.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import moe as jmoe
from repro.models.layers import init_from_schema as jinit
from repro.models.model import Model as JaxModel
from repro.models.transformer import segments as jsegments
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.reference import ReferenceEngine as JaxReferenceEngine
from repro_torch import HOST_SYNCS, TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.kernels.systolic_gemm.systolic_gemm import (
    grouped_systolic_gemm_cuda)
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model
from repro_torch.models.transformer import segments
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.reference import ReferenceEngine

ARCH = "dbrx-132b"
DBRX = dict(rope_theta=500000.0)          # reduced() keeps norm, not theta
T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)


def _cfgs(arch=ARCH, **moe):
    """The JAX and port configs of reduced(arch), dbrx's RoPE theta, and
    MoE fields replaced by `moe`."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), **DBRX)
    tcfg = dataclasses.replace(t_reduced(t_get_arch(arch)), **DBRX)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return cfg, tcfg


def _moe_params(cfg, dtype=jnp.float32):
    p = jinit(jax.random.PRNGKey(0), jmoe.moe_schema(cfg))
    p = jax.tree.map(lambda a: a.astype(dtype), p)
    return p, params_from_jax(jax.tree.map(np.asarray, p))


def _close(got: torch.Tensor, ref, tol, scale=None):
    """Within tol; with a scale (max |ref|) atol is relative to it, as in
    tests/test_torch_model.py."""
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    assert got.shape == ref_t.shape
    err = (got.float() - ref_t).abs()
    atol = tol.atol * (scale if scale is not None else 1.0)
    assert bool((err <= atol + tol.rtol * ref_t.abs()).all()), (
        f"max_abs_err {float(err.max())} ({tol})")


# --------------------------------------------------------------------------
# routing and the MoE layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 0.5, 100.0], ids=["dbrx", "drops",
                                                       "no-drop"])
@pytest.mark.parametrize("use_sort", [True, False], ids=["sort", "onehot"])
def test_route_matches_jax(use_sort, cf):
    """Expert ids, capacity positions, keep mask and capacity are equal to
    JAX's; gate values within elementwise_f32 (an f32 softmax)."""
    cfg, tcfg = _cfgs(capacity_factor=cf, group_size=16)
    p, tp = _moe_params(cfg)
    x = np.random.default_rng(0).standard_normal((3, 16, cfg.d_model))
    x = x.astype(np.float32)
    G, n = jmoe._group_shape(48, cfg.moe.group_size)
    jr = jmoe._route(p, jnp.asarray(x).reshape(G, n, -1), cfg.moe,
                     use_sort=use_sort)
    tr = tmoe._route(tp, torch.from_numpy(x).reshape(G, n, -1), tcfg.moe,
                     use_sort=use_sort)
    assert tr[4] == jr[4]                                      # capacity
    for name, a, b in zip(("expert_idx", "pos", "keep"), jr[1:4], tr[1:4]):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    _close(tr[0], jr[0], TOLERANCES["elementwise_f32"])
    kept = int(tr[3].sum())
    if cf == 100.0:
        assert kept == tr[3].numel()
    elif cf == 0.5:
        assert kept < tr[3].numel()        # real capacity drops


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router probabilities pick the lower expert ids first, as
    jax.lax.top_k does."""
    cfg, tcfg = _cfgs()
    p, tp = _moe_params(cfg)
    p = dict(p, router=jnp.zeros_like(p["router"]))           # all tied
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.ones((1, 4, cfg.d_model), np.float32)
    jr = jmoe._route(p, jnp.asarray(x), cfg.moe, use_sort=True)
    tr = tmoe._route(tp, torch.from_numpy(x), tcfg.moe, use_sort=True)
    assert np.array_equal(np.asarray(jr[1]), tr[1].numpy())
    assert tr[1][0, 0].tolist() == list(range(cfg.moe.top_k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "grouped"])
@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-236b"])
def test_apply_moe_matches_jax(arch, use_pallas, dtype):
    """The MoE layer against JAX's: dbrx (16 tokens per group, drops at
    capacity factor 1.25) and deepseek-v2's shared experts. f32 at
    elementwise_f32 of the output's max; bf16 at logits_bf16 (the expert
    outputs, h * g and the combine round to bf16 at the reference's
    points, sums run in another order)."""
    cfg, tcfg = _cfgs(arch, group_size=16)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p, tp = _moe_params(cfg, jdt)
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model))
    jx = jnp.asarray(x, jdt)
    ref = jmoe.apply_moe(p, jx, cfg, use_pallas=use_pallas)
    got = tmoe.apply_moe(tp, T(jx), tcfg, use_pallas=use_pallas)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    tol = TOLERANCES["elementwise_f32" if dtype == "float32"
                     else "logits_bf16"]
    _close(got, ref, tol, float(np.abs(np.asarray(ref, np.float32)).max()))


def test_sort_and_onehot_dispatch_agree_with_drops():
    """The port's two dispatches give the same layer, capacity drops
    included (tests/test_moe.py holds JAX's the same way)."""
    _, tcfg = _cfgs(capacity_factor=0.5, group_size=16)
    cfg, _ = _cfgs(capacity_factor=0.5, group_size=16)
    _, tp = _moe_params(cfg)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    sort = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, dispatch="sort"))
    a = tmoe.apply_moe(tp, x, tcfg)
    for other in (tmoe.apply_moe(tp, x, sort),
                  tmoe.apply_moe(tp, x, tcfg, use_pallas=True)):
        assert TOLERANCES["elementwise_f32"].ok(other, a)


def test_pod_dispatch_runs_grouped_gemm_not_einsum(monkeypatch):
    """The hot path hits the grouped GEMM three times per layer (up, gate,
    down) and never the einsum experts."""
    calls = {"grouped": 0, "einsum_experts": 0}
    real_gg, real_ex = tmoe.grouped_gemm, tmoe._experts

    def gg(*a, **k):
        calls["grouped"] += 1
        return real_gg(*a, **k)

    def ex(*a, **k):
        calls["einsum_experts"] += 1
        return real_ex(*a, **k)
    monkeypatch.setattr(tmoe, "grouped_gemm", gg)
    monkeypatch.setattr(tmoe, "_experts", ex)
    cfg, tcfg = _cfgs()
    _, tp = _moe_params(cfg)
    x = torch.randn((1, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    tmoe.apply_moe(tp, x, tcfg, use_pallas=True)
    assert calls == {"grouped": 3, "einsum_experts": 0}
    tmoe.apply_moe(tp, x, tcfg)
    assert calls == {"grouped": 3, "einsum_experts": 1}


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "kernels"])
def test_model_logits_match_jax(use_pallas, dtype):
    """Prefill then 6 decode steps against the JAX Model (its Pallas
    kernels in interpret mode, the port's plain versions), on bridged
    parameters. The router stays f32 in both dtypes."""
    cfg, tcfg = _cfgs()
    jm = JaxModel(cfg, use_pallas=use_pallas)
    tm = Model(tcfg, use_pallas=use_pallas, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jdt, tdt = jnp.float32, torch.float32
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert tp["moe"]["moe"]["router"].dtype == torch.float32
    tol = TOLERANCES["logits_bf16" if dtype == "bfloat16" else "logits_f32"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                 jm.init_cache(2, 64, dtype=jdt))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, 64, dtype=tdt))
    scale = float(np.abs(np.asarray(jl, np.float32)).max())
    _close(tl, jl, tol, scale)
    tok = np.asarray(jl, np.float32).argmax(-1)
    decode = jax.jit(jm.decode_step)
    for s in range(6):
        pos = np.array([40 + s, 40 + s])
        jl, jc = decode(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl, tol, scale)
        tok = np.asarray(jl, np.float32).argmax(-1)     # same inputs both


def test_segments_schema_and_paging_for_moe():
    """dbrx is one `moe` segment of GQA + MoE blocks; an MLA model
    (deepseek-v2) has the reference's segments, a first dense layer
    before the MoE stack; moe prefills exact-length and does not page."""
    _, tcfg = _cfgs()
    assert [(s.name, s.kind, s.n) for s in segments(tcfg)] == \
        [("moe", "moe", 2)]
    for cfg, jcfg in ((t_get_arch("deepseek-v2-236b"),
                       get_arch("deepseek-v2-236b")),
                      (t_reduced(t_get_arch("deepseek-v2-236b")),
                       reduced(get_arch("deepseek-v2-236b")))):
        assert [(s.name, s.kind, s.n) for s in segments(cfg)] == \
            [(s.name, s.kind, s.n) for s in jsegments(jcfg)] == \
            [("dense0", "dense", 1), ("moe", "moe", cfg.n_layers - 1)]
    tm = Model(tcfg, device="cpu")
    sch = tm.schema()["moe"]
    assert set(sch) == {"ln_attn", "attn", "ln_mlp", "moe"}
    assert set(sch["ln_attn"]) == {"scale", "bias"}           # layernorm
    assert sch["moe"]["router"].dtype == torch.float32
    assert sch["moe"]["up"].shape == (2, 4, 64, 32)
    assert not tm.bucketed_prefill_ok
    with pytest.raises(ValueError, match="bucketed"):
        tm.init_cache(2, 32, page_size=8, kv_pages=8)
    with pytest.raises(ValueError, match="bucketed"):
        ServeEngine(tm, {}, slots=2, max_len=32, paged=True, page_size=8)
    assert ServeEngine(tm, {}, slots=2, max_len=32).stats["bucketed"] is \
        False


def test_init_draws_one_matrix_at_a_time():
    """A stacked leaf is drawn one matrix (its last two axes) at a time,
    so its f32 staging is one matrix: same shape, dtype, fan-in scale and
    determinism, and its matrices are the stream's draws in order."""
    spec = tlayers.ParamSpec((3, 4, 64, 32))
    a, b = (tlayers.init_from_schema({"w": spec}, torch.Generator()
                                     .manual_seed(0), "cpu")["w"]
            for _ in range(2))
    assert a.shape == (3, 4, 64, 32) and a.dtype == torch.bfloat16
    assert torch.equal(a, b)
    assert abs(float(a.float().std()) - 64 ** -0.5) < 0.01
    g = torch.Generator().manual_seed(0)
    first, second = (tlayers.init_from_schema(
        {"w": tlayers.ParamSpec((64, 32))}, g, "cpu")["w"] for _ in range(2))
    assert torch.equal(a[0, 0], first) and torch.equal(a[0, 1], second)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _prompts(vocab):
    """tests/test_serve_matrix.py::_parity's prompts."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (4, 9, 6, 17, 12)]


def _serve(engine, prompts, max_new=3, cls=Request):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _jax_margin(jm, jp, prompt, prefix):
    """Reference top-1 minus top-2 logit, and max |logit|, for the token
    after prompt + prefix (teacher-forced, exact length)."""
    seq = jnp.asarray(np.concatenate([prompt, prefix]).astype(np.int32))
    logits, _ = jm.forward(jp, {"tokens": seq[None]})
    last = np.asarray(logits[0, -1], np.float32)
    top2 = np.sort(last)[-2:]
    return float(top2[1] - top2[0]), float(np.abs(last).max())


@pytest.fixture(scope="module")
def bf16_models():
    cfg, tcfg = _cfgs()
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["einsum", "kernels"])
def test_serve_engines_match_jax_engines(bf16_models, use_pallas):
    """Port ServeEngine vs JAX ServeEngine and port ReferenceEngine vs JAX
    ReferenceEngine (slots 2, max_len 32, 3 new tokens): equal tokens, or
    a first difference after a near tie of the reference's logits."""
    cfg, tcfg, jp, tp = bf16_models
    jm = JaxModel(cfg, use_pallas=use_pallas)
    tm = Model(tcfg, use_pallas=use_pallas, device="cpu")
    prompts = _prompts(cfg.vocab)
    tol = TOLERANCES["token_margin"]
    pairs = [(JaxServeEngine(jm, jp, slots=2, max_len=32),
              ServeEngine(tm, tp, slots=2, max_len=32)),
             (JaxReferenceEngine(jm, jp, slots=2, max_len=32,
                                 jit_prefill=True),
              ReferenceEngine(tm, tp, slots=2, max_len=32))]
    for jeng, teng in pairs:
        ref = _serve(jeng, prompts, cls=JaxRequest)
        got = _serve(teng, prompts)
        for p, a, b in zip(prompts, got, ref):
            assert len(a) == len(b) == 3
            assert all(0 <= t < cfg.vocab for t in a)
            if a != b:
                j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                margin, top = _jax_margin(jm, jp, p, np.asarray(b[:j]))
                assert margin <= tol.atol * top, (p, a, b, margin, top)


def test_exact_length_prefill_one_sync_per_request(bf16_models):
    """Every request prefills alone at its own length; one host sync per
    prefill and per decode chunk; tokens equal those of the port's
    per-token ReferenceEngine on the same model and prompts."""
    _, tcfg, _, tp = bf16_models
    tm = Model(tcfg, use_pallas=True, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in (5, 9, 17, 12, 7)]
    eng = ServeEngine(tm, tp, slots=2, max_len=64, decode_chunk=8)
    assert eng.bucketed is False
    shapes = []
    real = tm.prefill
    tm.prefill = lambda params, batch, cache: (
        shapes.append(tuple(batch["tokens"].shape)),
        real(params, batch, cache))[1]
    before = HOST_SYNCS.count
    got = _serve(eng, prompts, max_new=5)
    st = eng.stats
    assert HOST_SYNCS.count - before == st["prefill_calls"] + st["chunks"]
    assert st["prefill_calls"] == len(prompts)
    assert shapes == [(1, len(p)) for p in prompts]
    assert st["decode_steps"] > st["chunks"]          # chunks fuse steps
    del tm.prefill
    ref = _serve(ReferenceEngine(tm, tp, slots=2, max_len=64), prompts,
                 max_new=5)
    assert got == ref


def test_exact_prefill_rejects_non_finite_first_token(bf16_models):
    """A prompt whose last logits are not finite is rejected at prefill
    and never takes its slot."""
    _, tcfg, _, tp = bf16_models
    tm = Model(tcfg, device="cpu")
    eng = ServeEngine(tm, tp, slots=2, max_len=32)
    real = tm.prefill
    tm.prefill = lambda *a: (lambda lc: (lc[0] * float("nan"), lc[1]))(
        real(*a))
    req = Request(rid=0, prompt=np.arange(5), max_new_tokens=3)
    eng.submit(req)
    eng.step()
    assert req.state == "rejected" and req.reason == "non-finite-logits"
    assert eng.active == [None, None]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_moe_layer_on_card_runs_the_grouped_kernel(cuda_device):
    """apply_moe(use_pallas=True) on CUDA tensors launches the grouped
    kernel three times and agrees with the same layer on the CPU (plain
    versions) within logits_bf16."""
    cfg, tcfg = _cfgs(group_size=16)
    _, tp = _moe_params(cfg, jnp.bfloat16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    ref = tmoe.apply_moe(tp, x, tcfg, use_pallas=True)
    tp_card = {k: v.to(cuda_device) for k, v in tp.items()}
    before = grouped_systolic_gemm_cuda.launches
    got = tmoe.apply_moe(tp_card, x.to(cuda_device), tcfg, use_pallas=True)
    torch.cuda.synchronize()
    assert grouped_systolic_gemm_cuda.launches - before == 3
    scale = float(ref.float().abs().max())
    _close(got.cpu(), ref.float().numpy(), TOLERANCES["logits_bf16"], scale)

