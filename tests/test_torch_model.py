"""The port's dense model against the JAX Model, on bridged parameters.

Both sides run `use_pallas=True` (JAX: the Pallas pod GEMM in interpret
mode; the port: its plain version, since the tensors lie on the CPU), for
one prefill plus 8 decode steps at reduced(granite-8b) size. Once in bf16
at TOLERANCES["logits_bf16"] (the tolerance of tests/test_serving.py), once
with every parameter cast to f32 at TOLERANCES["logits_f32"]; the einsum
backend (`use_pallas=False`) once in bf16. The layers
and attention functions are compared one by one as well; elementwise
functions in f32 at TOLERANCES["elementwise_f32"]. With depth cut to
2/8/36 layers of the same f32 weights, the port stays within the JAX
model's own exact-vs-padded drift; `python tests/test_torch_model.py`
prints those readings in f32 and bf16.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro.models.model import Model as JaxModel
from repro_torch import TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model

T = lambda a: params_from_jax(np.asarray(a))          # jax -> torch (exact)


def _close(got: torch.Tensor, ref, tol, scale=None):
    """|got - ref| <= atol' + rtol |ref|, with atol' = atol * scale when a
    scale (max |ref| of the logits) is given."""
    ref_t = torch.from_numpy(np.array(ref, np.float32))
    err = (got.float() - ref_t).abs()
    atol = tol.atol * (scale if scale is not None else 1.0)
    assert got.shape == ref_t.shape
    assert bool((err <= atol + tol.rtol * ref_t.abs()).all()), (
        f"max_abs_err {float(err.max())} ({tol})")


@pytest.mark.parametrize("dtype,use_pallas", [("bfloat16", True),
                                              ("float32", True),
                                              ("bfloat16", False)])
def test_model_logits_match_jax(dtype, use_pallas):
    cfg = reduced(get_arch("granite-8b"))
    jm = JaxModel(cfg, use_pallas=use_pallas)
    tm = Model(t_reduced(t_get_arch("granite-8b")), use_pallas=use_pallas,
               device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    jdt, tdt = jnp.bfloat16, torch.bfloat16
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jdt, tdt = jnp.float32, torch.float32
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tol = TOLERANCES["logits_bf16" if dtype == "bfloat16" else "logits_f32"]

    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 8))
    jit_prefill, jit_decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jl, jc = jit_prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jm.init_cache(2, 16, dtype=jdt))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(2, 16, dtype=tdt))
    scale = float(np.abs(np.asarray(jl, np.float32)).max())
    _close(tl, jl, tol, scale)
    tok = np.asarray(jl, np.float32).argmax(-1)
    for s in range(8):
        pos = np.array([8 + s, 8 + s])
        jl, jc = jit_decode(jp, jnp.asarray(tok, jnp.int32), jc,
                            jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        _close(tl, jl, tol, scale)
        tok = np.asarray(jl, np.float32).argmax(-1)     # same inputs both
    assert tc["layers"]["attn"].length.tolist() == [[16, 16], [16, 16]]


@functools.lru_cache(maxsize=None)
def _deep_params(dtype: str):
    cfg = dataclasses.replace(reduced(get_arch("granite-8b")), n_layers=36)
    jp = JaxModel(cfg, use_pallas=True).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), jp)


@functools.lru_cache(maxsize=None)
def padding_drift(depth: int, dtype: str = "float32") -> dict:
    """Last-position logits of one 37-token prompt through the first `depth`
    layers of the same reduced-width weights: the JAX model at the exact
    length and right-padded to its 64 bucket (the same function rounded
    otherwise), and the port at the exact length. rms of each difference."""
    jp = dict(_deep_params(dtype))
    jp["layers"] = jax.tree.map(lambda a: a[:depth], jp["layers"])
    cfg = dataclasses.replace(reduced(get_arch("granite-8b")), n_layers=depth)
    tcfg = dataclasses.replace(t_reduced(t_get_arch("granite-8b")),
                               n_layers=depth)
    jm = JaxModel(cfg, use_pallas=True)
    tm = Model(tcfg, use_pallas=True, device="cpu")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    n, bucket = 37, 64
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = np.random.default_rng(0).integers(0, cfg.vocab, n)
    exact, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :n])},
                                   jm.init_cache(1, bucket, dtype=jdt))
    padded, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)},
                                    cache=jm.init_cache(1, bucket, dtype=jdt))
    port, _ = tm.prefill(params_from_jax(jax.tree.map(np.asarray, jp)),
                         {"tokens": torch.from_numpy(toks[:, :n]).long()},
                         tm.init_cache(1, bucket, dtype=tdt))
    exact = np.asarray(exact[0], np.float32)
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    return {"depth": depth, "dtype": dtype, "logit_rms": rms(exact),
            "jax_padding_drift": rms(
                np.asarray(padded[0, n - 1], np.float32) - exact),
            "port_minus_jax": rms(port[0].float().numpy() - exact)}


@pytest.mark.parametrize("depth", [2, 8, 36])
def test_port_stays_within_the_references_own_drift(depth):
    """Random fan-in-scaled weights amplify a last-bit difference layer by
    layer, in the JAX model itself: its exact-vs-padded drift grows by
    orders of magnitude from 2 to 36 layers. At every depth the port is no
    further from the JAX model than about that drift (factor 4, plus
    TOLERANCES["logits_f32"] where the drift is near 0), so a fault of the
    port that appeared only with depth would fail here. It is why
    chip_smoke.py holds the engine/oracle margin rule at 2 layers."""
    r = padding_drift(depth)
    floor = TOLERANCES["logits_f32"].atol * r["logit_rms"]
    assert r["port_minus_jax"] <= 4 * r["jax_padding_drift"] + floor, r
    if depth == 36:
        assert r["jax_padding_drift"] > 100 * padding_drift(2)[
            "jax_padding_drift"], (r, padding_drift(2))


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    tol = TOLERANCES["elementwise_f32"]
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    _close(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w)), tol)
    b = rng.standard_normal(16).astype(np.float32)
    _close(tlayers.layernorm(*map(torch.from_numpy, (x, w, b))),
           jlayers.layernorm(*map(jnp.asarray, (x, w, b))), tol)
    # bf16: statistics in f32, cast to x's dtype before the scale
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _close(tlayers.rmsnorm(T(xb), T(wb)), jlayers.rmsnorm(xb, wb),
           TOLERANCES["elementwise_bf16"])
    for pos in (np.arange(5), np.array([[3], [40]])):   # prefill, per lane
        xs = x if pos.ndim == 1 else x[:, :1]
        _close(tlayers.apply_rope(torch.from_numpy(xs), torch.from_numpy(pos),
                                  10000.0),
               jlayers.apply_rope(jnp.asarray(xs), jnp.asarray(pos), 10000.0),
               tol)


def _qkv(rng, B, Sq, Skv, Hq, Hkv, D, dtype):
    q = rng.standard_normal((B, Sq, Hq, D))
    k = rng.standard_normal((B, Skv, Hkv, D))
    v = rng.standard_normal((B, Skv, Hkv, D))
    j = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return j, [T(a) for a in j]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_matches_jax(dtype):
    rng = np.random.default_rng(2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tol = TOLERANCES["attention_" + ("bf16" if dtype == "bfloat16" else "f32")]
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 2, 20, 20, 4, 2, 16, jdt)
    # several KV blocks and a short last one (the reference pads it)
    _close(tatt.chunked_attention(tq, tk, tv, kv_block=8),
           jatt.chunked_attention(jq, jk, jv, kv_block=8), tol)
    _close(tatt.chunked_attention(tq, tk, tv, window=6, kv_valid_len=17,
                                  kv_block=8),
           jatt.chunked_attention(jq, jk, jv, window=6, kv_valid_len=17,
                                  kv_block=8), tol)
    _close(tatt.naive_attention(tq, tk, tv),
           jatt.naive_attention(jq, jk, jv), tol)
    # decode: per-lane positions, invalid (-1) cache slots
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 2, 1, 12, 4, 2, 16, jdt)
    k_pos = np.where(np.arange(12)[None, :] < np.array([[7], [12]]),
                     np.arange(12)[None, :], -1)
    q_pos = np.array([6, 11])
    _close(tatt.decode_attention(tq, tk, tv, torch.from_numpy(k_pos),
                                 torch.from_numpy(q_pos)),
           jatt.decode_attention(jq, jk, jv, jnp.asarray(k_pos),
                                 jnp.asarray(q_pos)), tol)


def test_kv_cache_append_clamps_like_dynamic_update_slice():
    """A start index past the end lands on the last slot, as in JAX; torch
    indexing alone would raise (CPU) or write out of bounds (CUDA)."""
    rng = np.random.default_rng(3)
    jc = jatt.KVCache.zeros(3, 6, 2, 4, dtype=jnp.float32)
    tc = tatt.KVCache.zeros(3, 6, 2, 4, dtype=torch.float32)
    lengths = np.array([2, 6, 9])                     # in range, full, past
    jc = jatt.KVCache(jc.k, jc.v, jnp.asarray(lengths, jnp.int32))
    tc.length.copy_(torch.from_numpy(lengths))
    for s in (1, 2):
        new = rng.standard_normal((3, s, 2, 4)).astype(np.float32)
        jc = jc.append(jnp.asarray(new), jnp.asarray(-new))
        tc.append(torch.from_numpy(new), torch.from_numpy(-new))
        assert np.array_equal(tc.k.numpy(), np.asarray(jc.k))
        assert np.array_equal(tc.v.numpy(), np.asarray(jc.v))
        assert tc.length.tolist() == np.asarray(jc.length).tolist()


if __name__ == "__main__":
    # the depth readings behind test_port_stays_within_the_references_own_drift
    for dt in ("float32", "bfloat16"):
        for d in (2, 8, 36):
            print(json.dumps(padding_drift(d, dt)))
