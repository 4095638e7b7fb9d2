"""The port's paged KV cache and paged ServeEngine against the JAX
package's (serve/paging.py, models/attention.PagedKVCache,
ServeEngine(paged=True)), with flash-attention prefill
(`Model(attention_impl="pallas", use_pallas=True)`) at reduced(granite-8b).

The checks of tests/test_paged.py, on the port: the allocator's unit
invariants; tokens equal to the port's per-token ReferenceEngine with the
pool drained and lanes recycled inside chunks; mapped KV bytes within 1.25x
of live tokens; `pages-exhausted` at submit; an oversubscribed pool that
queues on pages and still completes. Then the port against the JAX paged
engine under the margin rule of tests/test_torch_serve.py, one counted host
sync per prefill group and decode chunk with paging on, and that no lane
reads or writes outside its pages: every page no lane owns, and the scratch
page, hold NaN, and the tokens stay finite and equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import attention as jatt
from repro.models.model import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import HOST_SYNCS, TOLERANCES
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import attention as tatt
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paging import PageLeak, PagePool
from repro_torch.serve.reference import ReferenceEngine


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_arch("granite-8b"))
    jm = JaxModel(cfg, attention_impl="pallas", use_pallas=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(t_reduced(t_get_arch("granite-8b")), attention_impl="pallas",
               use_pallas=True, device="cpu")
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _prompt(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n, dtype=np.int32)


def _matrix_prompts(vocab):
    """The prompts of tests/test_serve_matrix.py."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (4, 9, 6, 17, 12)]


def _serve(engine, prompts, max_new, cls=Request, before_step=None):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    for _ in range(300):
        if not engine.queue and not any(engine.active):
            break
        if before_step is not None:
            before_step(engine)
        engine.step()
    assert all(r.state == "done" for r in reqs), [r.state for r in reqs]
    return [list(r.out) for r in reqs]


# --------------------------------------------------------------------------
# allocator unit invariants (tests/test_paged.py)
# --------------------------------------------------------------------------

def test_pool_reserve_map_release_roundtrip():
    pool = PagePool(n_pages=8, page_size=8, slots=2, max_len=32,
                    chunk_slack=4)
    assert pool.worst_pages(9, 7) == 3          # 9+7+4=20 -> 3 pages
    assert pool.worst_pages(30, 50) == 4        # clamped to max_len=32
    pool.reserve(0, 3)
    assert pool.map_to(0, 9) is True            # 2 pages mapped
    assert pool.pages_in_use == 2
    assert pool.map_to(0, 9) is False           # idempotent
    pool.map_to(0, 999)                         # clamps to the reservation
    assert len(pool.owned(0)) == 3
    pool.check()
    with pytest.raises(PageLeak):
        pool.reserve(0, 1)                      # double-reserve
    table = pool.table()
    assert table.shape == (2, 4)
    assert set(table[0, :3]) == set(pool.owned(0))
    assert (table[1] == pool.sentinel).all()
    pool.release(0)
    pool.assert_drained()


def test_pool_overflow_is_loud():
    pool = PagePool(n_pages=4, page_size=8, slots=4, max_len=32)
    pool.reserve(0, 3)
    assert not pool.can_reserve(2)
    with pytest.raises(PageLeak):
        pool.reserve(1, 2)


# --------------------------------------------------------------------------
# the cache against the JAX PagedKVCache
# --------------------------------------------------------------------------

def test_paged_cache_matches_jax():
    """scatter_prefill, then decode appends (one lane past its mapped
    pages, whose write JAX drops and the port routes to scratch), then
    flat_view: the same positions and, where a position is valid, the same
    keys and values; nothing but the scratch page takes the dropped write,
    and the lengths agree."""
    rng = np.random.default_rng(4)
    B, S, H, D, ps, n_pages = 3, 16, 2, 4, 4, 6
    j = jatt.PagedKVCache.zeros(B, S, H, D, n_pages=n_pages, page_size=ps,
                                dtype=jnp.float32)
    t = tatt.PagedKVCache.zeros(B, S, H, D, n_pages=n_pages, page_size=ps,
                                dtype=torch.float32)
    table = np.full((B, S // ps), n_pages, np.int32)
    table[0, :2] = [4, 1]                       # lane 0: 2 pages
    table[2, :3] = [0, 5, 2]                    # lane 2: 3 pages; 1: none
    j = jatt.PagedKVCache(j.k, j.v, jnp.asarray(table), j.length)
    t.page_table.copy_(torch.from_numpy(table))
    lk = rng.standard_normal((B, S, H, D)).astype(np.float32)
    lv = rng.standard_normal((B, S, H, D)).astype(np.float32)
    dest = table.copy()
    dest[1] = n_pages                           # pad lane: nothing maps
    slot_ids = np.array([0, -1, 2], np.int32)
    true_lens = np.array([7, 1, 9], np.int32)
    j = j.scatter_prefill(jatt.KVCache(jnp.asarray(lk), jnp.asarray(lv),
                                       None), jnp.asarray(dest),
                          jnp.asarray(slot_ids), jnp.asarray(true_lens))
    t.scatter_prefill(tatt.KVCache(torch.from_numpy(lk),
                                   torch.from_numpy(lv), None),
                      torch.from_numpy(dest.astype(np.int64)),
                      torch.from_numpy(slot_ids.astype(np.int64)),
                      torch.from_numpy(true_lens.astype(np.int64)))
    assert t.length.tolist() == np.asarray(j.length).tolist() == [7, 0, 9]
    for _ in range(3):                          # lane 0 runs past 8 tokens
        kn = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        j = j.append(jnp.asarray(kn), jnp.asarray(-kn))
        t.append(torch.from_numpy(kn), torch.from_numpy(-kn))
    assert t.length.tolist() == np.asarray(j.length).tolist() == [10, 3, 12]
    assert torch.equal(t.k[:n_pages], torch.from_numpy(np.array(j.k)))
    assert torch.equal(t.v[:n_pages], torch.from_numpy(np.array(j.v)))
    jk, jv, jpos = (np.asarray(a) for a in j.flat_view())
    tk, tv, tpos = t.flat_view()
    assert np.array_equal(tpos.numpy(), jpos)
    valid = jpos >= 0
    assert np.array_equal(tk.numpy()[valid], jk[valid])
    assert np.array_equal(tv.numpy()[valid], jv[valid])
    assert not tk.numpy()[~valid].any() and not tv.numpy()[~valid].any()


def test_paged_init_cache_checks_and_prefill_raises(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="together"):
        tm.init_cache(2, 32, page_size=8)
    with pytest.raises(ValueError, match="multiple"):
        tm.init_cache(2, 30, page_size=8, kv_pages=8)
    cache = tm.init_cache(2, 32, page_size=8, kv_pages=8)
    pc = cache["layers"]["attn"]
    assert pc.n_pages == 8 and pc.k.shape[1] == 9      # + the scratch page
    with pytest.raises(TypeError, match="scatter_prefill"):
        tm.prefill(tp, {"tokens": torch.zeros((2, 5), dtype=torch.long)},
                   cache)


# --------------------------------------------------------------------------
# the paged engine
# --------------------------------------------------------------------------

def test_paged_engine_equals_port_reference_and_drains(models):
    _, _, tm, tp = models
    prompts = _matrix_prompts(tm.cfg.vocab)
    ref = _serve(ReferenceEngine(tm, tp, slots=2, max_len=32), prompts, 8)
    eng = ServeEngine(tm, tp, slots=2, max_len=32, decode_chunk=4,
                      paged=True, page_size=8)
    assert _serve(eng, prompts, 8) == ref
    eng._pool.assert_drained()
    # two slots served five requests: lanes were handed over at chunk syncs
    assert eng.recycled >= 1


def test_paged_kv_bytes_scale_with_live_context(models):
    """Mapped KV bytes <= 1.25x live tokens x per-token bytes at every
    quantum with live lanes, and far under the dense reservation."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, slots=4, max_len=128, decode_chunk=4,
                      paged=True, page_size=8)
    reqs = [Request(rid=i, prompt=_prompt(tm.cfg.vocab, n, i),
                    max_new_tokens=16)
            for i, n in enumerate((41, 44, 47, 43))]
    for r in reqs:
        eng.submit(r)
    checked = 0
    for _ in range(200):
        if not eng.queue and not any(eng.active):
            break
        eng.step()
        s = eng.paged_kv_stats()
        assert s["total_pages"] == 4 * 128 // 8          # not + scratch
        if s["live_tokens"]:
            assert s["mapped_bytes"] <= \
                1.25 * s["live_tokens"] * s["kv_bytes_per_token"], s
            assert s["mapped_bytes"] < 0.6 * s["dense_bytes"], s
            checked += 1
    assert checked >= 3, "never observed a live steady state"
    assert all(r.state == "done" for r in reqs)
    eng._pool.assert_drained()


def test_paged_prefill_transient_spans_the_bucket_only(models, monkeypatch):
    """The paged prefill's dense transient cache covers the bucket's whole
    pages, not max_len: buckets 8 and 32 at max_len 64 and page_size 16
    make [slots, 16] and [slots, 32] transients. The tokens equal the dense
    engine's, whose transient spans max_len."""
    _, _, tm, tp = models
    prompts = [_prompt(tm.cfg.vocab, n, i) for i, n in enumerate((5, 17))]
    dense = _serve(ServeEngine(tm, tp, slots=1, max_len=64, decode_chunk=4),
                   prompts, 4)
    sizes = []
    init_cache = tm.init_cache

    def recording(batch, max_len, **kw):
        sizes.append((batch, max_len, "page_size" in kw))
        return init_cache(batch, max_len, **kw)
    monkeypatch.setattr(tm, "init_cache", recording)
    eng = ServeEngine(tm, tp, slots=1, max_len=64, decode_chunk=4,
                      paged=True, page_size=16)
    assert _serve(eng, prompts, 4) == dense
    assert sizes == [(1, 64, True), (1, 16, False), (1, 32, False)]
    eng._pool.assert_drained()


def test_request_larger_than_pool_rejected_at_submit(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, slots=2, max_len=64, decode_chunk=4,
                      paged=True, page_size=8, kv_pages=4)
    big = Request(rid=1, prompt=_prompt(tm.cfg.vocab, 40), max_new_tokens=4)
    eng.submit(big)
    assert big.state == "rejected" and big.reason == "pages-exhausted"
    hungry = Request(rid=2, prompt=_prompt(tm.cfg.vocab, 8),
                     max_new_tokens=40)
    eng.submit(hungry)
    assert hungry.state == "rejected" and hungry.reason == "pages-exhausted"
    ok = Request(rid=3, prompt=_prompt(tm.cfg.vocab, 8), max_new_tokens=4)
    eng.submit(ok)
    assert not eng.queue or eng.queue == [ok]
    eng.run_to_completion(max_steps=200)
    assert ok.state == "done"
    eng._pool.assert_drained()


def test_paged_admission_queues_on_pages_not_slots(models):
    """An oversubscribed pool: the page reservation, not the slot count,
    caps concurrency; blocked requests wait queued and all complete."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, slots=6, max_len=64, decode_chunk=4,
                      paged=True, page_size=8, kv_pages=16)
    # worst case per request: ceil((20 + 3 + 4) / 8) = 4 pages -> only 4
    # of the 6 lanes can hold a reservation at once
    reqs = [Request(rid=i, prompt=_prompt(tm.cfg.vocab, 20, i),
                    max_new_tokens=4) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    max_live = 0
    for _ in range(200):
        if not eng.queue and not any(eng.active):
            break
        eng.step()
        eng._pool.check()
        assert eng._pool.reserved_pages <= eng._pool.n_pages
        max_live = max(max_live, sum(r is not None for r in eng.active))
    assert all(r.state == "done" for r in reqs)
    assert max_live <= 4, "pages should cap concurrency below slot count"
    eng._pool.assert_drained()


def test_paged_engine_matches_jax_paged_engine(models):
    """The JAX ServeEngine(paged=True) with flash prefill (Pallas in
    interpret mode) on the serve-matrix prompts: tokens agree, or differ
    only after a near tie of the reference (TOLERANCES["token_margin"])."""
    jm, jp, tm, tp = models
    prompts = _matrix_prompts(tm.cfg.vocab)
    ref = _serve(JaxServeEngine(jm, jp, slots=2, max_len=32, decode_chunk=4,
                                paged=True, page_size=8), prompts, 3,
                 cls=JaxRequest)
    got = _serve(ServeEngine(tm, tp, slots=2, max_len=32, decode_chunk=4,
                             paged=True, page_size=8), prompts, 3)
    tol = TOLERANCES["token_margin"]
    for p, a, b in zip(prompts, got, ref):
        assert len(a) == len(b) == 3
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = jnp.asarray(np.concatenate([p, np.asarray(b[:j], np.int32)]))
            logits, _ = jm.forward(jp, {"tokens": seq[None]})
            last = np.asarray(logits[0, -1], np.float32)
            top2 = np.sort(last)[-2:]
            assert top2[1] - top2[0] <= tol.atol * np.abs(last).max(), \
                (p, a, b)


def test_one_host_sync_per_prefill_group_and_chunk_paged(models):
    _, _, tm, tp = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 9, 17, 12, 33, 7)]
    eng = ServeEngine(tm, tp, slots=2, max_len=64, decode_chunk=8,
                      paged=True, page_size=8)
    before = HOST_SYNCS.count
    out = _serve(eng, prompts, 5)
    syncs = HOST_SYNCS.count - before
    st = eng.stats
    assert syncs == st["prefill_calls"] + st["chunks"]
    assert eng.recycled >= 1                  # recycling added no sync
    assert syncs < sum(len(o) for o in out)
    eng._pool.assert_drained()


def test_no_lane_reads_or_writes_outside_its_pages(models):
    """Before every quantum, every page that no lane owns and the scratch
    page are filled with NaN. A lane that read any of them (a stale table
    entry, a position past its length) would turn NaN; a lane that wrote
    into a page it does not own would corrupt another's keys. The tokens
    stay finite (every request done) and equal to an unpoisoned run."""
    _, _, tm, tp = models
    prompts = _matrix_prompts(tm.cfg.vocab) + [_prompt(tm.cfg.vocab, 23, 9)]

    def engine():
        return ServeEngine(tm, tp, slots=2, max_len=32, decode_chunk=4,
                           paged=True, page_size=8, kv_pages=7)
    clean = _serve(engine(), prompts, 6)
    poisoned_pages = []

    def poison(eng):
        pool = eng._pool
        owned = {p for s in range(eng.slots) for p in pool.owned(s)}
        free = [p for p in range(pool.n_pages) if p not in owned]
        pc = eng.cache["layers"]["attn"]
        for p in free + [pool.n_pages]:
            pc.k[:, p] = float("nan")
            pc.v[:, p] = float("nan")
        poisoned_pages.append(len(free))
    eng = engine()
    assert _serve(eng, prompts, 6, before_step=poison) == clean
    assert max(poisoned_pages) > 0 and eng.recycled >= 1
    eng._pool.assert_drained()


def test_paged_off_has_no_pool_and_no_recycle(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, slots=2, max_len=32)
    assert eng._pool is None and eng.recycle is False
    assert isinstance(eng.cache["layers"]["attn"], tatt.KVCache)
    with pytest.raises(ValueError):
        eng.paged_kv_stats()
