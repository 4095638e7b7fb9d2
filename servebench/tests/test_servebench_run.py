"""The harness end to end on the CPU at a reduced size (the look for a
card skipped): a sound run is correct; the float8 control and each fault
the cells can have, planted in the program's timed path, come out not
correct; the import check; the refusal without a card."""

from __future__ import annotations

import sys
import types

import pytest
import torch

import repro_torch.serve.engine as engine_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from servebench import check as C, load as ld, run as R

from ._cells import small_cell, use_virtual_clock

SEEDS = [5, 2**31 + 77]


@pytest.fixture(autouse=True)
def _virtual_clock(monkeypatch):
    use_virtual_clock(monkeypatch.setattr)


def _run(cell, seed, **kw):
    import time
    return R.run(cell, seed=seed, seconds=1.0, trace=kw.pop("trace", False),
                 device="cpu", t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", ["granite-8b", "dbrx-132b"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(name, seed):
    cell = small_cell(name)
    res = _run(cell, seed)
    assert res["correct"], res["checked"]
    assert list(res)[-1] == "checked"
    assert all(res["checked"][k]["value"] <= v["limit"]
               for k, v in cell.limits.items())
    assert res["attempted"] > 4 and res["failed"] == 0
    lanes = res["checked"]["sampled_lanes"]
    assert lanes["value"] == lanes["limit"] >= 2
    m = res["metrics"]
    assert m["output_tokens_per_s"]["value"] > 0
    assert m["setup_s"]["unit"] == "s" and m["ttft_p95_ms"]["value"] > 0


@pytest.mark.parametrize("name", ["granite-8b", "dbrx-132b"])
@pytest.mark.parametrize("seed", SEEDS)
def test_float8_control_is_not_correct(name, seed):
    res = _run(small_cell(name), seed, control=True)
    assert not res["correct"]
    assert any(res["checked"][k]["value"] > v["limit"]
               for k, v in small_cell(name).limits.items())


def _served(lane, n, state="done"):
    req = types.SimpleNamespace(out=list(range(n)), state=state)
    return ld.Served(plan=None, req=req, due=0.0, lane=lane)


def test_sample_takes_the_longest_and_a_request_of_each_busy_lane():
    served = [_served(0, 40), _served(0, 90), _served(1, 30),
              _served(1, 12), _served(2, 20, "running"), _served(None, 50),
              _served(3, 10)]
    picked = C.sample(served, {"check": {"positions": 16}}, 7)
    assert picked[0] == (served[1], 90)
    assert sorted(s.lane for s, _ in picked[1:]) == [0, 1, 3]
    assert picked[1] == (served[0], 16)
    assert all(k == min(16, len(s.req.out)) for s, k in picked[1:])
    assert C.lanes_seen(served) == {0, 1, 2, 3}
    assert not C.settled(served)          # lane 2 has finished nothing
    assert C.settled([s for s in served if s.lane != 2])


def _token_altered(monkeypatch):
    orig = engine_mod._decode_body

    def altered(*args, **kw):
        out = orig(*args, **kw).clone()
        slots = kw["toks"].shape[0]              # the runner's buffers
        out[:slots] = (out[:slots] + 1) % args[0].cfg.vocab
        return out
    monkeypatch.setattr(engine_mod, "_decode_body", altered)


def _state_unchanged(monkeypatch):
    orig = KVCache.append

    def append(self, k_new, v_new):
        if k_new.shape[1] != 1:                  # decode leaves the cache
            orig(self, k_new, v_new)
    monkeypatch.setattr(KVCache, "append", append)


def _half_batch(monkeypatch):
    orig = Model.decode_step

    def decode_step(self, params, tokens, cache, position):
        logits, cache = orig(self, params, tokens, cache, position)
        B = logits.shape[0]
        logits = torch.cat([logits[:B // 2], logits[:B - B // 2]])
        return logits, cache
    monkeypatch.setattr(Model, "decode_step", decode_step)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch])
@pytest.mark.parametrize("name", ["granite-8b", "dbrx-132b"])
def test_planted_fault_is_not_correct(fault, name, monkeypatch):
    fault(monkeypatch)
    res = _run(small_cell(name), SEEDS[0])
    assert not res["correct"], res["checked"]


def test_trace_run_reports_its_span_metrics():
    names = ("prefill_share.decode", "decode_step_ms.decode",
             "prefill_lane_efficiency.chat")
    res = _run(small_cell("granite-8b", names), SEEDS[1], trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == set(names)
    for v in res["metrics"].values():
        assert v["value"] > 0
    assert res["metrics"]["prefill_lane_efficiency.chat"]["value"] <= 100


def test_import_check(monkeypatch):
    _run(small_cell(), SEEDS[0])
    assert R.forbidden_modules() == []
    assert "repro_torch" in sys.modules
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "repro.serve",
                        types.ModuleType("repro.serve"))
    assert R.forbidden_modules() == ["jax", "repro.serve"]


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", "granite-8b.chat", "--seed", "1",
                   "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
