"""Cells at a size a CPU test run holds: the configurations' files with
every size cut (two layers, d_model 64, four query heads over two K/V
heads of 16, vocabulary 256; dbrx's 4 experts, top 2, dropless), a mix
of short requests on 4 slots whose check draws its sample as the cells'
mixes do (per lane, each request cut to its first `positions` tokens),
and the limit that the CPU readings set."""

from __future__ import annotations

import copy
import time

from servebench import spec

# CPU readings at this size (bf16 program, plain kernels, one-second
# windows on the VirtualClock below; the sample as the cells draw it, the
# longest request and one of each of the 4 lanes, ~330 served tokens;
# seeds 5, 77, 2**31 + 77, 11, 12, 13). granite: the program's widest gap
# 0.0071-0.0359, the float8 control's 0.1717-0.2527. dbrx: the widest gap
# does not separate here either (program up to 0.6840 on routing near
# ties, control from 0.1816), so the cell compares the mean gap: program
# 0.00003-0.00251 (0.00251 is seed 77's one routing flip of 0.684),
# control 0.00488-0.01013. Each limit lies between its two readings, as
# the cells' limits do at full size.
TEST_LIMITS = {"granite-8b": {"max_logit_gap": {"limit": 0.1}},
               "dbrx-132b": {"mean_logit_gap": {"limit": 0.003}}}


def small_config(name: str) -> dict:
    cfg = copy.deepcopy(spec.load_json(spec.HERE / "configs"
                                       / f"{name}.json"))
    cfg.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
               head_dim=16, d_ff=128, vocab=256)
    if cfg.get("moe"):
        cfg["moe"] = dict(num_experts=4, top_k=2, d_ff_expert=32,
                          capacity_factor=2.0)
    return cfg


def small_mix(rate: float = 20.0) -> dict:
    mix = copy.deepcopy(spec.load_json(spec.HERE / "traffic" / "chat.json"))
    mix.update(serving=dict(slots=4, max_len=128, decode_chunk=8),
               ramp_s=0.3,
               prompt=dict(dist="loguniform", min=8, max=40),
               output=dict(dist="uniform", min=60, max=80),
               arrival=dict(kind="poisson", rate_per_s=rate, initial=4),
               check=dict(positions=64))
    return mix


def small_cell(name: str = "granite-8b", trace_metrics=()) -> spec.Cell:
    bench = spec.benchmark()
    return spec.Cell(
        name=f"{name}.test", config=small_config(name), mix=small_mix(),
        limits=TEST_LIMITS[name], chips=1,
        end_to_end=[m for m in bench["end_to_end"]],
        per_layer=[m for m in bench["per_layer"]
                   if m["name"] in trace_metrics])


class VirtualClock:
    """A host clock that moves 1 ms at each read and by the asked time at
    each sleep, so that a run's schedule, window and finished requests do
    not depend on how busy the CPU is."""

    def __init__(self):
        self.t = time.perf_counter()

    def perf_counter(self) -> float:
        self.t += 1e-3
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += max(0.0, seconds)


def use_virtual_clock(patch) -> VirtualClock:
    """Put a VirtualClock in place of time.perf_counter and time.sleep;
    `patch(obj, name, value)` is pytest's monkeypatch.setattr."""
    clock = VirtualClock()
    patch(time, "perf_counter", clock.perf_counter)
    patch(time, "sleep", clock.sleep)
    return clock
