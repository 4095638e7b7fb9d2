"""The trace sums behind idle_share and the rooflines, the percentile over
all requests, and the generator's stratified traffic."""

from __future__ import annotations

import json

import numpy as np
import pytest

from servebench import readers, spec, trace, traffic
from servebench.run import percentile


def test_union_counts_overlap_once():
    assert trace.union([(5, 6), (0, 2), (1, 3), (5.5, 5.7)]) == \
        [(0, 3), (5, 6)]
    ops = [trace.Op("a", 0, 2, "kernel"), trace.Op("b", 1, 2, "kernel"),
           trace.Op("c", 10, 1, "gpu_memcpy")]
    assert trace.busy_us(ops) == 4.0
    assert trace.idle_gaps(ops) == [(3.0, 10.0)]


def test_gap_named_by_innermost_host_event():
    host = [trace.Op("servebench.step", 0, 100, "user_annotation"),
            trace.Op("cudaGraphLaunch", 40, 10, "cuda_runtime"),
            trace.Op("aten::copy_", 60, 5, "cpu_op")]
    assert trace.host_at(host, [45, 200, 70, 62]) == [
        "cudaGraphLaunch", "(no host event)", "servebench.step",
        "aten::copy_"]


def test_breakdown_from_a_chrome_trace(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 30,
           "name": "void (anonymous namespace)::gemm_bf16_splitk<1, 128, "
                   "false, __nv_bfloat16>(__nv_bfloat16 const*)",
           "args": {"grid": [96, 1, 1]}},
          {"ph": "X", "cat": "kernel", "ts": 50, "dur": 10,
           "name": "void (anonymous namespace)::gemm_bf16_wmma<16, false, "
                   "__nv_bfloat16>(int)", "args": {"grid": [84, 1, 16]}},
          {"ph": "X", "cat": "cpu_op", "ts": 35, "dur": 10,
           "name": "aten::argmax"}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    dev, host = trace.read(p)
    assert [readers.kernel_family(o) for o in dev] == ["pod_nn", "grouped"]
    b = trace.breakdown(dev, host)
    assert b["device_ops"][0] == ["gemm_bf16_splitk<1, 128, false, "
                                  "__nv_bfloat16>", 30e-6]
    assert b["idle_gaps"] == [["aten::argmax", 20e-6]]


@pytest.mark.parametrize("name,family", [
    ("gemm_bf16_splitk<1, 64, true, float>", "pod_nt"),
    ("gemm_bf16_wgmma<0, __nv_bfloat16>", "pod_nn"),
    ("gemm_bf16_wgmma<1, __nv_bfloat16>", "pod_nt"),
    ("gemm_bf16_wgmma<2, __nv_bfloat16>", "grouped"),
    ("flash_fwd_bf16_wgmma<128>", "flash"),
    ("vectorized_elementwise_kernel<4>", None)])
def test_kernel_family(name, family):
    assert readers.kernel_family(trace.Op(name, 0, 1, "kernel",
                                          (1, 1, 1))) == family


def test_percentile_over_all_requests():
    v = list(range(1, 101))
    assert percentile(v, 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
    assert percentile(v, 50) == float(np.median(v))


def test_evenly_mixed_has_no_bunches():
    rng = np.random.default_rng(3)
    for step in traffic.STEPS.values():
        u = traffic.evenly_mixed(500, step, rng)
        for i in range(0, 468, 17):
            w = np.sort(np.concatenate([[0.0], u[i:i + 32], [1.0]]))
            assert np.diff(w).max() < 3.0 / 32


@pytest.mark.parametrize("mix", ["reasoning", "chat"])
def test_every_seed_gets_the_same_mix(mix):
    m = spec.load_json(spec.HERE / "traffic" / f"{mix}.json")
    n0 = m["arrival"]["initial"]
    runs = [traffic.plan(m, s, 1000, 30) for s in (7, 2**31 + 99)]
    assert [len(p.prompt) for p in runs[0]] != \
        [len(p.prompt) for p in runs[1]]
    whole = traffic.quantile(m["prompt"], (np.arange(4096) + 0.5) / 4096)
    for r in runs:
        lens = np.array([len(p.prompt) for p in r[n0:]])
        for i in range(0, len(lens) - 32, 32):
            assert abs(lens[i:i + 32].mean() / whole.mean() - 1) < 0.15
        lo, hi = m["prompt"]["min"], m["prompt"]["max"]
        assert all(lo <= len(p.prompt) <= hi for p in r)
        assert all(1 <= p.max_new <= m["output"]["max"] for p in r)
        gaps = np.diff([p.due_s for p in r[n0:]])
        assert abs(gaps.mean() * m["arrival"]["rate_per_s"] - 1) < 0.1


def test_initial_requests_finish_alike_on_every_seed():
    m = spec.load_json(spec.HERE / "traffic" / "reasoning.json")
    n0 = m["arrival"]["initial"]
    a, b = (traffic.plan(m, s, 1000, 30)[:n0] for s in (7, 2**31 + 99))
    assert sorted(p.max_new for p in a) == sorted(p.max_new for p in b)
    assert [p.max_new for p in a] != [p.max_new for p in b]
    # uniform lengths over [1024, 2048]: residual mean (E[L^2] / 2E[L])
    want = (1024**2 + 1024 * 2048 + 2048**2) / 3 / (2 * 1536)
    assert np.mean([p.max_new for p in a]) == pytest.approx(want, rel=0.05)
    assert min(p.max_new for p in a) >= 1


def test_warmup_meets_every_bucket():
    m = spec.load_json(spec.HERE / "traffic" / "chat.json")
    got = traffic.warmup_prompt_lengths(m)
    bucket = lambda P: 1 << (max(8, P) - 1).bit_length()
    assert {bucket(P) for P in got} == \
        {bucket(P) for P in range(m["prompt"]["min"],
                                  m["prompt"]["max"] + 1)}
