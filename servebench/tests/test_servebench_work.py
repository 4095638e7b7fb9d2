"""The yardstick's operation and byte counts against hand counts at the
two configurations' shapes."""

from __future__ import annotations

import pytest

from servebench import spec, work

GRANITE = spec.load_json(spec.HERE / "configs" / "granite-8b.json")
DBRX = spec.load_json(spec.HERE / "configs" / "dbrx-132b.json")

# granite-8b, one layer: q and o 4096 x 4096, k and v 4096 x 1024, up,
# gate and down 4096 x 14336; the head 4096 x 49152
G_LAYER = 2 * 16_777_216 + 2 * 4_194_304 + 3 * 58_720_256
G_HEAD = 201_326_592
G_IO = 8192 + 5120 + 5120 + 8192 + 3 * 18432      # sum of K + N a layer
# dbrx-132b: q and o 6144 x 6144, k and v 6144 x 1024; an expert's up,
# gate and down 6144 x 10752; the head 6144 x 100352
D_LAYER = 2 * 37_748_736 + 2 * 6_291_456
D_HEAD = 616_562_688
D_EXPERT = 3 * 66_060_288


def test_granite_parameters():
    assert G_LAYER == 218_103_808
    assert sum(K * N for K, N in work.pod_gemms(GRANITE)) == G_LAYER
    total = 36 * G_LAYER + G_HEAD + 49152 * 4096 + 73 * 4096
    assert total == pytest.approx(8.25e9, rel=0.01)   # the issue's 8.25 B


def test_granite_decode_step_at_16_lanes():
    w = work.pod(GRANITE, [], [16])
    assert w.flops == 2 * 16 * (36 * G_LAYER + G_HEAD)
    assert w.bytes == 2 * (36 * (G_LAYER + 16 * G_IO)
                           + G_HEAD + 16 * (4096 + 49152))
    assert w.bytes == 16_202_203_136
    assert w.least_s == pytest.approx(w.bytes / 3.35e12)   # bytes bound
    assert w.least_s * 1e3 == pytest.approx(4.8365, abs=1e-3)


def test_granite_prefill_call_counts_true_rows_and_one_head_row_each():
    w = work.pod(GRANITE, [[300, 200]], [])
    M = 500
    assert w.flops == 2 * (36 * M * G_LAYER + 2 * G_HEAD)
    f = work.flash(GRANITE, [[300, 200]])
    pairs = 300 * 301 / 2 + 200 * 201 / 2
    assert f.flops == 36 * 4 * 32 * 128 * pairs
    assert f.bytes == 36 * 2 * 500 * 128 * (2 * 32 + 2 * 8)


def test_dbrx_decode_step_at_16_lanes():
    w = work.pod(DBRX, [], [16])
    assert w.flops == 2 * 16 * (8 * D_LAYER + D_HEAD)
    g = work.grouped(DBRX, [], [16])
    hit = 16 * (1 - 0.75 ** 16)
    assert g.flops == pytest.approx(8 * 2 * 64 * D_EXPERT)
    io = 64 * 3 * (6144 + 10752)
    assert g.bytes == pytest.approx(8 * 2 * (hit * D_EXPERT + io))
    # all 16 experts' weights at 8 layers: 50.7 GB, 15.1 ms at 3.35 TB/s
    assert 8 * 2 * 16 * D_EXPERT == pytest.approx(50.7e9, rel=0.01)


def test_experts_reached():
    assert work.experts_reached(DBRX, 1) == pytest.approx(4.0)
    assert work.experts_reached(DBRX, 10_000) == pytest.approx(16.0)


def test_model_flops_by_hand():
    lin = 2 * 36 * G_LAYER
    att = 4 * 32 * 128 * 36
    assert work.model_flops(GRANITE, [3], 0, 0) == \
        lin * 3 + att * 6 + 2 * 4096 * 49152
    assert work.model_flops(GRANITE, [], 10 + 11, 2) == \
        lin * 2 + att * 21 + 2 * 2 * 4096 * 49152
    per_tok = 2 * 8 * (D_LAYER + 6144 * 16 + 4 * D_EXPERT) + 2 * D_HEAD
    assert work.model_flops(DBRX, [], 0, 1) == per_tok
