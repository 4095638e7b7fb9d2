"""The cells, configurations, mixes, limits and metric readers resolve by
name, and BENCHMARK.json keeps the contract's shape."""

from __future__ import annotations

import dataclasses
import re

import pytest

from servebench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(w):
    cell = spec.cell(w)
    assert cell.config["name"] == next(
        x["config"] for x in BENCH["workloads"] if x["name"] == w)
    assert cell.limits and set(cell.limits) <= {"max_logit_gap",
                                                "mean_logit_gap"}
    for lim in cell.limits.values():
        assert lim["lower"] < lim["limit"] < lim["upper"]
        assert lim["upper"] >= 3 * lim["lower"]
    assert {"setup_s"} <= {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    e2e = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e, (w, m["name"])


def test_names_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_the_program(c):
    """Each file holds the program's ArchConfig of its model, which is what
    the program runs, but for the keys it lists in `reduced` and the
    capacity it states; where that departs from the published source, the
    file says so under `assumed` and `differs_from_source`."""
    from repro_torch.configs import get_arch
    from servebench.run import arch_config
    cfg = spec.load_json(spec.ROOT / c["file"])
    mine = dataclasses.asdict(arch_config(cfg))
    ref = dataclasses.asdict(get_arch(c["name"]))
    if ref["head_dim"] is None:
        ref["head_dim"] = cfg["d_model"] // cfg["n_heads"]
    if ref["moe"]:
        ref["moe"]["capacity_factor"] = mine["moe"]["capacity_factor"]
    for key in c["reduced"]:
        assert mine[key] != ref[key]
        assert cfg["published"][key] == ref[key]
        ref[key] = mine[key]
    assert mine == ref
    assert set(c["reduced"]) <= set(cfg)
    assert "norm_eps" in cfg["assumed"]
    assert cfg["differs_from_source"]


def test_traffic_mixes_fit_their_engine():
    for w in BENCH["workloads"]:
        mix = spec.cell(w["name"]).mix
        assert mix["prompt"]["max"] + mix["output"]["max"] <= \
            mix["serving"]["max_len"]
