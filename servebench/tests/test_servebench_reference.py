"""The plain references against the program at a reduced size on the CPU,
both families, in float32; and what the reference files import."""

from __future__ import annotations

import ast

import pytest
import torch

from servebench import reference, spec, weights
from servebench.reference.common import F32, FP8
from servebench.run import arch_config

from ._cells import small_config


def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["granite-8b", "dbrx-132b"])
def test_reference_equals_the_program_in_f32(name):
    from repro_torch.models.model import Model
    cfg = small_config(name)
    model = Model(arch_config(cfg), attention_impl="pallas",
                  ssd_impl="pallas", use_pallas=True, device="cpu")
    params = _to_f32(weights.make(model.shapes(device="meta"), 5, "cpu"))
    tokens = torch.randint(0, cfg["vocab"], (37,),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": tokens[None]})
    want = reference.family(cfg["family"]).forward_rows(
        params, cfg, tokens, torch.arange(37), F32())
    scale = float(want.abs().max())
    assert scale > 1.0
    torch.testing.assert_close(got[0], want, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("name", ["granite-8b", "dbrx-132b"])
def test_float8_control_moves_the_logits(name):
    cfg = small_config(name)
    from repro_torch.models.model import Model
    model = Model(arch_config(cfg), device="cpu")
    params = weights.make(model.shapes(device="meta"), 9, "cpu")
    tokens = torch.arange(20) * 7 % cfg["vocab"]
    fam = reference.family(cfg["family"])
    a = fam.forward_rows(params, cfg, tokens, torch.arange(20), F32())
    b = fam.forward_rows(params, cfg, tokens, torch.arange(20), FP8())
    rel = float((a - b).abs().max() / a.abs().max())
    assert 0.005 < rel < 0.5


def test_weights_refill_draws_the_same_tensors():
    from repro_torch.models.model import Model
    model = Model(arch_config(small_config("dbrx-132b")), device="cpu")
    shapes = model.shapes(device="meta")
    a = weights.make(shapes, 2**31 + 5, "cpu")
    b = weights.make(shapes, 3, "cpu")
    weights.refill(b, 2**31 + 5)
    flat = lambda t: [x for v in t.values() for x in
                      (flat(v) if isinstance(v, dict) else [v])]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert flat(a)[0].dtype == torch.bfloat16
    assert any(x.dtype == torch.float32 for x in flat(a))   # the router


def _imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_references_import_nothing_of_the_program():
    files = sorted((spec.HERE / "reference").glob("*.py"))
    assert len(files) >= 3
    for f in files:
        assert not _imports(f) & {"repro_torch", "repro", "jax", "jaxlib",
                                  "flax"}, f


def test_no_harness_file_imports_jax_or_the_jax_package():
    for f in sorted(spec.HERE.rglob("*.py")):
        assert not _imports(f) & {"repro", "jax", "jaxlib", "flax"}, f
