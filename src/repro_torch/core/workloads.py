# Copy of src/repro/core/workloads.py (the port imports nothing of repro).
"""DNN workload traces as GEMM layer lists (SOSA §5 benchmarks).

Convolutions are lowered through the pods' CONV-to-GEMM converter (im2col,
§4.1):  d1 = H_out*W_out (filter reuse), d2 = C_in*kh*kw (features),
d3 = C_out (filters). Transformer layers contribute their projection /
FFN GEMMs (d1 = sequence length) and the per-head attention matmuls.

Parametric generators for the paper's benchmark suite — ResNet-50/101/152,
DenseNet-121/169/201, Inception-v3 (structurally faithful trace) and
BERT-mini/small/medium/base/large — plus generic traces for the assigned
LM architectures (used by parallel/autoshard.py to drive sharding choices).
"""

from __future__ import annotations

import math

from .tiling import GemmSpec


class _Trace:
    """Builds a GemmSpec list with sequential or explicit dependencies."""

    def __init__(self):
        self.gemms: list[GemmSpec] = []
        self._next = 0

    def add(self, d1: int, d2: int, d3: int, deps: tuple[int, ...] | None = None,
            name: str = "") -> int:
        gid = self._next
        if deps is None:
            deps = (gid - 1,) if gid > 0 else ()
        self.gemms.append(GemmSpec(
            d1=max(1, int(d1)), d2=max(1, int(d2)), d3=max(1, int(d3)),
            gemm_id=gid, depends_on=tuple(d for d in deps if d >= 0), name=name))
        self._next += 1
        return gid


def _conv_out(hw: int, k: int, stride: int, pad: str = "same") -> int:
    if pad == "same":
        return math.ceil(hw / stride)
    return (hw - k) // stride + 1


def _conv(t: _Trace, hw: int, cin: int, cout: int, k: int, stride: int = 1,
          deps=None, name="conv", batch: int = 1) -> tuple[int, int]:
    out = _conv_out(hw, k, stride)
    gid = t.add(batch * out * out, cin * k * k, cout, deps=deps, name=name)
    return gid, out


def resnet(depth: int = 50, image: int = 224, batch: int = 1) -> list[GemmSpec]:
    """ResNet-50/101/152 bottleneck trace."""
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    t = _Trace()
    _, hw = _conv(t, image, 3, 64, 7, 2, name="stem", batch=batch)
    hw = _conv_out(hw, 3, 2)  # maxpool
    cin = 64
    width = 64
    for stage, n in enumerate(blocks):
        stride = 1 if stage == 0 else 2
        for b in range(n):
            s = stride if b == 0 else 1
            prev = t._next - 1
            g1, hw1 = _conv(t, hw, cin, width, 1, s, deps=(prev,), name="b1", batch=batch)
            g2, hw1 = _conv(t, hw1, width, width, 3, 1, deps=(g1,), name="b3", batch=batch)
            g3, hw1 = _conv(t, hw1, width, width * 4, 1, 1, deps=(g2,), name="b1x", batch=batch)
            if b == 0:  # projection shortcut — parallel branch
                _conv(t, hw, cin, width * 4, 1, s, deps=(prev,), name="proj", batch=batch)
            hw, cin = hw1, width * 4
        width *= 2
    t.add(batch, cin, 1000, name="fc")
    return t.gemms


def densenet(depth: int = 121, image: int = 224, batch: int = 1,
             growth: int = 32) -> list[GemmSpec]:
    blocks = {121: (6, 12, 24, 16), 169: (6, 12, 32, 32),
              201: (6, 12, 48, 32)}[depth]
    t = _Trace()
    _, hw = _conv(t, image, 3, 2 * growth, 7, 2, name="stem", batch=batch)
    hw = _conv_out(hw, 3, 2)
    cin = 2 * growth
    for stage, n in enumerate(blocks):
        for _ in range(n):
            prev = t._next - 1
            g1, _ = _conv(t, hw, cin, 4 * growth, 1, 1, deps=(prev,), name="d1", batch=batch)
            _conv(t, hw, 4 * growth, growth, 3, 1, deps=(g1,), name="d3", batch=batch)
            cin += growth
        if stage < len(blocks) - 1:
            prev = t._next - 1
            cin //= 2
            _, _ = _conv(t, hw, cin * 2, cin, 1, 1, deps=(prev,), name="trans", batch=batch)
            hw = _conv_out(hw, 2, 2)
    t.add(batch, cin, 1000, name="fc")
    return t.gemms


def inception_v3(image: int = 299, batch: int = 1) -> list[GemmSpec]:
    """Structurally faithful Inception-v3 trace: stem + 11 inception blocks
    with parallel 1x1 / 3x3 / factorized-7x7 / pool-proj branches."""
    t = _Trace()
    _, hw = _conv(t, image, 3, 32, 3, 2, name="stem1", batch=batch)
    _, hw = _conv(t, hw, 32, 32, 3, 1, name="stem2", batch=batch)
    _, hw = _conv(t, hw, 32, 64, 3, 1, name="stem3", batch=batch)
    hw = _conv_out(hw, 3, 2)
    _, hw = _conv(t, hw, 64, 80, 1, 1, name="stem4", batch=batch)
    _, hw = _conv(t, hw, 80, 192, 3, 1, name="stem5", batch=batch)
    hw = _conv_out(hw, 3, 2)
    cin = 192

    def block_a(cin: int, pool_c: int) -> int:
        root = t._next - 1
        b1, _ = _conv(t, hw, cin, 64, 1, 1, deps=(root,), name="a1", batch=batch)
        b2a, _ = _conv(t, hw, cin, 48, 1, 1, deps=(root,), name="a5a", batch=batch)
        b2b, _ = _conv(t, hw, 48, 64, 5, 1, deps=(b2a,), name="a5b", batch=batch)
        b3a, _ = _conv(t, hw, cin, 64, 1, 1, deps=(root,), name="a3a", batch=batch)
        b3b, _ = _conv(t, hw, 64, 96, 3, 1, deps=(b3a,), name="a3b", batch=batch)
        b3c, _ = _conv(t, hw, 96, 96, 3, 1, deps=(b3b,), name="a3c", batch=batch)
        b4, _ = _conv(t, hw, cin, pool_c, 1, 1, deps=(root,), name="apool", batch=batch)
        return 64 + 64 + 96 + pool_c

    for pool_c in (32, 64, 64):
        cin = block_a(cin, pool_c)
    # reduction A
    root = t._next - 1
    _conv(t, hw, cin, 384, 3, 2, deps=(root,), name="ra1", batch=batch)
    g, _ = _conv(t, hw, cin, 64, 1, 1, deps=(root,), name="ra2a", batch=batch)
    g, _ = _conv(t, hw, 64, 96, 3, 1, deps=(g,), name="ra2b", batch=batch)
    _conv(t, hw, 96, 96, 3, 2, deps=(g,), name="ra2c", batch=batch)
    hw = _conv_out(hw, 3, 2)
    cin = 384 + 96 + cin  # + pooled passthrough

    def block_b(cin: int, f7: int) -> int:
        root = t._next - 1
        _conv(t, hw, cin, 192, 1, 1, deps=(root,), name="b1", batch=batch)
        g, _ = _conv(t, hw, cin, f7, 1, 1, deps=(root,), name="b7a", batch=batch)
        g, _ = t.add(batch * hw * hw, f7 * 7, f7, deps=(g,), name="b7b"), hw
        g2, _ = t.add(batch * hw * hw, f7 * 7, 192, deps=(g,), name="b7c"), hw
        g3, _ = _conv(t, hw, cin, f7, 1, 1, deps=(root,), name="b7d", batch=batch)
        g3, _ = t.add(batch * hw * hw, f7 * 7, f7, deps=(g3,), name="b7e"), hw
        g3, _ = t.add(batch * hw * hw, f7 * 7, f7, deps=(g3,), name="b7f"), hw
        g3, _ = t.add(batch * hw * hw, f7 * 7, f7, deps=(g3,), name="b7g"), hw
        g3, _ = t.add(batch * hw * hw, f7 * 7, 192, deps=(g3,), name="b7h"), hw
        _conv(t, hw, cin, 192, 1, 1, deps=(root,), name="bpool", batch=batch)
        return 192 * 4

    for f7 in (128, 160, 160, 192):
        cin = block_b(cin, f7)
    # reduction B
    root = t._next - 1
    g, _ = _conv(t, hw, cin, 192, 1, 1, deps=(root,), name="rb1a", batch=batch)
    _conv(t, hw, 192, 320, 3, 2, deps=(g,), name="rb1b", batch=batch)
    g, _ = _conv(t, hw, cin, 192, 1, 1, deps=(root,), name="rb2a", batch=batch)
    g = t.add(batch * hw * hw, 192 * 7, 192, deps=(g,), name="rb2b")
    g = t.add(batch * hw * hw, 192 * 7, 192, deps=(g,), name="rb2c")
    _conv(t, hw, 192, 192, 3, 2, deps=(g,), name="rb2d", batch=batch)
    hw = _conv_out(hw, 3, 2)
    cin = 320 + 192 + cin

    def block_c(cin: int) -> int:
        root = t._next - 1
        _conv(t, hw, cin, 320, 1, 1, deps=(root,), name="c1", batch=batch)
        g, _ = _conv(t, hw, cin, 384, 1, 1, deps=(root,), name="c3a", batch=batch)
        t.add(batch * hw * hw, 384 * 3, 384, deps=(g,), name="c3b")
        t.add(batch * hw * hw, 384 * 3, 384, deps=(g,), name="c3c")
        g, _ = _conv(t, hw, cin, 448, 1, 1, deps=(root,), name="c5a", batch=batch)
        g2, _ = _conv(t, hw, 448, 384, 3, 1, deps=(g,), name="c5b", batch=batch)
        t.add(batch * hw * hw, 384 * 3, 384, deps=(g2,), name="c5c")
        t.add(batch * hw * hw, 384 * 3, 384, deps=(g2,), name="c5d")
        _conv(t, hw, cin, 192, 1, 1, deps=(root,), name="cpool", batch=batch)
        return 320 + 768 + 768 + 192

    for _ in range(2):
        cin = block_c(cin)
    t.add(batch, cin, 1000, name="fc")
    return t.gemms


_BERT_SIZES = {
    "mini": (4, 256, 4), "small": (4, 512, 8), "medium": (8, 512, 8),
    "base": (12, 768, 12), "large": (24, 1024, 16),
}


def bert(size: str = "base", seq: int = 100, batch: int = 1,
         include_attention: bool = True) -> list[GemmSpec]:
    layers, h, heads = _BERT_SIZES[size]
    t = _Trace()
    s = seq * batch
    hd = h // heads
    for _ in range(layers):
        prev = t._next - 1
        q = t.add(s, h, h, deps=(prev,), name="q")
        k = t.add(s, h, h, deps=(prev,), name="k")
        v = t.add(s, h, h, deps=(prev,), name="v")
        last = (q, k, v)
        if include_attention:
            scores = [t.add(seq, hd, seq, deps=(q, k), name="qk")
                      for _ in range(heads * batch)]
            ctx = [t.add(seq, seq, hd, deps=(sc, v), name="av")
                   for sc in scores]
            last = tuple(ctx)
        o = t.add(s, h, h, deps=last, name="o")
        f1 = t.add(s, h, 4 * h, deps=(o,), name="ffn1")
        t.add(s, 4 * h, h, deps=(f1,), name="ffn2")
    return t.gemms


def transformer_lm(n_layers: int, d_model: int, n_heads: int, d_ff: int,
                   seq: int, batch: int = 1, vocab: int = 0,
                   n_kv_heads: int | None = None,
                   include_attention: bool = True) -> list[GemmSpec]:
    """Generic decoder-LM weight-GEMM trace (for assigned-arch analysis)."""
    t = _Trace()
    s = seq * batch
    kv = n_kv_heads or n_heads
    hd = d_model // n_heads
    for _ in range(n_layers):
        prev = t._next - 1
        q = t.add(s, d_model, n_heads * hd, deps=(prev,), name="q")
        k = t.add(s, d_model, kv * hd, deps=(prev,), name="k")
        v = t.add(s, d_model, kv * hd, deps=(prev,), name="v")
        last = (q, k, v)
        if include_attention:
            sc = t.add(seq, hd, seq, deps=(q, k), name="qk")
            av = t.add(seq, seq, hd, deps=(sc, v), name="av")
            last = (av,)
        o = t.add(s, n_heads * hd, d_model, deps=last, name="o")
        f1 = t.add(s, d_model, d_ff, deps=(o,), name="ffn_up")
        g1 = t.add(s, d_model, d_ff, deps=(o,), name="ffn_gate")
        t.add(s, d_ff, d_model, deps=(f1, g1), name="ffn_down")
    if vocab:
        t.add(s, d_model, vocab, name="lm_head")
    return t.gemms


# -- the paper's benchmark suites (§5) --------------------------------------

def cnn_suite(batch: int = 1, image: int = 299) -> dict[str, list[GemmSpec]]:
    return {
        "inception-v3": inception_v3(image, batch),
        "resnet50": resnet(50, image, batch),
        "resnet101": resnet(101, image, batch),
        "resnet152": resnet(152, image, batch),
        "densenet121": densenet(121, image, batch),
        "densenet169": densenet(169, image, batch),
        "densenet201": densenet(201, image, batch),
    }


def bert_suite(seq: int = 100, batch: int = 1) -> dict[str, list[GemmSpec]]:
    return {
        "bert-medium": bert("medium", seq, batch),
        "bert-base": bert("base", seq, batch),
        "bert-large": bert("large", seq, batch),
    }


def full_suite(batch: int = 1) -> dict[str, list[GemmSpec]]:
    out = cnn_suite(batch)
    out.update(bert_suite(100, batch))
    return out


def dse_cnn_suite() -> dict[str, list[GemmSpec]]:
    """Fig 5a workloads: CNNs at 224/256/299 (one representative each)."""
    out = {}
    for img in (224, 256, 299):
        out[f"resnet50@{img}"] = resnet(50, img)
        out[f"densenet121@{img}"] = densenet(121, img)
        out[f"inception@{img}"] = inception_v3(img)
    return out


def dse_transformer_suite() -> dict[str, list[GemmSpec]]:
    """Fig 5b workloads: BERT mini..large x sequence lengths [57]."""
    out = {}
    for size in ("mini", "small", "medium", "base", "large"):
        for seq in (10, 40, 100, 300, 500):
            out[f"bert-{size}@{seq}"] = bert(size, seq)
    return out
