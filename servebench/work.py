"""The yardstick's arithmetic: the operations and bytes that the true
tokens of a window need, per kernel family and for the whole model, and
the H100's peaks.

Work is counted from what the requests need, never from what a kernel was
launched on: a prefill's true prompt lengths (not its bucket or pad
lanes), the live lanes of each decode step (not dead lanes), the logits
of the last prompt position only, and the experts that the routed tokens
reach. Bytes count each input once and each output once (bf16), and a
launch's least time is the larger of its operations over the peak rate and
its bytes over the memory rate. A share of a roofline sums those least
times over the launches and divides by the kernels' device time.

Experts reached: the trace does not say which experts a step's tokens were
routed to, so the count is the expectation under routing that picks k of
E experts at random for each token, E (1 - (1 - k/E)^T) for T tokens.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
ELT = 2                      # bytes of a bf16 element


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0
    least_s: float = 0.0      # sum over launches of each launch's least time

    def launch(self, flops: float, nbytes: float, times: int = 1) -> None:
        self.flops += flops * times
        self.bytes += nbytes * times
        self.least_s += max(flops / PEAK_FLOPS, nbytes / HBM_BW) * times


def dims(cfg: dict) -> tuple[int, int, int, int]:
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    return cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], hd


def pod_gemms(cfg: dict) -> list[tuple[int, int]]:
    """(K, N) of every NN pod GEMM of one layer, in launch order."""
    d, H, KV, hd = dims(cfg)
    out = [(d, H * hd), (d, KV * hd), (d, KV * hd), (H * hd, d)]
    if cfg["family"] == "dense":
        f = cfg["d_ff"]
        out += [(d, f), (d, f)] if cfg["activation"] == "silu" else [(d, f)]
        out.append((f, d))
    return out


def expert_gemms(cfg: dict) -> list[tuple[int, int]]:
    """(K, N) of each expert's projections: up, gate, down."""
    d, fe = cfg["d_model"], cfg["moe"]["d_ff_expert"]
    return [(d, fe), (d, fe), (fe, d)]


def experts_reached(cfg: dict, tokens: int) -> float:
    m = cfg["moe"]
    E, k = m["num_experts"], m["top_k"]
    return E * (1.0 - (1.0 - k / E) ** tokens)


def gemm(work: Work, M: int, K: int, N: int, times: int = 1) -> None:
    work.launch(2.0 * M * K * N, ELT * (K * N + M * K + M * N), times)


def pod(cfg: dict, prefill_calls: list, decode_live: list) -> Work:
    """The NN pod GEMMs: each layer's projections, and the head. A prefill
    call is the list of its true prompt lengths, which share one launch
    per projection; the head needs one row a prompt. decode_live lists the
    live lanes of every decode step."""
    w = Work()
    L, V, d = cfg["n_layers"], cfg["vocab"], cfg["d_model"]
    rows = [sum(c) for c in prefill_calls] + list(decode_live)
    heads = [len(c) for c in prefill_calls] + list(decode_live)
    for M, Mh in zip(rows, heads):
        for K, N in pod_gemms(cfg):
            gemm(w, M, K, N, times=L)
        gemm(w, Mh, d, V)
    return w


def grouped(cfg: dict, prefill_calls: list, decode_live: list) -> Work:
    """The grouped expert GEMMs (one launch per projection and layer over
    every expert): the top-k rows of every true token and the weights of
    the experts they reach."""
    w = Work()
    if cfg.get("moe") is None:
        return w
    L, k = cfg["n_layers"], cfg["moe"]["top_k"]
    for T in [sum(c) for c in prefill_calls] + list(decode_live):
        hit = experts_reached(cfg, T)
        for K, N in expert_gemms(cfg):
            w.launch(2.0 * k * T * K * N,
                     ELT * (hit * K * N + k * T * (K + N)), times=L)
    return w


def flash(cfg: dict, prefill_calls: list) -> Work:
    """Prefill attention: one launch per layer and call, the causal pairs
    of every true prompt (QK^T and PV) and its q, k, v and output once."""
    w = Work()
    d, H, KV, hd = dims(cfg)
    for call in prefill_calls:
        flops = sum(4.0 * H * hd * P * (P + 1) / 2 for P in call)
        nbytes = sum(ELT * P * hd * (2 * H + 2 * KV) for P in call)
        w.launch(flops, nbytes, times=cfg["n_layers"])
    return w


def linear_params(cfg: dict) -> float:
    """Weights one token multiplies by in one layer: its projections, and
    under MoE the router and its top-k experts."""
    p = sum(K * N for K, N in pod_gemms(cfg))
    if cfg.get("moe"):
        m = cfg["moe"]
        p += cfg["d_model"] * m["num_experts"]
        p += m["top_k"] * sum(K * N for K, N in expert_gemms(cfg))
    return float(p)


def model_flops(cfg: dict, prompts: list, contexts: int,
                decode_tokens: int) -> float:
    """Operations the true tokens need: every prompt token through every
    layer with causal attention over its prompt and the head at its last
    position; every decode token through every layer, attending over
    `contexts` keys in all, and the head."""
    d, H, KV, hd = dims(cfg)
    L, V = cfg["n_layers"], cfg["vocab"]
    lin = 2.0 * linear_params(cfg) * L
    att = 4.0 * H * hd * L
    f = 0.0
    for P in prompts:
        f += lin * P + att * P * (P + 1) / 2 + 2.0 * d * V
    f += lin * decode_tokens + att * contexts + 2.0 * d * V * decode_tokens
    return f
