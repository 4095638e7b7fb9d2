#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, one JSON line each; any failure exits non-zero:

  1. build   - nvcc builds the pod-GEMM kernel from src/ for sm_90a.
  2. kernel  - the kernel against its plain PyTorch version on the card:
               f32/bf16/int8 x every activation x ragged shapes x f32/bf16
               out, each within runtime.TOLERANCES.
  3. serve   - granite-8b at full width and depth (random weights from a
               seeded torch.Generator, bf16) served by ServeEngine; every
               request must finish with valid tokens, and the pod-GEMM
               launch count must be 7 x 36 + 1 = 253 per forward.
  4. oracle  - the same requests through the per-token ReferenceEngine.
               Random weights at 36 layers turn a last-bit difference into
               different tokens, so agreement is reported there and the
               rule (tokens agree, or differ only after a near tie) is held
               on the first ORACLE_LAYERS layers of the same weights.
  5. kernels - the kernel's time at the served shapes beside its bound,
               its plain version and one torch.matmul (a yardstick only).

The last lines are the card's name and power limit, the kernels line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import HOST_SYNCS, TOLERANCES  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.systolic_gemm import systolic_gemm as sg  # noqa: E402
from repro_torch.kernels.systolic_gemm.ref import systolic_gemm_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

ARCH = "granite-8b"
SLOTS, MAX_LEN, DECODE_CHUNK, MAX_NEW = 4, 512, 8, 16
N_REQUESTS = 6
ORACLE_LAYERS = 2       # depth at which the engine/oracle margin rule holds
GEMMS_PER_LAYER = ("q", "k", "v", "o", "gate", "up", "down")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    sg._lib()
    seconds = time.perf_counter() - t0
    info = _build.build_info("systolic_gemm")
    ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, ptxas=ptxas, torch=torch.__version__,
         cuda=torch.version.cuda, gpu=gpu_name_and_power())


# --------------------------------------------------------------------------
# 2. kernel vs plain
# --------------------------------------------------------------------------

def gemm_inputs(M, K, N, dtype, g):
    dev = "cuda"
    if dtype == torch.int8:
        x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
    else:
        # the model's fan-in scale keeps outputs O(1)
        x = torch.randn((M, K), generator=g, device=dev).to(dtype)
        w = (torch.randn((K, N), generator=g, device=dev)
             / math.sqrt(K)).to(dtype)
    return x, w


def tolerance(dtype, out_dtype, activation):
    """int8 products are exact; an epilogue (scale, bias, exp or tanh) may
    round differently in the kernel and in torch."""
    if dtype == torch.int8:
        return TOLERANCES["gemm_int8_exact" if activation is None
                          else "gemm_int8_epilogue"]
    if out_dtype == torch.bfloat16:
        return TOLERANCES["gemm_bf16out"]
    if dtype == torch.bfloat16:
        return TOLERANCES["gemm_bf16_f32out"]
    return TOLERANCES["gemm_f32"]


def bf16_summed(x, w, k_step: int = 16) -> torch.Tensor:
    """Planted control: the plain version with its partial sums rounded to
    bf16 every k_step terms (one mma's K), as a kernel that accumulates in
    bf16 would. The tolerances must reject it."""
    acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    for k0 in range(0, x.shape[1], k_step):
        part = x[:, k0:k0 + k_step].float() @ w[k0:k0 + k_step].float()
        acc = (acc + part).to(torch.bfloat16).float()
    return acc


def phase_kernel() -> None:
    """Every case is read before any verdict, so one failing run shows
    all of them. `excess` is max |got - ref| / (atol + rtol |ref|): the
    kernel must stay at or below 1, the bf16-summing control above it."""
    g = torch.Generator("cuda").manual_seed(1)
    shapes = [(37, 100, 130), (1, 4096, 14336), (5, 4096, 49152)]
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    control: dict[str, dict] = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for (M, K, N) in shapes:
            x, w = gemm_inputs(M, K, N, dtype, g)
            scale = torch.rand(N, generator=g, device="cuda") + 0.5
            bias = torch.randn(N, generator=g, device="cuda")
            for act in sg.ACTIVATIONS:
                for out_dtype in (torch.float32, torch.bfloat16):
                    # the epilogue with and without scale/bias
                    sb = (scale, bias) if act is not None else (None, None)
                    got = sg.systolic_gemm_cuda(x, w, *sb, activation=act,
                                                out_dtype=out_dtype)
                    ref = systolic_gemm_ref(x, w, *sb, activation=act,
                                            out_dtype=out_dtype)
                    torch.cuda.synchronize()
                    tol = tolerance(dtype, out_dtype, act)
                    err = float((got.double() - ref.double()).abs().max())
                    excess = tol.excess(got, ref)
                    key = f"{str(dtype)[6:]}->{str(out_dtype)[6:]}"
                    row = worst.setdefault(key, {"max_abs_err": 0.0,
                                                 "excess": 0.0})
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                    row["excess"] = max(row["excess"], excess)
                    case = (f"{key} {M}x{K}x{N} act={act} max_abs_err={err} "
                            f"excess={excess} ({tol})")
                    if not bool(torch.isfinite(got.float()).all()):
                        failures.append("non-finite kernel output " + case)
                    elif not excess <= 1.0:
                        failures.append("kernel disagrees with plain " + case)
                    if act is None and dtype != torch.int8:
                        planted = bf16_summed(x, w).to(out_dtype)
                        c = tol.excess(planted, ref)
                        row = control.setdefault(key, {"min_excess": c,
                                                       "max_abs_err": 0.0})
                        row["min_excess"] = min(row["min_excess"], c)
                        row["max_abs_err"] = max(row["max_abs_err"], float(
                            (planted.double() - ref.double()).abs().max()))
                        if c <= 1.0:
                            failures.append("bf16-summing control passes "
                                            f"{key} {M}x{K}x{N} excess={c}")
                    cases += 1
    emit("kernel", cases=cases, worst=worst, control=control,
         tolerances={k: [t.rtol, t.atol] for k, t in TOLERANCES.items()
                     if k.startswith("gemm")}, failures=failures)
    check(not failures, f"{len(failures)} kernel checks failed")


# --------------------------------------------------------------------------
# 3. serve and 4. oracle
# --------------------------------------------------------------------------

def make_requests(vocab: int) -> list[Request]:
    rng = np.random.default_rng(0)
    lens = rng.integers(5, 201, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(lens)]


def serve(engine, reqs: list[Request]) -> float:
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=1000)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_serve(model, params):
    cfg = model.cfg
    # warm-up request: lazy CUDA/cuBLAS set-up stays out of the timings
    serve(ServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                      decode_chunk=DECODE_CHUNK),
          [Request(rid=-1, prompt=np.arange(8), max_new_tokens=2)])
    reqs = make_requests(cfg.vocab)
    eng = ServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                      decode_chunk=DECODE_CHUNK)
    sg.systolic_gemm_cuda.launches = 0
    syncs0 = HOST_SYNCS.count
    wall = serve(eng, reqs)
    launches = sg.systolic_gemm_cuda.launches
    syncs = HOST_SYNCS.count - syncs0
    st = eng.stats
    for r in reqs:
        check(r.done and r.state == "done",
              f"request {r.rid} ended {r.state} ({r.reason})")
        check(len(r.out) == MAX_NEW, f"request {r.rid}: {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid}: token outside [0, {cfg.vocab})")
    per_forward = len(GEMMS_PER_LAYER) * cfg.n_layers + 1
    forwards = st["prefill_calls"] + st["decode_steps"]
    check(launches == per_forward * forwards,
          f"pod-GEMM launches {launches} != {per_forward} x {forwards}")
    check(syncs == st["prefill_calls"] + st["chunks"],
          f"host syncs {syncs} != prefill groups + decode chunks")
    generated = sum(len(r.out) for r in reqs)
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=generated,
         wall_s=wall, tokens_per_s=generated / wall,
         prefill_calls=st["prefill_calls"],
         prefill_ms_per_call=1e3 * st["prefill_s"] / st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         decode_ms_per_step=1e3 * st["decode_s"] / st["decode_steps"],
         host_syncs=syncs, pod_gemm_launches=launches,
         launches_per_forward=per_forward)
    return reqs, launches


def first_differences(served, oracle, ref: ReferenceEngine) -> list[dict]:
    """Per request whose tokens differ: the first differing step and the
    oracle's top-1 minus top-2 logit there."""
    diffs = []
    for a, b in zip(served, oracle):
        check(b.done, f"oracle request {b.rid} ended {b.state}")
        if a.out != b.out:
            j = next(i for i, (x, y) in enumerate(zip(a.out, b.out))
                     if x != y)
            margin, top = ref.margins[b.rid][j]
            diffs.append({"rid": b.rid, "step": j, "margin": margin,
                          "max_abs_logit": top})
    return diffs


def cut_depth(model, params, n_layers: int):
    """The same full-width weights, first n_layers layers only (views)."""
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    cut = {k: v for k, v in params.items() if k != "layers"}
    cut["layers"] = {blk: {k: v[:n_layers] for k, v in sub.items()}
                     for blk, sub in params["layers"].items()}
    return Model(cfg, use_pallas=True), cut


def phase_oracle(model, params, served: list[Request]) -> None:
    """Engine vs per-token oracle. With random weights, 36 layers amplify a
    last-bit difference into different logits (tests/test_torch_model.py
    shows the JAX reference doing the same), so at full depth the agreement
    is reported, and the margin rule is held at a depth cut to
    ORACLE_LAYERS on the same full-width weights."""
    tol = TOLERANCES["token_margin"]
    reqs = make_requests(model.cfg.vocab)
    ref = ReferenceEngine(model, params, slots=SLOTS, max_len=MAX_LEN)
    wall = serve(ref, reqs)
    full = first_differences(served, reqs, ref)
    cut_model, cut_params = cut_depth(model, params, ORACLE_LAYERS)
    cut_served = make_requests(model.cfg.vocab)
    serve(ServeEngine(cut_model, cut_params, slots=SLOTS, max_len=MAX_LEN,
                      decode_chunk=DECODE_CHUNK), cut_served)
    cut_reqs = make_requests(model.cfg.vocab)
    cut_ref = ReferenceEngine(cut_model, cut_params, slots=SLOTS,
                              max_len=MAX_LEN)
    serve(cut_ref, cut_reqs)
    cut = first_differences(cut_served, cut_reqs, cut_ref)
    emit("oracle", requests=len(reqs), oracle_wall_s=wall,
         full_depth={"n_layers": model.cfg.n_layers,
                     "token_exact": len(reqs) - len(full),
                     "first_differences": full},
         cut_depth={"n_layers": ORACLE_LAYERS,
                    "token_exact": len(reqs) - len(cut),
                    "first_differences": cut},
         margin_tolerance=f"{tol.atol} x max|logit|")
    for d in cut:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{ORACLE_LAYERS}-layer cut: request {d['rid']} differs at "
              f"token {d['step']} with oracle margin {d['margin']} > "
              f"{tol.atol} x max|logit| {d['max_abs_logit']}")


# --------------------------------------------------------------------------
# 5. kernels line
# --------------------------------------------------------------------------

def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of fn over iters launches, each after an L2 flush
    (weights are cold in the served model: 16.5 GB pass through per step)."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def phase_kernels_line(cfg, launches: int) -> dict:
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    q = cfg.n_heads * cfg.resolved_head_dim
    shapes = {"q": (d, q, None), "k": (d, kv, None), "v": (d, kv, None),
              "o": (q, d, None), "gate": (d, ff, "silu"),
              "up": (d, ff, None), "down": (ff, d, None),
              "head": (d, vocab, None)}
    g = torch.Generator("cuda").manual_seed(2)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows, worst = [], 0.0
    totals = {ph: dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"),
                                0.0) for ph in ("decode", "prefill")}
    for phase, M, iters in (("decode", SLOTS, 20),
                            ("prefill", SLOTS * 256, 5)):
        for name, (K, N, act) in shapes.items():
            x, w = gemm_inputs(M, K, N, torch.bfloat16, g)
            got = sg.systolic_gemm_cuda(x, w, activation=act,
                                        out_dtype=torch.bfloat16)
            ref = systolic_gemm_ref(x, w, activation=act,
                                    out_dtype=torch.bfloat16)
            err = float((got.double() - ref.double()).abs().max())
            check(TOLERANCES["gemm_bf16out"].ok(got, ref),
                  f"{phase} {name}: kernel disagrees (max_abs_err {err})")
            worst = max(worst, err)

            def library(x=x, w=w, act=act):
                y = torch.matmul(x, w)
                return F.silu(y) if act == "silu" else y
            row = {
                "gemm": name, "phase": phase, "M": M, "K": K, "N": N,
                "ms": time_ms(lambda: sg.systolic_gemm_cuda(
                    x, w, activation=act, out_dtype=torch.bfloat16),
                    iters, flush),
                "plain_ms": time_ms(lambda: systolic_gemm_ref(
                    x, w, activation=act, out_dtype=torch.bfloat16),
                    iters, flush),
                "library_ms": time_ms(library, iters, flush),
                "max_abs_err": err,
            }
            nbytes = 2 * (M * K + K * N + M * N)
            flops = 2 * M * N * K
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOP_PER_S * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            rows.append(row)
            per_forward = 1 if name == "head" else cfg.n_layers
            for key in totals[phase]:
                totals[phase][key] += per_forward * row[key]
    dec = totals["decode"]
    return {"kernels": [{
        "name": "systolic_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/systolic_gemm/csrc/systolic_gemm.cu",
        "replaces": "src/repro/kernels/systolic_gemm/systolic_gemm.py:121",
        "launches": launches, "max_abs_err": worst,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": "bytes",
        "library_ms": dec["library_ms"],
        "ms_are": (f"sums over the {len(GEMMS_PER_LAYER) * cfg.n_layers + 1} "
                   f"pod GEMMs of one {cfg.name} decode step at M={SLOTS} "
                   f"(per-shape rows below, L2 flushed)"),
        "prefill_forward": totals["prefill"],
        "shapes": rows,
    }]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        phase_build()
        phase_kernel()
        torch.cuda.synchronize()

        cfg = get_arch(ARCH)
        t0 = time.perf_counter()
        model = Model(cfg, use_pallas=True)
        params = model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=cfg.name, params=model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)

        served, launches = phase_serve(model, params)
        torch.cuda.synchronize()
        phase_oracle(model, params, served)
        torch.cuda.synchronize()
        del params
        torch.cuda.empty_cache()
        kernels = phase_kernels_line(cfg, launches)
        torch.cuda.synchronize()
        gpu = gpu_name_and_power()
    except Exception:  # every phase failure ends the run non-zero
        traceback.print_exc()
        return 1
    print(gpu)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
