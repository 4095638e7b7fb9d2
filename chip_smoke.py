#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, one JSON line each; any failure exits non-zero:

  1. build   - nvcc builds the pod-GEMM (NN, NT and grouped), flash-
               attention and SSD kernels from src/ for sm_90a, in parallel,
               and prints each ptxas report.
  2. kernel  - the pod-GEMM kernel against its plain PyTorch version on the
               card: f32/bf16/int8 x every activation x ragged shapes x
               f32/bf16 out, each within runtime.TOLERANCES, with
               granite-8b's and dbrx-132b's served shapes (dbrx's q/o, k/v
               and head at M = 4 and 1277) and shapes that reach each bf16
               mainloop's edges (wgmma at M = 65, 129, 1000, 1277, N =
               1032, K = 4104; splitk with splits that do not divide the
               k-steps evenly); a planted control that sums in bf16 must
               fail, and at granite-8b's q and head (M = 4) two split-K
               controls (the last split's partial left out; each k-step's
               products taken with the previous step's w tile) must fail.
               A row's result must be bit-equal at M = 256, 65, 57, 4 and
               1 (wgmma and splitk sum K in one order), in the NN form at
               granite's q and dbrx's k and in the NT form at mamba2's
               head; and in the grouped form at dbrx's up projection (G =
               16) at M = 399, 320, 129 and 65, all on wgmma. hymba-1.5b's
               ragged head (N = 32001, wmma) at M = 4 and 1024.
  3. gemm_nt - the same for the transposed-weight kernel (w [N, K], the
               tied LM head), with mamba2's head [4, 1024] x [50280, 1024]^T
               among the shapes (a 104-column ragged tail) and its NT
               mainloop edges (wgmma at M = 65, 129, 300, 1277; splitk at
               4 and 29; K = 4104 split 13 ways on both); the two split-K
               controls, planted on w [N, K], must fail at mamba2's head
               and at the 13-way split.
  4. flash   - the flash-attention kernel against its plain version:
               f32/bf16 x the cases of tests/test_kernels.py, granite-8b's
               and dbrx-132b's heads (48 over 8 at its longest and
               shortest prompts), Sq != Skv, D = 192, and the wgmma
               mainloop's edges (Sq and Skv at 127, 128, 129; a kv_len
               tail inside a key tile and on its edge; a window across two
               key tiles; B > 1 with ragged S; D = 64 and 128), hymba-
               1.5b's heads (25 over 5, D 64) with its 1024-token window
               at [4, 2048] and [1, 1277] and global at [4, 2048], within
               runtime.TOLERANCES, each case with its mainloop
               (flash_plan); bf16 also against the Pallas kernel's own
               arithmetic at the kernel's key tile (flash_bf16_tiled_served:
               one bf16 ulp and a flipped p of a heavy key). Two planted
               controls (causal mask off by one, GQA map h % Hkv) must
               fail; at granite-8b's [4, 2048, 32, 128] two that err on
               late KV tiles only (a stale K tile, PV summed in bf16) must
               fail that tolerance. A prompt's rows must be bit-equal
               prefilled alone ([1, S]) and in a [4, 2S] bucket, at
               granite's and dbrx's heads.
  5. ssd     - the SSD chunk-scan kernel against the Pallas kernel's own
               arithmetic (ssd_kernel_ref) at about one bf16 ulp and
               against the reference (ssd_ref, bf16 state) at its stated
               drift, y and final state: the cases of tests/test_kernels.py
               in f32 and bf16, mamba2's [4, 2048, 32, 64] (N 128, chunk
               256; in bf16 and in f32, where the kernel runs 128-token
               sub-chunks), a ragged S and G > 1, hymba-1.5b's [4, 2048,
               50, 64] at N 16 with the served model's dt and with
               Mamba-2's (slow heads carry their state across chunks),
               each on the mainloop ssd_plan picks (bf16 at mamba2's tiles
               on chunked, the rest on serial). At the served shape
               seven planted controls (no state carried across chunks, the mask after exp, y_inter
               from the updated state, ssd_ref itself, the state and
               y_inter rounded to bf16, the state pass without its decay,
               cum carried across chunks) must fail the one-ulp tolerance;
               a long-chunk-decay case ([4, 1024] at the same tiles, dt and
               A as Mamba-2 initialises them, so slow heads carry their
               state across whole chunks) passes it too, and the same
               controls fail there, cum across chunks on the state itself
               (the bf16 state is reported there, not gated);
               a prompt of 1277 tokens gives bit-equal rows and state alone
               ([1, 1277]) and in a [4, 2048] bucket; strided views of one
               projection give bit-equal results to contiguous copies.
  6. grouped - the grouped pod-GEMM kernel (the MoE experts) against its
               plain version: f32/bf16/int8 x every activation x ragged
               shapes x f32/bf16 out with per-group scale and bias (G > 1
               on wgmma at M = 65 and 129 too), an all-zero group exactly
               0, G = 1 equal to the pod-GEMM kernel bit for bit where
               both run one mainloop (wmma, simt or wgmma; within
               tolerance where the NN launch runs splitk and the grouped
               one wmma), and dbrx-132b's served shapes ([16, 1, 6144] x
               [16, 6144, 10752], the down [16, 1, 10752] x [16, 10752,
               6144], M = 320 and 399 rows per expert, up and down). Two
               planted controls (sums in bf16, group g+1 reading group g's
               weights) must fail.
  7. serve   - granite-8b at full width and depth (random weights from a
               seeded torch.Generator, bf16) served by ServeEngine, whose
               bucketed prefills and decode chunks replay CUDA graphs
               (serve/graphs.py); every request must finish with valid
               tokens, and the pod-GEMM launch count must be 7 x 36 + 1 =
               253 per forward, each on splitk (M <= 64) or wgmma (M >
               64), none on wmma. The paged and moe phases hold their
               pod-GEMM launches to the same rule. Every serve phase
               (7, 9, 11, 13) then serves the same requests through an
               eager engine (ServeEngine(eager=True)) in the same run:
               tokens, every host read (first tokens and packed decode
               chunks) bit for bit, host syncs and launch counts by
               mainloop must be equal, the graphs within
               max_prefill_compiles and log2(decode_chunk) + 1; a second
               pass of each engine gives its steady figures (decode
               ms/step, prefill ms/call, tokens/s; the graphed one
               captures nothing), and one decode chunk of each is traced
               with torch.profiler (idle_share: 1 - kernel time over the
               chunk's wall), with capture seconds, graph count, the graph
               pool's bytes and whether one decode step's logits are
               bit-equal graphed and eager.
  8. oracle  - the same requests through the per-token ReferenceEngine.
               Random weights at 36 layers turn a last-bit difference into
               different tokens, so agreement is reported there and the
               rule (tokens agree, or differ only after a near tie) is held
               on the first ORACLE_LAYERS layers of the same weights.
  9. serve_paged  - the same weights as Model(attention_impl="pallas"),
               served by a paged ServeEngine (max_len 2048, a pool of half
               the dense pages) on prompts of up to 1500 tokens: every
               request done, the pool drained, at least one lane recycled,
               36 flash launches per prefill, each on wgmma, 253 pod-GEMM
               launches per forward, one host sync per prefill group and
               decode chunk.
 10. paged_oracle - the same requests through a dense ServeEngine on the
               same flash model: tokens must be equal. On ORACLE_LAYERS
               layers the paged flash engine is held to the margin rule
               against the per-token ReferenceEngine of the same model.
               The kernel on layer 0's real activations of the served
               prompts is held to the Pallas kernel's own arithmetic.
 11. serve_ssm - mamba2-370m at full width and depth (48 layers, d 1024,
               vocab 50280, tied embeddings; random bf16 weights) as
               Model(ssd_impl="pallas", use_pallas=True), served by
               ServeEngine(slots 4, max_len 2048, decode_chunk 8) on the
               paged phase's prompts: every request done, one NT-GEMM
               launch per forward, each on splitk (decode) or wgmma
               (prefill), 48 SSD launches per prefill, each on chunked, and
               none per decode step, no other kernel, one host sync per prefill group and
               decode chunk.
 12. ssm_oracle - the same requests through the per-token ReferenceEngine:
               agreement reported at 48 layers, the margin rule held on
               ORACLE_LAYERS layers of the same weights.
 13. serve_moe - dbrx-132b at full width and MOE_LAYERS of its 40 layers
               (random bf16 weights) as Model(attention_impl="pallas",
               use_pallas=True), served by ServeEngine(slots 4, max_len
               2048, decode_chunk 8) on the paged phase's prompts with
               exact-length prefill: every request done, 8 prefills of
               [1, S], 24 grouped and 33 pod-GEMM launches per forward, the
               grouped ones on wgmma where a prefill gives an expert more
               than 64 rows and on wmma otherwise, 8 flash launches per
               prefill, each on wgmma, and none per decode step, no NT or
               SSD launch, one host sync per prefill and decode chunk.
 14. moe_oracle - the first 4 of those requests through a fresh ServeEngine
               and the per-token ReferenceEngine: every decode batch is
               fully live in both, so capacity coupling through dead lanes
               cannot tell them apart. Agreement reported at MOE_LAYERS,
               the margin rule held at the first difference anywhere in the
               batch on ORACLE_LAYERS layers of the same weights.
 15. serve_hybrid - hymba-1.5b at full width and depth (32 layers, d
               1600, 25 heads over 5 of 64, a 50-head Mamba-2 mixer beside
               the attention in every layer, a 1024-token window except in
               the global layers 0, 15 and 31, vocab 32001, untied; random
               bf16 weights) as Model(attention_impl="pallas",
               ssd_impl="pallas", use_pallas=True), served on the paged
               phase's prompts (the 1277- and 957-token ones cross the
               window in prefill, and their decode wraps the ring) by a
               dense ServeEngine (slots 4, max_len 2048, decode_chunk 8;
               graphed against eager as every serve phase) and by a paged
               one (the paged phase's pool for the global layers; rings
               and SSM state lane-resident), two graphed passes: every
               request done, paged tokens equal to dense and the pool
               drained, 225 pod-GEMM launches per forward (the head, N =
               32001, on wmma; the rest on splitk or wgmma by M), 32 flash
               launches per prefill on wgmma (the window of each: 29
               windowed, 3 global) and 32 SSD launches on serial, none per
               decode step, no NT or grouped launch, one host sync per
               prefill group and decode chunk; weights, rings, global KV,
               SSM state and graph pools' bytes and the decode floor.
 16. hybrid_oracle - the same requests through the per-token
               ReferenceEngine (exact-length prefill: the ring's roll):
               agreement reported at 32 layers, the margin rule held on
               ORACLE_LAYERS layers of the same weights (glob0 and the
               first layer of swa1).
 17. serve_controls - run after phase 10 on granite-8b's weights at full
               width (Model(cfg, use_pallas=True); the flash model for the
               paged engine): the overload case of tests/test_admission.py
               (slots 2, decode_chunk 8, 12 requests of 5-8 tokens, 6 new,
               deadlines 0.8 and 7.0 s alternating) under a VirtualClock
               with ChaosConfig(seed=0, service_seconds=0.05), under fifo,
               edf and slo-aware: every request terminal, no slot held,
               edf and slo-aware above fifo in SLO attainment. The serve
               phase's requests with the defaults and with metrics and a
               trace recorder on, real clock: equal tokens, host syncs,
               graphs and launches by kernel and mainloop, one span per
               device call; a second pass gives effective_tops_summary per
               phase (prefill, decode), the token wait p50/p99 and tok/s.
               The paged engine (edf) with ChaosConfig(seed=3, p_fault=0.3,
               p_slow=0.3), max_retries 3: faults injected, every request
               done with the chaos-free run's tokens, runners and graphs
               equal to its, no page or slot held; with transient_tries 5
               (retries exhausted) requests end rejected device-fault and
               nothing leaks. The wave-model predictor's host ms per new
               key at full width. Two planted controls must fail their
               gates: an engine whose call writes before the injector
               raises (token equality after retry), and a metrics hook
               that reads a device tensor (the sync count).
 18. launch_serve - repro_torch.launch.serve.main in-process (reduced
               granite-8b, edf, deadline 5 s, chaos seed 1, metrics, a
               trace file under build/): it returns, it launched the
               pod GEMM and flash kernels, and the trace file holds one
               span per device call.
 19. kernels - each kernel's time at the served shapes beside its bound,
               its plain version and one PyTorch call (a yardstick only);
               the pod GEMM at granite-8b's, dbrx-132b's and hymba-1.5b's
               shapes (hymba's head on wmma at M = 4 and 8192), flash
               at granite's [4, 256] and [4, 2048], dbrx's [1, 1277] and
               hymba's [4, 2048] windowed and global prefills (mainloop,
               key tile and TFLOP/s each; the window's bound counts the
               keys inside it, SDPA takes it as a mask), the NT
               head up to a [4, 2048] prefill, SSD at [4, 256] and [4,
               2048] on its mainloop with the serial mainloop timed beside
               it and hymba's [4, 2048] on serial, the grouped experts' up
               and down at M = 320; launches by mainloop from the served
               runs (hymba's under "hybrid" in each entry).

The last lines are the card's name and power limit, the kernels line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import HOST_SYNCS, TOLERANCES  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref, flash_attention_tiled_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    CHUNKED_FAULTS, ssd_chunked_ref, ssd_kernel_ref, ssd_ref)
from repro_torch.kernels.systolic_gemm import systolic_gemm as sg  # noqa: E402
from repro_torch.kernels.systolic_gemm.ref import (  # noqa: E402
    epilogue_ref, grouped_systolic_gemm_ref, splitk_partials, systolic_gemm_ref,
    systolic_gemm_t_ref)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import (apply_norm, apply_rope, embed,  # noqa: E402
                                       pod_dense)
from repro_torch.runtime import no_tf32  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs.drift import effective_tops_summary  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.admission import (POLICIES, AdmissionConfig,  # noqa: E402
                                         WaveLatencyPredictor)
from repro_torch.serve.chaos import (ChaosConfig, TransientDeviceError,  # noqa: E402
                                     VirtualClock)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.graphs import GraphPool, StepRunner  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402
from repro_torch.tenancy.trace import ServeTraceRecorder  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12          # CUDA cores, outside the tensor cores

ARCH = "granite-8b"
SLOTS, MAX_LEN, DECODE_CHUNK, MAX_NEW = 4, 512, 8, 16
N_REQUESTS = 6
ORACLE_LAYERS = 2       # depth at which the engine/oracle margin rule holds
GEMMS_PER_LAYER = ("q", "k", "v", "o", "gate", "up", "down")
# the paged engine: a pool of half the dense 4 x 2048 / 16 = 512 pages
PAGED = dict(slots=4, max_len=2048, decode_chunk=8, paged=True, page_size=16,
             kv_pages=256)
N_PAGED_REQUESTS = 8
PAGED_MAX_PROMPT = 1500
# mamba2: the paged phase's traffic on a dense lane-resident SSM cache
SSM_ARCH = "mamba2-370m"
SSM_SERVE = dict(slots=4, max_len=2048, decode_chunk=8)
# dbrx-132b at full width, depth cut to 8 of 40 layers: 54.6 GB of bf16
# weights on one 80 GB card (all 40 layers hold 264 GB: four cards and
# expert parallelism). The paged phase's traffic, exact-length prefill.
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 8
MOE_SERVE = dict(slots=4, max_len=2048, decode_chunk=8)
MOE_ORACLE_REQUESTS = 4     # = slots: every decode batch fully live
# hymba-1.5b at full width and depth (32 layers, 1.64 G parameters): the
# paged phase's traffic, dense and paged for its three global layers
HYBRID_ARCH = "hymba-1.5b"
HYBRID_GEMMS_PER_LAYER = len(GEMMS_PER_LAYER)   # the SSM's in/out are einsums


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
    """Every kernel builds at once, one nvcc each."""
    t0 = time.perf_counter()
    libs = (sg._lib, fa._lib, ssd_mod._lib)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name in ("systolic_gemm", "flash_attention", "ssd"):
        info = _build.build_info(name)
        ptxas[name] = {"seconds": info["seconds"], "report": [
            ln.strip() for ln in info["ptxas"].splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]}
    emit("build", seconds=seconds, ptxas=ptxas, torch=torch.__version__,
         cuda=torch.version.cuda, gpu=gpu_name_and_power())


# --------------------------------------------------------------------------
# 2. kernel vs plain
# --------------------------------------------------------------------------

def gemm_inputs(M, K, N, dtype, g, transposed: bool = False):
    """x [M, K] and w [K, N], or w [N, K] when transposed."""
    dev = "cuda"
    w_shape = (N, K) if transposed else (K, N)
    if dtype == torch.int8:
        x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, w_shape, generator=g, device=dev,
                          dtype=torch.int8)
    else:
        # the model's fan-in scale keeps outputs O(1)
        x = torch.randn((M, K), generator=g, device=dev).to(dtype)
        w = (torch.randn(w_shape, generator=g, device=dev)
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


# (M, K, N) at the bf16 mainloops' edges: wgmma one row past a 64-row
# half (65) and a 128-row tile (129), at dbrx's prime M = 1277, with N =
# 1032 (TMA-aligned, not a tile multiple) and K = 4104 (not a multiple of
# 64); at M = 1000, N = K = 4104 (6 split ranges, the last short);
# splitk where the 129 k-steps of K = 4104 do not split evenly (13
# splits of 10, the last of 9), at M = 4 and 29 rows; hymba-1.5b's
# untied head, N = 32001 (not a multiple of 8: wmma), at decode and at a
# prefill-sized M
KERNEL_EDGES = [(65, 1024, 1032), (129, 4104, 4096), (1277, 4104, 1032),
                (1000, 4104, 4104), (4, 4104, 4096), (29, 4104, 1032),
                (4, 1600, 32001), (1024, 1600, 32001)]
# where the split-K controls must fail, (M, K, N) at decode: NN at
# granite-8b's q and head; NT at mamba2's head (one split) and where 129
# k-steps split 13 ways, the last range short
SPLITK_CONTROL_SHAPES = {"nn": [(4, 4096, 4096), (4, 4096, 49152)],
                         "nt": [(4, 1024, 50280), (4, 4104, 1032)]}


def phase_kernel() -> None:
    """A ragged small case, granite-8b's shapes, and dbrx-132b's q/o, k/v
    and untied head at decode (M = 4 lanes) and at its longest served
    exact-length prefill (M = 1277 rows, a prime); the mainloop edges of
    KERNEL_EDGES; then the split-K controls and the row checks of every
    form."""
    gemm_phase("kernel", sg.systolic_gemm_cuda, systolic_gemm_ref,
               [(37, 100, 130), (1, 4096, 14336), (5, 4096, 49152),
                (4, 6144, 6144), (4, 6144, 1024), (4, 6144, 100352),
                (1277, 6144, 6144), (1277, 6144, 1024),
                (1277, 6144, 100352)] + KERNEL_EDGES,
               transposed=False, seed=1)
    splitk_controls("nn", seed=14)
    rows_independent_of_m(seed=15)


def last_split_dropped(x, w, splits: int) -> torch.Tensor:
    """Planted control: the splitk mainloop's partials summed in split
    order, the last split's left out (a reduction that misses one
    arrival)."""
    parts = splitk_partials(x, w, splits)[:-1]
    acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    for p in parts:
        acc = acc + p
    return acc


def stale_w_tile(x, w, k_step: int) -> torch.Tensor:
    """Planted control: k-step i's products taken with k-step i - 1's w
    tile (a ring slot read before its load landed); step 0 keeps its own."""
    shifted = torch.cat([w[:k_step], w[:-k_step]])
    with no_tf32():
        return x.float() @ shifted.float()


# (form, G, K, N, rows M of x, the largest first): granite-8b's q and
# dbrx-132b's k projections (NN: wgmma at 256 and 65, splitk at 57, 4
# and 1), mamba2-370m's tied head (NT, the same), dbrx's up projection
# over its 16 experts (grouped: wgmma at every M, its ragged capacities)
ROW_CHECK_MS = (256, 65, 57, 4, 1)
ROW_CHECKS = [("nn", 1, 4096, 4096, ROW_CHECK_MS),
              ("nn", 1, 6144, 1024, ROW_CHECK_MS),
              ("nt", 1, 1024, 50280, ROW_CHECK_MS),
              ("grouped", 16, 6144, 10752, (399, 320, 129, 65))]
KERNELS = {"nn": sg.systolic_gemm_cuda, "nt": sg.systolic_gemm_nt_cuda,
           "grouped": sg.grouped_systolic_gemm_cuda}


def rows_independent_of_m(seed: int) -> None:
    """A row's result must not depend on M, across mainloops: the first M
    rows of x (of every group) give bit-equal outputs, as the engine
    (bucketed prefill, M = 4 x bucket; decode, M = 4) and the per-token
    oracle (M = S; M = 1) need, and as dbrx's experts see capacities that
    change with the prompt."""
    g = torch.Generator("cuda").manual_seed(seed)
    rows, failures = [], []
    for form, G, K, N, Ms in ROW_CHECKS:
        kernel = KERNELS[form]
        if form == "grouped":
            x, w = grouped_inputs(G, max(Ms), K, N, torch.bfloat16, g)
        else:
            x, w = gemm_inputs(max(Ms), K, N, torch.bfloat16, g,
                               transposed=form == "nt")
        for out_dtype in (torch.float32, torch.bfloat16):
            full = kernel(x, w, out_dtype=out_dtype)
            for M in Ms[1:]:
                part = kernel(x[..., :M, :].contiguous(), w,
                              out_dtype=out_dtype)
                torch.cuda.synchronize()
                row = {"form": form, "G": G, "K": K, "N": N, "M": M,
                       "out": str(out_dtype)[6:],
                       "mainloops": [sg.gemm_plan(form, m, N, K,
                                                  torch.bfloat16,
                                                  True).mainloop
                                     for m in (max(Ms), M)],
                       "bit_equal": torch.equal(part, full[..., :M, :])}
                if not row["bit_equal"]:
                    failures.append(f"rows depend on M: {row}")
                rows.append(row)
            del full
        del x, w
    emit("kernel_rows", rows=rows, failures=failures)
    check(not failures, f"{len(failures)} row-independence checks failed")


def splitk_controls(form: str, seed: int) -> None:
    """At SPLITK_CONTROL_SHAPES[form] (bf16, both output types): the
    kernel within tolerance, both split-K controls outside it (NT's w
    [N, K] planted through its [K, N] view)."""
    g = torch.Generator("cuda").manual_seed(seed)
    nt = form == "nt"
    kernel, plain = ((sg.systolic_gemm_nt_cuda, systolic_gemm_t_ref) if nt
                     else (sg.systolic_gemm_cuda, systolic_gemm_ref))
    rows, failures = [], []
    for (M, K, N) in SPLITK_CONTROL_SHAPES[form]:
        x, w = gemm_inputs(M, K, N, torch.bfloat16, g, transposed=nt)
        wkn = w.t() if nt else w
        plan = sg.gemm_plan(form, M, N, K, torch.bfloat16, True)
        planted = {"last_split_dropped": last_split_dropped(x, wkn,
                                                            plan.splits),
                   "stale_w_tile": stale_w_tile(x, wkn, sg.SPLITK_K_STEP)}
        for out_dtype in (torch.float32, torch.bfloat16):
            tol = tolerance(torch.bfloat16, out_dtype, None)
            got = kernel(x, w, out_dtype=out_dtype)
            ref = plain(x, w, out_dtype=out_dtype)
            torch.cuda.synchronize()
            row = {"form": form, "shape": [M, K, N], "plan": list(plan),
                   "out": str(out_dtype)[6:], "kernel": tol.excess(got, ref)}
            if not row["kernel"] <= 1.0:
                failures.append(f"kernel disagrees with plain {row}")
            for name, acc in planted.items():
                row[name] = tol.excess(epilogue_ref(acc).to(out_dtype), ref)
                if not row[name] > 1.0:
                    failures.append(f"{name} control passes {row}")
            rows.append(row)
    emit("kernel_controls" if form == "nn" else f"{form}_controls",
         rows=rows, failures=failures)
    check(not failures, f"{len(failures)} {form} split-K control checks "
                        f"failed")


# (M, K, N) of the NT form at mamba2's head (K 1024, N 50280: a 104-column
# tail past the last 128-wide tile): wgmma one row past a 64-row half (65)
# and a 128-row tile (129), at 300 and at 1277 (prime); splitk at 4 and
# 29 rows. Where the 129 k-steps of K = 4104 split 13 ways (the last
# range short): splitk at 29 rows, wgmma at 1277.
NT_EDGES = [(65, 1024, 50280), (129, 1024, 50280), (300, 1024, 50280),
            (1277, 1024, 50280), (29, 1024, 50280), (29, 4104, 1032),
            (1277, 4104, 1032)]


def phase_gemm_nt() -> None:
    """mamba2's tied head at decode, [4, 1024] x [50280, 1024]^T, a ragged
    prefill-sized M with a ragged K (wmma), the mainloop edges of
    NT_EDGES; then the NT split-K controls."""
    gemm_phase("gemm_nt", sg.systolic_gemm_nt_cuda, systolic_gemm_t_ref,
               [(37, 100, 130), (4, 1024, 50280), (300, 1000, 50280)]
               + NT_EDGES, transposed=True, seed=5)
    splitk_controls("nt", seed=16)


def gemm_phase(phase: str, kernel, plain, shapes, *, transposed: bool,
               seed: int) -> None:
    """Every case is read before any verdict, so one failing run shows
    all of them. `excess` is max |got - ref| / (atol + rtol |ref|): the
    kernel must stay at or below 1, the bf16-summing control above it."""
    g = torch.Generator("cuda").manual_seed(seed)
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    control: dict[str, dict] = {}
    mainloops = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for (M, K, N) in shapes:
            x, w = gemm_inputs(M, K, N, dtype, g, transposed)
            plan = sg.gemm_plan("nt" if transposed else "nn", M, N, K, dtype,
                                True)
            mainloops[f"{str(dtype)[6:]} {M}x{K}x{N}"] = list(plan)
            scale = torch.rand(N, generator=g, device="cuda") + 0.5
            bias = torch.randn(N, generator=g, device="cuda")
            for act in sg.ACTIVATIONS:
                for out_dtype in (torch.float32, torch.bfloat16):
                    # the epilogue with and without scale/bias
                    sb = (scale, bias) if act is not None else (None, None)
                    got = kernel(x, w, *sb, activation=act,
                                 out_dtype=out_dtype)
                    ref = plain(x, w, *sb, activation=act,
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
                        planted = bf16_summed(
                            x, w.t() if transposed else w).to(out_dtype)
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
    emit(phase, cases=cases, worst=worst, control=control,
         tolerances={k: [t.rtol, t.atol] for k, t in TOLERANCES.items()
                     if k.startswith("gemm")}, mainloops=mainloops,
         failures=failures)
    check(not failures, f"{len(failures)} {phase} checks failed")


# --------------------------------------------------------------------------
# 3. flash attention vs plain
# --------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, kv_len
    # the six cases of tests/test_kernels.py
    (2, 64, 64, 4, 2, 32, True, None, None),
    (1, 100, 100, 8, 8, 16, True, None, None),
    (2, 33, 33, 4, 1, 64, False, None, None),
    (1, 128, 128, 5, 5, 32, True, 48, None),
    (1, 256, 256, 16, 2, 64, True, None, None),
    (1, 80, 80, 6, 3, 128, True, 16, None),
    # granite-8b's heads, at a tile multiple and ragged
    (2, 256, 256, 32, 8, 128, True, None, None),
    (2, 333, 333, 32, 8, 128, True, None, None),
    # Sq != Skv (positions from 0 on both), a kv_len tail, D = 192
    (2, 300, 200, 8, 2, 64, True, None, None),
    (2, 100, 300, 8, 2, 64, False, None, 250),
    (1, 200, 200, 8, 8, 192, True, None, None),
    # dbrx-132b's exact-length prefills: 48 q heads over 8 KV heads (6 per
    # group), D 128, its longest (prime) and shortest served prompts
    (1, 1277, 1277, 48, 8, 128, True, None, None),
    (1, 29, 29, 48, 8, 128, True, None, None),
    # the wgmma mainloop's edges (128-row q tiles, 128-key tiles): S below,
    # at and just past a tile; Sq != Skv with a kv_len tail inside a key
    # tile and on a tile edge; a window across two key tiles; B > 1 with
    # ragged S (a tile that reaches past S must not read the next batch)
    (1, 127, 127, 8, 2, 128, True, None, None),
    (1, 128, 128, 8, 2, 128, True, None, None),
    (1, 129, 129, 8, 2, 128, True, None, None),
    (2, 129, 257, 8, 2, 128, True, None, 200),
    (2, 300, 384, 8, 2, 128, False, None, 256),
    (1, 512, 512, 8, 2, 128, True, 200, None),
    (2, 384, 384, 4, 4, 64, True, 130, None),
    (3, 200, 200, 8, 2, 128, True, None, None),
    (3, 150, 150, 4, 2, 64, False, None, None),
    # hymba-1.5b's heads (25 q heads over 5, D 64): its 1024-token window
    # at the largest bucket and its longest prompt (windowed layers), and
    # the largest bucket global (its three global layers)
    (4, 2048, 2048, 25, 5, 64, True, 1024, None),
    (1, 1277, 1277, 25, 5, 64, True, 1024, None),
    (4, 2048, 2048, 25, 5, 64, True, None, None),
]


def pv_summed_in_bf16(q, k, v, block_k: int) -> torch.Tensor:
    """Planted control: flash_attention_tiled_ref (causal) with its PV
    accumulator rounded to bf16 after every KV tile, as a kernel that sums
    PV in bf16 would. Its error grows with the tiles a row has seen."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qs = (q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype,
                           device=q.device)).float()
    qs = qs.reshape(B, S, Hkv, Hq // Hkv, D)
    q_pos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hkv, Hq // Hkv, S, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, Hq // Hkv, S, D), device=q.device)
    with no_tf32():
        for k0 in range(0, S, block_k):
            k_pos = k0 + torch.arange(min(block_k, S - k0),
                                      device=q.device)[None, :]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs,
                             k[:, k0:k0 + block_k].float())
            s = torch.where(k_pos <= q_pos, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = (acc * corr + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                v[:, k0:k0 + block_k].float())).to(torch.bfloat16).float()
            m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def flash_served_shape(g) -> dict:
    """The kernel at granite-8b's served prefill shape, [4, 2048, 32, 128]
    bf16 causal, on randn inputs, against the Pallas kernel's arithmetic
    (flash_bf16_tiled_served) and the naive version (flash_bf16). Two
    controls err on late KV tiles only, which a causal row sees among ~1000
    others: the last K tile read stale (the one before it, as a cp.async
    race would leave it) and PV summed in bf16. Both must fail
    flash_bf16_tiled_served; their excess at flash_bf16 is reported, and
    the tiled version's own against its scores summed in f64 (the floor
    that two right kernels share) at flash_bf16_tiled and the served
    tolerance."""
    B, S, Hq, Hkv, D = 4, 2048, 32, 8, 128
    bk = fa.flash_plan(D, torch.bfloat16).block_k
    q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    tiled = flash_attention_tiled_ref(q, k, v, causal=True, block_k=bk)
    naive = flash_attention_ref(q, k, v, causal=True)
    stale = k.clone()
    stale[:, S - bk:] = k[:, S - 2 * bk:S - bk]
    controls = {
        "stale_last_k_tile": flash_attention_tiled_ref(q, stale, v,
                                                       causal=True,
                                                       block_k=bk),
        "pv_summed_in_bf16": pv_summed_in_bf16(q, k, v, bk)}
    other_order = flash_attention_tiled_ref(q, k, v, causal=True,
                                            block_k=bk,
                                            score_dtype=torch.float64)
    tight, loose = (TOLERANCES["flash_bf16_tiled_served"],
                    TOLERANCES["flash_bf16"])
    one_ulp = TOLERANCES["flash_bf16_tiled"]
    out = {"shape": [B, S, Hq, D],
           "excess_vs_tiled": tight.excess(got, tiled),
           "excess_vs_tiled_at_flash_bf16_tiled": one_ulp.excess(got, tiled),
           "plain_vs_itself_f64_scores": {
               "at_flash_bf16_tiled": one_ulp.excess(tiled, other_order),
               "at_flash_bf16_tiled_served": tight.excess(tiled,
                                                          other_order)},
           "excess_vs_naive": loose.excess(got, naive),
           "max_abs_err_vs_tiled": float((got.double() - tiled.double())
                                         .abs().max()),
           "controls": {n: {"excess_vs_tiled": tight.excess(c, tiled),
                            "excess_at_flash_bf16": loose.excess(c, naive)}
                        for n, c in controls.items()}}
    return out


def flash_rows_alone_and_bucketed(g) -> list[dict]:
    """A prompt's rows prefilled alone ([1, S], as the exact-length engine
    and the oracle do) and in lane 2 of a [4, 2S] bucket beside other
    lanes (as the bucketed engine does) must be bit-equal: the key tile
    comes from D alone, and a row's arithmetic from its own q row and
    keys. At granite-8b's heads (32 over 8) and dbrx-132b's (48 over 8),
    D 128, causal."""
    out = []
    for S, Hq, Hkv in ((957, 32, 8), (1277, 48, 8)):
        q, k, v = (torch.randn((SLOTS, 2 * S, h, 128), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        alone = fa.flash_attention_cuda(
            *(x[2:3, :S].contiguous() for x in (q, k, v)), causal=True)
        bucket = fa.flash_attention_cuda(q, k, v, causal=True)[2:3, :S]
        out.append({"S": S, "bucket": [SLOTS, 2 * S], "Hq": Hq, "Hkv": Hkv,
                    "mainloop": fa.flash_plan(128, q.dtype).mainloop,
                    "equal": bool(torch.equal(alone, bucket)),
                    "max_abs_diff": float((alone.float() - bucket.float())
                                          .abs().max())})
    return out


def plain_masked(q, k, v, ok, kv_head):
    """The plain version's arithmetic with a given [Sq, Skv] mask and
    q-head -> kv-head map; the planted controls take a wrong one of each."""
    qs = q * torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype,
                          device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k[:, :, kv_head]).float()
    p = torch.softmax(torch.where(ok, s, -1e30), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v[:, :, kv_head]).to(q.dtype)


def phase_flash() -> None:
    """Every case is read before any verdict. The kernel's `excess` must
    stay at or below 1 in each class; each control's must exceed 1 in every
    case where it differs from the right mask (causal cases for the
    off-by-one mask, G > 1 and Hkv > 1 for the head map) and, at the served
    shape, on late tiles."""
    g = torch.Generator("cuda").manual_seed(3)
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    control: dict[str, dict] = {}
    by_mainloop: dict[str, int] = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOLERANCES["flash_f32" if dtype == torch.float32
                         else "flash_bf16"]
        cls = str(dtype)[6:]
        for (B, Sq, Skv, Hq, Hkv, D, causal, window, kv_len) in FLASH_CASES:
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                       for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                 (B, Skv, Hkv, D)))
            plan = fa.flash_plan(D, dtype)
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, kv_len=kv_len)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len)
            torch.cuda.synchronize()
            err = float((got.double() - ref.double()).abs().max())
            excess = tol.excess(got, ref)
            row = worst.setdefault(cls, {"max_abs_err": 0.0, "excess": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["excess"] = max(row["excess"], excess)
            by_mainloop[plan.mainloop] = by_mainloop.get(plan.mainloop, 0) + 1
            case = (f"{cls} q{(B, Sq, Hq, D)} kv{(Skv, Hkv)} causal={causal} "
                    f"window={window} kv_len={kv_len} {plan} "
                    f"max_abs_err={err} excess={excess} ({tol})")
            if not bool(torch.isfinite(got.float()).all()):
                failures.append("non-finite kernel output " + case)
            elif not excess <= 1.0:
                failures.append("kernel disagrees with plain " + case)
            if dtype == torch.bfloat16:
                tiled = flash_attention_tiled_ref(
                    q, k, v, causal=causal, window=window, kv_len=kv_len,
                    block_k=plan.block_k)
                te = TOLERANCES["flash_bf16_tiled_served"].excess(got,
                                                                  tiled)
                row = worst.setdefault(f"bfloat16 {plan.mainloop} vs tiled",
                                       {"excess": 0.0})
                row["excess"] = max(row["excess"], te)
                if not te <= 1.0:
                    failures.append(f"kernel disagrees with tiled plain "
                                    f"{case} excess_vs_tiled={te}")
            # planted controls, on the same inputs
            qp = torch.arange(Sq, device="cuda")[:, None]
            kp = torch.arange(Skv, device="cuda")[None, :]
            ok = kp < (Skv if kv_len is None else kv_len)
            if window is not None:
                ok = ok & (qp - kp < window)
            heads = torch.arange(Hq, device="cuda")
            planted = {}
            if causal:
                planted["causal_off_by_one"] = plain_masked(
                    q, k, v, ok & (kp < qp), heads // (Hq // Hkv))
            if Hq // Hkv > 1 and Hkv > 1:
                planted["gqa_h_mod_hkv"] = plain_masked(
                    q, k, v, ok & (kp <= qp) if causal else ok, heads % Hkv)
            for name, out in planted.items():
                c = tol.excess(out, ref)
                row = control.setdefault(f"{name} {cls}", {"min_excess": c})
                row["min_excess"] = min(row["min_excess"], c)
                if not c > 1.0:
                    failures.append(f"control {name} passes: {case} "
                                    f"control excess={c}")
            cases += 1
    served = flash_served_shape(g)
    if not served["excess_vs_tiled"] <= 1.0 or \
            not served["excess_vs_naive"] <= 1.0:
        failures.append(f"kernel disagrees at the served shape {served}")
    for name, c in served["controls"].items():
        if not c["excess_vs_tiled"] > 1.0:
            failures.append(f"late-tile control {name} passes "
                            f"flash_bf16_tiled_served: {c}")
    rows = flash_rows_alone_and_bucketed(g)
    failures += [f"rows differ alone and in a bucket: {r}" for r in rows
                 if not r["equal"]]
    emit("flash", cases=cases + 1, by_mainloop=by_mainloop, worst=worst,
         control=control, served_shape=served, rows_alone_vs_bucket=rows,
         tolerances={k: [t.rtol, t.atol] for k, t in TOLERANCES.items()
                     if k.startswith("flash")}, failures=failures)
    check(not failures, f"{len(failures)} flash checks failed")


# --------------------------------------------------------------------------
# 5. ssd vs plain
# --------------------------------------------------------------------------

# the long-chunk-decay case: mamba2's tiles at chunk 256 with dt and A as
# Mamba-2 initialises them (ssd_inputs, "mamba2_init"), where the state
# carried across a whole chunk survives in the slow heads
SSD_DECAY = (SLOTS, 1024, 32, 64, 1, 128, 256)
# hymba-1.5b's largest prefill: 50 heads of P 64, N 16, chunk 256 (serial)
SSD_HYBRID = (SLOTS, 2048, 50, 64, 1, 16, 256)
SSD_CASES = [
    # b, S, H, P, G, N, chunk, dt law: the four of tests/test_kernels.py
    (2, 64, 4, 16, 1, 32, 16, "softplus"),
    (1, 100, 2, 8, 2, 16, 32, "softplus"),
    (1, 32, 4, 16, 4, 8, 32, "softplus"),
    (2, 48, 8, 32, 1, 64, 16, "softplus"),
    # mamba2-370m's heads: a ragged S, and G > 1
    (2, 1000, 32, 64, 1, 128, 256, "softplus"),
    (2, 512, 32, 64, 4, 128, 256, "softplus"),
    SSD_DECAY + ("mamba2_init",),
    # hymba's, with the served model's dt and with Mamba-2's (where slow
    # heads carry their state across whole chunks)
    SSD_HYBRID + ("softplus",), SSD_HYBRID + ("mamba2_init",),
]
SSD_SERVED = (SLOTS, 2048, 32, 64, 1, 128)   # mamba2's largest prefill
SSD_FAULTS = ("state_not_carried", "mask_after_exp",
              "y_inter_from_updated_state")


def ssd_inputs(shape, dtype, g, device="cuda", dt_law: str = "softplus"):
    """x, B, C randn in dtype; D U(0, 1). dt and A (f32) by `dt_law`:

    * "softplus": dt = softplus(randn) and A = -exp(U(-0.5, 0.5)), as the
      served model's init gives them (dt ~ 0.8, A ~ -1): the exponent
      above a 256-token chunk's diagonal overflows f32, and exp(cum_end)
      of a whole chunk underflows to 0, so no state survives a chunk;
    * "mamba2_init": as Mamba-2's reference implementation initialises
      them by default (arXiv:2405.21060: A = -U(1, 16) per head, dt
      log-uniform in [0.001, 0.1] per head), with a per-token jitter
      exp(N(0, 1/16)) kept in that range. Slow heads (dt |A| well below 0.34) keep exp(cum_end) above 0
      and carry their state across whole chunks; fast ones overflow the
      masked exponent, as "softplus" does."""
    b, S, H, P, G, N = shape
    x = torch.randn((b, S, H, P), generator=g, device=device).to(dtype)
    if dt_law == "softplus":
        dt = F.softplus(torch.randn((b, S, H), generator=g, device=device))
        A = -torch.exp(torch.rand(H, generator=g, device=device) - 0.5)
    elif dt_law == "mamba2_init":
        lo, hi = math.log(1e-3), math.log(1e-1)
        rate = torch.exp(lo + (hi - lo) * torch.rand(
            (b, 1, H), generator=g, device=device))
        jitter = torch.exp(0.25 * torch.randn((b, S, H), generator=g,
                                              device=device))
        dt = (rate * jitter).clamp(1e-3, 1e-1)
        A = -(1 + 15 * torch.rand(H, generator=g, device=device))
    else:
        raise ValueError(f"unknown dt law {dt_law!r}")
    B = torch.randn((b, S, G, N), generator=g, device=device).to(dtype)
    C = torch.randn((b, S, G, N), generator=g, device=device).to(dtype)
    D = torch.rand(H, generator=g, device=device)
    return x, dt, A, B, C, D


def ssd_planted(x, dt, A, B, C, D, *, chunk: int, fault):
    """ssd_kernel_ref's arithmetic (the Pallas kernel's) with one planted
    fault of SSD_FAULTS, or none: the state reset at every chunk; the mask
    applied after exp (exp(seg) * 0 is NaN where exp overflows); y_inter
    taken from the state after this chunk's update instead of h_prev.
    Fault "state_in_bf16" rounds the state and y_inter to x's dtype, as
    ssd_ref does, and nothing else: a control at the served shape only
    (its excess is a max over rows, and a smaller input can pass)."""
    b, S, H, P = x.shape
    pad = (-S) % chunk
    x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt.float(), (0, 0, 0, pad))
    rep = H // B.shape[2]
    Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)).repeat_interleave(rep, dim=2)
              .float() for t in (B, C))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    h = torch.zeros((b, H, P, Bh.shape[-1]), device=x.device)
    ys = []
    with no_tf32():
        for c0 in range(0, x.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            xf, dtc, Bc, Cc = x[:, sl].float(), dt[:, sl], Bh[:, sl], Ch[:, sl]
            if fault == "state_not_carried":
                h = torch.zeros_like(h)
            cum = torch.cumsum(dtc * A.float(), dim=1)
            seg = cum[:, :, None, :] - cum[:, None, :, :]
            if fault == "mask_after_exp":
                decay = torch.exp(seg) * tri
            else:
                decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)),
                                    0.0)
            M = torch.einsum("bthn,bshn->btsh", Cc, Bc) * decay * \
                dtc[:, None, :, :]
            y = torch.einsum("btsh,bshp->bthp", M.to(x.dtype).float(), xf)
            w = torch.exp(cum[:, -1:, :] - cum) * dtc
            h_new = torch.exp(cum[:, -1, :])[..., None, None] * h + \
                torch.einsum("bshp,bshn->bhpn", xf * w[..., None], Bc)
            if fault == "state_in_bf16":
                h_new = h_new.to(x.dtype).float()
            h_read = h_new if fault == "y_inter_from_updated_state" else h
            y_inter = torch.exp(cum)[..., None] * torch.einsum(
                "bthn,bhpn->bthp", Cc, h_read)
            if fault == "state_in_bf16":
                y_inter = y_inter.to(x.dtype).float()
            y = y + y_inter
            h = h_new
            ys.append((y + D.float()[None, None, :, None] * xf).to(x.dtype))
    return torch.cat(ys, dim=1)[:, :S], h.to(x.dtype)


def ssd_f32_tol(chunk: int):
    """f32 at mamba2-sized chunks sums terms far larger than y's small
    entries: ssd_f32_rows there (its reason), ssd_f32 below."""
    return TOLERANCES["ssd_f32_rows" if chunk >= 128 else "ssd_f32"]


def phase_ssd() -> None:
    """Every case is read before any verdict. The kernel must stay within
    ssd_f32 / ssd_bf16_kernel of ssd_kernel_ref (y and the final state)
    and within ssd_bf16_reference of ssd_ref; at the served shape each
    planted control must exceed ssd_bf16_kernel."""
    g = torch.Generator("cuda").manual_seed(7)
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    mainloops: dict[str, str] = {}
    tight_bf16, loose = (TOLERANCES["ssd_bf16_kernel"],
                         TOLERANCES["ssd_bf16_reference"])
    for dtype in (torch.float32, torch.bfloat16):
        cls = str(dtype)[6:]
        for (b, S, H, P, G, N, chunk, law) in SSD_CASES:
            x, dt, A, B, C, D = ssd_inputs((b, S, H, P, G, N), dtype, g,
                                           dt_law=law)
            plan = ssd_mod.ssd_plan(P, N, chunk, dtype)
            before = dict(ssd_mod.ssd_cuda.mainloop_launches)
            got = ssd_ops.ssd(x, dt, A, B, C, D, chunk=chunk)
            ran = [m for m, n in ssd_mod.ssd_cuda.mainloop_launches.items()
                   if n != before[m]]
            mainloops[f"{cls} {(b, S, H, P, G, N, chunk)} {law}"] = plan
            if ran != [plan]:
                failures.append(f"{cls} {(b, S, H, P, G, N, chunk)} {law} "
                                f"ran {ran}, its plan is {plan}")
            # the plain version at the chunk the kernel runs (in f32 at
            # mamba2's tiles: 128-token sub-chunks of the 256 asked for)
            ref = ssd_kernel_ref(x, dt, A, B, C, D, chunk=ssd_mod.run_chunk(
                chunk, P, N, dtype))
            refs = {"kernel_ref": (ref, ssd_f32_tol(chunk)
                                   if dtype == torch.float32 else tight_bf16)}
            if dtype == torch.bfloat16:
                refs["ssd_ref"] = (ssd_ref(x, dt, A, B, C, D, chunk), loose)
            torch.cuda.synchronize()
            for rname, ((ry, rh), tol) in refs.items():
                for out, r, got_t in (("y", ry, got[0]), ("h", rh, got[1])):
                    excess = tol.excess(got_t.float(), r.float())
                    row = worst.setdefault(f"{cls} {out} vs {rname}",
                                           {"excess": 0.0, "max_abs_err": 0.0})
                    row["excess"] = max(row["excess"], excess)
                    row["max_abs_err"] = max(row["max_abs_err"], float(
                        (got_t.double() - r.double()).abs().max()))
                    if not bool(torch.isfinite(got_t.float()).all()) or \
                            not excess <= 1.0:
                        failures.append(f"{cls} {(b, S, H, P, G, N, chunk)} "
                                        f"{law} {out} vs {rname}: excess "
                                        f"{excess}")
            cases += 1
    # mamba2's served prefill in f32: the kernel runs 128-token sub-chunks
    # and is held to the plain version at that chunk; beside it, how far
    # the plain version at 128 and at 256 drift apart in f32 (reported)
    args = ssd_inputs(SSD_SERVED, torch.float32, g)
    sub = ssd_mod.run_chunk(256, SSD_SERVED[3], SSD_SERVED[5], torch.float32)
    got = ssd_ops.ssd(*args, chunk=256)
    ref = ssd_kernel_ref(*args, chunk=sub)
    whole = ssd_kernel_ref(*args, chunk=256)
    torch.cuda.synchronize()
    tol = ssd_f32_tol(256)
    f32_served = {"run_chunk": sub, "tolerance": str(tol), "controls": {}}
    for out, i in (("y", 0), ("h", 1)):
        excess = tol.excess(got[i], ref[i])
        f32_served[out] = {
            "excess": excess, "max_abs_err": float(
                (got[i].double() - ref[i].double()).abs().max()),
            "plain_sub_vs_whole_chunk": tol.excess(ref[i], whole[i]),
            "excess_at_ssd_f32": TOLERANCES["ssd_f32"].excess(got[i], ref[i])}
        if not bool(torch.isfinite(got[i]).all()) or not excess <= 1.0:
            failures.append(f"float32 served {SSD_SERVED} {out}: excess "
                            f"{excess}")
    for fault in ("state_not_carried", "y_inter_from_updated_state"):
        py, _ = ssd_planted(*args, chunk=sub, fault=fault)
        f32_served["controls"][fault] = e = tol.excess(py, ref[0])
        if not e > 1.0:
            failures.append(f"f32 control {fault} passes {tol}: {e}")
    cases += 1
    del args, got, ref, whole
    served = ssd_controls(g, SSD_SERVED, "softplus")
    decay = ssd_controls(g, SSD_DECAY[:6], "mamba2_init")
    for label, case in (("served shape", served), ("decay case", decay)):
        for name, e in case["excess"].items():
            if not e <= 1.0:
                failures.append(f"{label} {name}: excess {e}")
        if case["mainloop"] != "chunked":
            failures.append(f"{label} ran {case['mainloop']}")
        for fault, e in case["controls"].items():
            # a control fails when y or h does; NaN (mask after exp) fails
            if all(v <= 1.0 for v in e.values()):
                failures.append(f"{label}: control {fault} passes "
                                f"ssd_bf16_kernel: {e}")
    # where exp(cum_end) stays above 0, cum carried across chunk
    # boundaries breaks the carried state itself, not only y_inter
    if not decay["controls"]["cum_across_chunks"]["h"] > 1.0:
        failures.append(f"decay case: cum_across_chunks passes on h: "
                        f"{decay['controls']['cum_across_chunks']}")
    same = ssd_rows_and_strides(g)
    failures += [f"{k} not bit-equal: {v}" for k, v in same.items()
                 if not all(v.values())]
    emit("ssd", cases=cases + 2, mainloop_by_case=mainloops, worst=worst,
         served_shape=served, decay_case=decay, bit_equal=same,
         f32_served_shape=f32_served,
         tolerances={k: [t.rtol, t.atol] for k, t in TOLERANCES.items()
                     if k.startswith("ssd")}, failures=failures)
    check(not failures, f"{len(failures)} ssd checks failed")


def ssd_controls(g, shape, dt_law: str) -> dict:
    """The kernel at mamba2's tiles (N = 128, chunk 256, bf16) on inputs
    of `shape` drawn by `dt_law`, against both plain versions, and the
    planted controls against ssd_kernel_ref. Two controls are ssd_ref
    itself and the state and y_inter rounded to bf16: neither may pass
    for the kernel's f32 state. The last two plant faults of the chunked
    mainloop's order (CHUNKED_FAULTS). At the served shape ("softplus")
    every control is gated; at the long-chunk-decay case ("mamba2_init")
    all but the bf16 state, which a small state can pass (ssd_planted):
    it is reported there, with the share of chunks whose exp(cum_end)
    stays above 0 and above 1e-3."""
    args = ssd_inputs(shape, torch.bfloat16, g, dt_law=dt_law)
    before = ssd_mod.ssd_cuda.mainloop_launches["chunked"]
    y, h = ssd_ops.ssd(*args, chunk=256)
    ran_chunked = ssd_mod.ssd_cuda.mainloop_launches["chunked"] == before + 1
    ky, kh = ssd_kernel_ref(*args, chunk=256)
    ry, rh = ssd_ref(*args, 256)
    # the noise floor: the same plain version on the CPU, whose f32 sums
    # (another order) round some M entries to bf16 the other way
    cy, ch = ssd_kernel_ref(*(t.cpu() for t in args), chunk=256)
    tight, loose = (TOLERANCES["ssd_bf16_kernel"],
                    TOLERANCES["ssd_bf16_reference"])
    b, S, H = shape[:3]
    cum_end = (args[1].reshape(b, S // 256, 256, H) * args[2]).sum(2)
    out = {"shape": list(shape) + [256], "dt_law": dt_law,
           "exp_cum_end_share": {
               "above_0": float((torch.exp(cum_end) > 0).float().mean()),
               "above_1e-3": float((torch.exp(cum_end) > 1e-3).float()
                                   .mean())},
           "mainloop": "chunked" if ran_chunked else "not chunked",
           "excess": {"y_vs_kernel_ref": tight.excess(y, ky),
                      "h_vs_kernel_ref": tight.excess(h, kh),
                      "y_vs_ssd_ref": loose.excess(y, ry),
                      "h_vs_ssd_ref": loose.excess(h, rh)},
           "max_abs_err_vs_kernel_ref": float((y.double() - ky.double())
                                              .abs().max()),
           "plain_card_vs_cpu": {"y": tight.excess(ky.cpu(), cy),
                                 "h": tight.excess(kh.cpu(), ch)},
           "controls": {}}
    for fault in SSD_FAULTS:
        py, ph = ssd_planted(*args, chunk=256, fault=fault)
        out["controls"][fault] = {"y": tight.excess(py, ky),
                                  "h": tight.excess(ph, kh)}
    out["controls"]["bf16_state_ssd_ref"] = {"y": tight.excess(ry, ky),
                                             "h": tight.excess(rh, kh)}
    # ssd_ref also rounds M x before D x cancels it: where it fails, and
    # the bf16 state and y_inter without that rounding
    out["bf16_state_ssd_ref_worst_y_row"] = worst_row(ry, ky, tight, 256)
    py, ph = ssd_planted(*args, chunk=256, fault="state_in_bf16")
    bf16_state = {"y": tight.excess(py, ky), "h": tight.excess(ph, kh)}
    if dt_law == "softplus":
        out["controls"]["state_in_bf16"] = bf16_state
    else:
        out["reported_controls"] = {"state_in_bf16": bf16_state}
    # the chunked mainloop's own order: the state pass without its decay,
    # cum carried across chunk boundaries
    for fault in CHUNKED_FAULTS:
        py, ph = ssd_chunked_ref(*args, chunk=256, fault=fault)
        out["controls"][fault] = {"y": tight.excess(py, ky),
                                  "h": tight.excess(ph, kh)}
    return out


SSD_PROMPT = 1277       # the longest prompt of the served mamba2 run


def ssd_rows_and_strides(g) -> dict:
    """Bit-equality at mamba2's served shape ([4, 2048, 32, 64], N 128,
    bf16): a prompt of SSD_PROMPT tokens alone as [1, SSD_PROMPT] and as
    lane 2 of a [4, 2048] launch (dt = 0 past it, random x, B and C
    there), y rows and final state; and x, B, C as the strided views
    apply_ssm hands over (split off one [4, 2048, d_inner + 2 N]
    projection) against contiguous copies of them."""
    b, S, H, P, G, N = SSD_SERVED
    x, dt, A, B, C, D = ssd_inputs(SSD_SERVED, torch.bfloat16, g)
    dt[2, SSD_PROMPT:] = 0.0
    y, h = ssd_ops.ssd(x, dt, A, B, C, D, chunk=256)
    xa, dta, Ba, Ca = (t[2:3, :SSD_PROMPT].contiguous()
                       for t in (x, dt, B, C))
    ya, ha = ssd_ops.ssd(xa, dta, A, Ba, Ca, D, chunk=256)
    proj = torch.randn((b, S, H * P + 2 * G * N), generator=g,
                       device="cuda").to(torch.bfloat16)
    xs, Bs, Cs = torch.split(proj, [H * P, G * N, G * N], dim=-1)
    views = (xs.reshape(b, S, H, P), Bs.reshape(b, S, G, N),
             Cs.reshape(b, S, G, N))
    yv, hv = ssd_mod.ssd_cuda(views[0], dt, A, views[1], views[2], D,
                              chunk=256)
    yc, hc = ssd_mod.ssd_cuda(views[0].contiguous(), dt, A,
                              views[1].contiguous(), views[2].contiguous(),
                              D, chunk=256)
    torch.cuda.synchronize()
    return {"alone_vs_bucket": {
                "prompt": SSD_PROMPT,
                "y_rows": torch.equal(y[2:3, :SSD_PROMPT], ya),
                "state": torch.equal(h[2:3], ha)},
            "strided_vs_contiguous": {
                "views_not_contiguous": not views[0].is_contiguous(),
                "y": torch.equal(yv, yc), "state": torch.equal(hv, hc)}}


def worst_row(got, ref, tol, chunk: int) -> dict:
    """The row (last axis) of y [b, S, H, P] where `got` misses `ref` most
    under a RowTol: its position in its chunk and its rms beside the
    median row's, and how many rows miss."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err),
                        err / (tol._atol(ref) + tol.rtol * ref.abs()))
    ratio = ratio.amax(dim=-1)
    rms = ref.square().mean(dim=-1).sqrt()
    i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
    return {"t_in_chunk": int(i[1]) % chunk, "row_rms": float(rms[i]),
            "median_row_rms": float(rms.median()),
            "rows_over_1": int((ratio > 1).sum())}


# --------------------------------------------------------------------------
# 6. grouped pod GEMM vs plain
# --------------------------------------------------------------------------

# G, M, K, N: ragged, decode-like (M = 1); TMA-aligned G > 1 on wgmma at
# ragged M (one row past a 64-row half and a 128-row tile; N not a tile
# multiple, K = 1032 not a stage multiple); and G = 1: ragged (both
# launches on wmma), and TMA-aligned at M = 4 (grouped wmma, NN splitk)
# and 96 (both wgmma)
GROUPED_CASES = [(3, 37, 100, 130), (5, 1, 260, 70), (3, 65, 256, 136),
                 (4, 129, 1032, 264), (1, 33, 64, 65), (1, 4, 512, 136),
                 (1, 96, 256, 136)]
# dbrx-132b's expert GEMMs: decode (M = 1 row per expert), the down
# projection, a 1024-token prefill (8 groups x capacity 40 = 320 rows per
# expert) and the 1277-token prompt (prime: one group of capacity 399),
# up and down
GROUPED_SERVED = [(16, 1, 6144, 10752, "silu"), (16, 1, 10752, 6144, None),
                  (16, 320, 6144, 10752, "silu"), (16, 399, 6144, 10752,
                                                   None),
                  (16, 399, 10752, 6144, None)]


def grouped_inputs(G, M, K, N, dtype, g):
    x, w = zip(*(gemm_inputs(M, K, N, dtype, g) for _ in range(G)))
    return torch.stack(x), torch.stack(w)


def wrong_group_stride(x, w, *args, **kw) -> torch.Tensor:
    """Planted control: group g + 1 reads group g's weights, as a kernel
    whose group stride is one group short would."""
    return grouped_systolic_gemm_ref(x, torch.cat([w[:1], w[:-1]]), *args,
                                     **kw)


def phase_grouped() -> None:
    """Every case is read before any verdict. The kernel's excess must stay
    at or below 1; both controls' must exceed it where they differ from the
    plain version (bf16 sums: every f32/bf16 case without an epilogue; the
    group stride: every case with G > 1). The middle group of each case
    with G > 1 is all zero with a zero bias and must come out exactly 0.
    G = 1 must equal the NN launch bit for bit where both run one mainloop
    (wmma, simt or wgmma: one order of summation)."""
    g = torch.Generator("cuda").manual_seed(11)
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    control: dict[str, float] = {}

    def record(key, got, ref, tol, case):
        err = float((got.double() - ref.double()).abs().max())
        excess = tol.excess(got, ref)
        row = worst.setdefault(key, {"max_abs_err": 0.0, "excess": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["excess"] = max(row["excess"], excess)
        if not bool(torch.isfinite(got.float()).all()):
            failures.append(f"non-finite kernel output {case}")
        elif not excess <= 1.0:
            failures.append(f"kernel disagrees with plain {case} "
                            f"excess={excess} ({tol})")

    def planted(name, c, case):
        control[name] = min(control.get(name, math.inf), c)
        if not c > 1.0:
            failures.append(f"{name} control passes {case} excess={c}")

    mainloops = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for (G, M, K, N) in GROUPED_CASES:
            x, w = grouped_inputs(G, M, K, N, dtype, g)
            plan = sg.gemm_plan("grouped", M, N, K, dtype, True)
            mainloops[f"{str(dtype)[6:]} {G}x{M}x{K}x{N}"] = list(plan)
            scale = torch.rand((G, N), generator=g, device="cuda") + 0.5
            bias = torch.randn((G, N), generator=g, device="cuda")
            if G > 1:                            # an expert with no token
                x[G // 2] = 0
                bias[G // 2] = 0
            for act in sg.ACTIVATIONS:
                for out_dtype in (torch.float32, torch.bfloat16):
                    sb = (scale, bias) if act is not None else (None, None)
                    got = sg.grouped_systolic_gemm_cuda(
                        x, w, *sb, activation=act, out_dtype=out_dtype)
                    ref = grouped_systolic_gemm_ref(
                        x, w, *sb, activation=act, out_dtype=out_dtype)
                    torch.cuda.synchronize()
                    tol = tolerance(dtype, out_dtype, act)
                    key = f"{str(dtype)[6:]}->{str(out_dtype)[6:]}"
                    case = f"{key} {G}x{M}x{K}x{N} act={act}"
                    record(key, got, ref, tol, case)
                    if G > 1 and not bool((got[G // 2] == 0).all()):
                        failures.append(f"empty group not exactly 0 {case}")
                    if G > 1:
                        planted("group_stride", tol.excess(
                            wrong_group_stride(x, w, *sb, activation=act,
                                               out_dtype=out_dtype), ref),
                            case)
                    if act is None and dtype != torch.int8:
                        summed = torch.stack([bf16_summed(x[i], w[i])
                                              for i in range(G)])
                        planted("bf16_summed",
                                tol.excess(summed.to(out_dtype), ref), case)
                    if G == 1:
                        # bit-equal where both launches run one mainloop
                        # (wmma, simt, or wgmma in NN's split ranges); the
                        # NN splitk sums in another order than grouped
                        # wmma, so there within the case's tolerance
                        one = sg.systolic_gemm_cuda(
                            x[0], w[0], *(t if t is None else t[0]
                                          for t in sb),
                            activation=act, out_dtype=out_dtype)
                        nn = sg.nn_plan(M, N, K, dtype, True).mainloop
                        if nn == plan.mainloop:
                            if not torch.equal(got[0], one):
                                failures.append(f"G = 1 differs from the "
                                                f"pod GEMM kernel ({nn}) "
                                                f"{case}")
                        elif not tol.ok(got[0], one):
                            failures.append(f"G = 1 beyond {tol} of the pod "
                                            f"GEMM kernel ({nn}) {case}")
                    cases += 1
    served = []
    for (G, M, K, N, act) in GROUPED_SERVED:
        x, w = grouped_inputs(G, M, K, N, torch.bfloat16, g)
        got = sg.grouped_systolic_gemm_cuda(x, w, activation=act,
                                            out_dtype=torch.bfloat16)
        ref = grouped_systolic_gemm_ref(x, w, activation=act,
                                        out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        tol = TOLERANCES["gemm_bf16out"]
        case = f"served {G}x{M}x{K}x{N} act={act}"
        record("served bf16->bf16", got, ref, tol, case)
        planted("group_stride", tol.excess(wrong_group_stride(
            x, w, activation=act, out_dtype=torch.bfloat16), ref), case)
        if act is None:
            summed = torch.stack([bf16_summed(x[i], w[i]) for i in range(G)])
            planted("bf16_summed", tol.excess(summed.to(torch.bfloat16), ref),
                    case)
        served.append([G, M, K, N, act, list(sg.gemm_plan(
            "grouped", M, N, K, torch.bfloat16, True)), tol.excess(got, ref)])
        cases += 1
        del x, w, got, ref
    emit("grouped", cases=cases, worst=worst, control_min_excess=control,
         served=served, mainloops=mainloops, failures=failures)
    check(not failures, f"{len(failures)} grouped checks failed")


# --------------------------------------------------------------------------
# graphed against eager, in every serve phase
# --------------------------------------------------------------------------

def launch_table() -> dict:
    """Every kernel wrapper's launches and launches by mainloop."""
    return {name: {"launches": fn.launches,
                   "by_mainloop": dict(fn.mainloop_launches)}
            for name, fn in (("pod_gemm", sg.systolic_gemm_cuda),
                             ("gemm_nt", sg.systolic_gemm_nt_cuda),
                             ("grouped", sg.grouped_systolic_gemm_cuda),
                             ("flash", fa.flash_attention_cuda),
                             ("ssd", ssd_mod.ssd_cuda))}


def counted_serve(engine, reqs: list[Request], step_hook=None) -> dict:
    """Serve reqs on `engine` from zeroed launch counts, one step() a
    quantum (step_hook(engine) after each). Returns the wall seconds, the
    counted host syncs, every launch count (launch_table) and every host
    read the engine made: each prefill's first tokens and each packed
    decode chunk, copied."""
    reads = []
    real = engine_mod.to_host

    def recording(t):
        out = real(t)
        reads.append(out.copy())
        return out
    reset_launch_counts()
    syncs0 = HOST_SYNCS.count
    engine_mod.to_host = recording
    try:
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        for _ in range(1000):
            if not engine.queue and not any(engine.active):
                break
            engine.step()
            if step_hook is not None:
                step_hook(engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine_mod.to_host = real
    check(not engine.queue and not any(engine.active),
          "requests still pending after 1000 steps")
    return {"wall_s": wall, "syncs": HOST_SYNCS.count - syncs0,
            "launches": launch_table(), "reads": reads}


def pass_figures(engine, run: dict, reqs: list[Request], st0: dict) -> dict:
    """One pass's serve figures from the engine's stats since `st0`:
    prefill ms per call and decode ms per step over the calls that did not
    warm up and capture (those count in capture_s), tokens/s over the
    pass's whole wall."""
    st = {k: v - st0.get(k, 0) for k, v in engine.stats.items()
          if not isinstance(v, bool)}
    prefills = st["prefill_calls"] - st["capture_prefills"]
    steps = st["decode_steps"] - st["capture_steps"]
    generated = sum(len(r.out) for r in reqs)
    return {"wall_s": run["wall_s"], "tokens_per_s": generated / run["wall_s"],
            "host_syncs": run["syncs"], "prefill_calls": st["prefill_calls"],
            "prefill_ms_per_call": (1e3 * st["prefill_s"] / prefills
                                    if prefills else None),
            "decode_chunks": st["chunks"], "decode_steps": st["decode_steps"],
            "decode_ms_per_step": (1e3 * st["decode_s"] / steps
                                   if steps else None),
            "capture_s": st["capture_s"], "graphs": st["graphs"],
            "captured_prefills": st["capture_prefills"],
            "captured_decode_steps": st["capture_steps"]}


def profile_decode_chunk(engine, vocab: int, label: str) -> dict:
    """One full decode chunk (decode_chunk steps, every slot live) under
    torch.profiler: the device's kernel time summed from the trace over
    the chunk's wall, and idle_share = 1 - that share. A chunk before it
    admits and captures what is new; the chunk after it is timed without
    the profiler (its wall beside the profiled one: the profiler's own
    cost on the host)."""
    from torch.profiler import ProfilerActivity, profile
    n = engine.decode_chunk
    reqs = [Request(rid=10_000 + i, prompt=(np.arange(8) + 3 * i) % vocab,
                    max_new_tokens=3 * n + 1) for i in range(engine.slots)]
    for r in reqs:
        engine.submit(r)
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    engine.run_to_completion()
    check(all(r.done for r in reqs), f"{label}: profiled requests not done")
    path = _build.REPO_ROOT / "build" / "profiles" / f"{label}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    device = {"kernel": [0.0, 0], "gpu_memcpy": [0.0, 0],
              "gpu_memset": [0.0, 0]}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in device:
            device[e["cat"]][0] += float(e.get("dur", 0.0)) / 1e3
            device[e["cat"]][1] += 1
    kernel_ms = device["kernel"][0]
    out = {"steps": n, "wall_ms": 1e3 * wall,
           "unprofiled_wall_ms": 1e3 * unprofiled,
           "kernel_ms": kernel_ms, "kernels": device["kernel"][1],
           "memcpy_ms": device["gpu_memcpy"][0],
           "memset_ms": device["gpu_memset"][0]}
    if device["kernel"][1]:
        out["idle_share"] = 1.0 - kernel_ms / (1e3 * wall)
        out["idle_share_of_unprofiled_wall"] = \
            1.0 - kernel_ms / (1e3 * unprofiled)
    else:
        out["idle_share"] = "not measured (the trace holds no kernel)"
    return out


def cache_tensors(cache: dict) -> list[torch.Tensor]:
    return [getattr(c, f.name) for node in cache.values()
            for c in node.values() for f in dataclasses.fields(c)]


def decode_logits_graphed_vs_eager(model, params, engine) -> dict:
    """One decode step over the engine's cache (as it is after serving),
    eager and as a graph replay from the same state: whether the logits
    are bit-equal (cuBLAS may pick another algorithm under capture, e.g.
    for dbrx's f32 router). The cache is restored afterwards."""
    cache = engine.cache
    tensors = cache_tensors(cache)
    saved = [t.clone() for t in tensors]

    def restore():
        for t, v in zip(tensors, saved):
            t.copy_(v)
    B = engine.slots
    toks = torch.arange(1, B + 1, device="cuda") % model.cfg.vocab
    pos = torch.arange(B, device="cuda") * 97 + 5

    def body(toks, pos):
        return model.decode_step(params, toks, cache, pos)[0]
    eager = body(toks, pos).clone()
    restore()
    runner = StepRunner(body, {"toks": toks, "pos": pos},
                        GraphPool(torch.device("cuda")))
    runner()                                    # warm-up and capture
    restore()
    graphed = runner().clone()
    torch.cuda.synchronize()
    restore()
    return {"bit_equal": torch.equal(eager, graphed),
            "max_abs_diff": float((eager.float() - graphed.float()).abs()
                                  .max()),
            "argmax_equal": torch.equal(eager.argmax(-1),
                                        graphed.argmax(-1))}


def graphed_vs_eager(phase: str, model, params, eng, run: dict,
                     reqs: list[Request], make_requests, engine_kw: dict
                     ) -> dict:
    """The phase's graphed engine `eng` (first pass `run` over `reqs`,
    already gated on today's launch and sync formulas) against an eager
    engine on the same requests, in the same run:

    * gates: equal tokens; every host read (first tokens, packed decode
      chunks) equal bit for bit; equal host syncs; equal launch counts by
      kernel and mainloop; prefill graphs at most max_prefill_compiles,
      decode graphs at most log2(decode_chunk) + 1, none in the eager
      engine; a second pass of the graphed engine captures nothing and
      gives the same tokens and reads;
    * reported for both engines: the second pass's figures (every call a
      replay when graphed), the first pass's capture seconds and graph
      count, one profiled decode chunk's idle share; for the graphed one
      each runner's warm-up, capture and instantiation seconds, the graph
      pool's bytes and the static lane caches' bytes; and whether one
      decode step's logits are bit-equal graphed and eager."""
    cfg = model.cfg
    eager = ServeEngine(model, params, eager=True, **engine_kw)
    e_reqs = make_requests(cfg.vocab)
    e_run = counted_serve(eager, e_reqs)
    tokens = [r.out for r in reqs]
    check(tokens == [r.out for r in e_reqs],
          f"{phase}: graphed tokens differ from eager: "
          f"{[r.rid for r, e in zip(reqs, e_reqs) if r.out != e.out]}")
    first_diff = next((i for i, (a, b) in enumerate(zip(run["reads"],
                                                        e_run["reads"]))
                       if not np.array_equal(a, b)), None)
    check(len(run["reads"]) == len(e_run["reads"]) and first_diff is None,
          f"{phase}: graphed host reads differ from eager at read "
          f"{first_diff} of {len(run['reads'])}")
    check(run["syncs"] == e_run["syncs"],
          f"{phase}: host syncs graphed {run['syncs']} != eager "
          f"{e_run['syncs']}")
    check(run["launches"] == e_run["launches"],
          f"{phase}: launches graphed {run['launches']} != eager "
          f"{e_run['launches']}")
    decode_bound = int(math.log2(eng.decode_chunk)) + 1
    prefill_graphs = eng.prefill_compiles if eng.bucketed else 0
    check(eng.decode_compiles <= decode_bound and
          (not eng.bucketed or eng.prefill_compiles
           <= eng.max_prefill_compiles),
          f"{phase}: {eng.prefill_compiles} prefill / "
          f"{eng.decode_compiles} decode graphs past the bounds "
          f"{eng.max_prefill_compiles} / {decode_bound}")
    check(eng.stats["graphs"] == prefill_graphs + eng.decode_compiles and
          eager.stats["graphs"] == 0,
          f"{phase}: graphs {eng.stats['graphs']} (eager "
          f"{eager.stats['graphs']}) for {prefill_graphs} prefill and "
          f"{eng.decode_compiles} decode runners")
    runner_seconds = {f"prefill {b}": r.seconds
                      for b, r in sorted(eng._prefill_runners.items())}
    runner_seconds.update({f"decode {n}": r.seconds
                           for n, r in sorted(eng._decode_runners.items())})
    out = {"graphed": {"first_pass": pass_figures(eng, run, reqs, {}),
                       "graph_pool_bytes": eng.graph_pool_bytes(),
                       "static_lane_cache_bytes": sum(
                           t.nbytes for lane in eng._lane_caches.values()
                           for t in cache_tensors(lane)),
                       "prefill_graphs": prefill_graphs,
                       "decode_graphs": eng.decode_compiles,
                       "runner_seconds": runner_seconds},
           "eager": {"first_pass": pass_figures(eager, e_run, e_reqs, {})}}
    for label, engine in (("graphed", eng), ("eager", eager)):
        st0 = dict(engine.stats)
        again = make_requests(cfg.vocab)
        run2 = counted_serve(engine, again)
        out[label]["second_pass"] = pass_figures(engine, run2, again, st0)
        check([r.out for r in again] == tokens and
              all(np.array_equal(a, b) for a, b in
                  zip(run2["reads"], run["reads"])),
              f"{phase}: {label} second pass differs from the first")
    check(out["graphed"]["second_pass"]["graphs"] == 0,
          f"{phase}: the graphed engine's second pass captured "
          f"{out['graphed']['second_pass']['graphs']} graphs")
    for label, engine in (("graphed", eng), ("eager", eager)):
        out[label]["decode_chunk_profile"] = profile_decode_chunk(
            engine, cfg.vocab, f"{phase}-{label}")
    out["decode_logits"] = decode_logits_graphed_vs_eager(model, params,
                                                          eng)
    return out


# --------------------------------------------------------------------------
# 7. serve and 8. oracle
# --------------------------------------------------------------------------

def check_served(phase: str, cfg, reqs: list[Request]) -> None:
    """Every request done with MAX_NEW tokens inside the vocabulary."""
    for r in reqs:
        check(r.done and r.state == "done",
              f"{phase} request {r.rid} ended {r.state} ({r.reason})")
        check(len(r.out) == MAX_NEW,
              f"{phase} request {r.rid}: {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"{phase} request {r.rid}: token outside [0, {cfg.vocab})")


def param_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from param_tensors(v)
    else:
        yield tree


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
    kw = dict(slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK)
    eng = ServeEngine(model, params, **kw)
    run = counted_serve(eng, reqs)
    wall, syncs = run["wall_s"], run["syncs"]
    launches = sg.systolic_gemm_cuda.launches
    by_mainloop = hopper_mainloops("serve")
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    check_served("dense", cfg, reqs)
    per_forward = len(GEMMS_PER_LAYER) * cfg.n_layers + 1
    forwards = st["prefill_calls"] + st["decode_steps"]
    check(launches == per_forward * forwards,
          f"pod-GEMM launches {launches} != {per_forward} x {forwards}")
    check(syncs == st["prefill_calls"] + st["chunks"],
          f"host syncs {syncs} != prefill groups + decode chunks")
    generated = sum(len(r.out) for r in reqs)
    pair = graphed_vs_eager("serve", model, params, eng, run, reqs,
                            make_requests, kw)
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=generated,
         wall_s=wall, prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         graphed_vs_eager=pair,
         host_syncs=syncs, pod_gemm_launches=launches,
         pod_gemm_by_mainloop=by_mainloop,
         launches_per_forward=per_forward)
    return reqs, launches, by_mainloop


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


def layer_slice(tree, start: int, stop: int):
    """Every stacked leaf of a segment's tree cut to layers [start, stop)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, start, stop) for k, v in tree.items()}
    return tree[start:stop]


def cut_depth(model, params, n_layers: int):
    """The same full-width weights, first n_layers layers only (views). A
    hybrid model keeps its global layers among them (the 2-layer cut of
    hymba is glob0 and the first layer of swa1, as glob0 | swa_tail);
    each segment of the cut takes its layers from the one segment of the
    full model that holds them."""
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, global_attn_layers=tuple(
            g for g in cfg.global_attn_layers if g < n_layers))
    cut_model = Model(cfg, attention_impl=model.impl, use_pallas=True,
                      ssd_impl=model.ssd_impl)
    where = [(seg, i) for seg in model.segs for i in range(seg.n)]
    cut = {k: v for k, v in params.items()
           if k not in {seg.name for seg in model.segs}}
    start = 0
    for seg in cut_model.segs:
        (full, i0), (last, i1) = where[start], where[start + seg.n - 1]
        check(full == last and (full.kind, full.window) ==
              (seg.kind, seg.window),
              f"cut segment {seg} is not a run of one full segment "
              f"({full}, {last})")
        cut[seg.name] = layer_slice(params[full.name], i0, i1 + 1)
        start += seg.n
    return cut_model, cut


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
# 9. serve_paged and 10. paged_oracle
# --------------------------------------------------------------------------

def make_paged_requests(vocab: int) -> list[Request]:
    rng = np.random.default_rng(0)
    lens = rng.integers(5, PAGED_MAX_PROMPT + 1, N_PAGED_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(lens)]


def dense_of(paged: dict) -> dict:
    return {k: v for k, v in paged.items()
            if k not in ("paged", "page_size", "kv_pages")}


def phase_serve_paged(model, params):
    """granite-8b with flash prefill through the paged pool. The engine is
    stepped by hand so the page stats are read after every quantum."""
    cfg = model.cfg
    # warm-up at the largest bucket: lazy set-up stays out of the timings
    serve(ServeEngine(model, params, **PAGED),
          [Request(rid=-1, prompt=np.arange(PAGED["max_len"] // 2 + 1)
                   % cfg.vocab, max_new_tokens=2)])
    reqs = make_paged_requests(cfg.vocab)
    eng = ServeEngine(model, params, **PAGED)
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    peaks = []

    def page_stats(engine):
        stats = engine.paged_kv_stats()
        if not peaks or stats["mapped_bytes"] > peaks[-1]["mapped_bytes"]:
            peaks.append(stats)
    run = counted_serve(eng, reqs, step_hook=page_stats)
    wall, syncs, peak = run["wall_s"], run["syncs"], peaks[-1]
    gemm_launches = sg.systolic_gemm_cuda.launches
    by_mainloop = hopper_mainloops("serve_paged")
    flash_launches = fa.flash_attention_cuda.launches
    flash_by_mainloop = flash_mainloops("serve_paged")
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    # the prefill's dense transient lane cache at the largest bucket, and
    # the device's peak over the run above what the weights and the pool
    # already held (transient cache, activations, logits)
    ps = PAGED["page_size"]
    bucket = max(eng._bucket(len(r.prompt)) for r in reqs)
    transient = (PAGED["slots"] * -(-bucket // ps) * ps
                 * peak["kv_bytes_per_token"])
    peak_over_start = torch.cuda.max_memory_allocated() - start_bytes
    check_served("paged", cfg, reqs)
    eng._pool.assert_drained()
    check(eng.recycled >= 1, "no lane was recycled inside a chunk")
    per_forward = len(GEMMS_PER_LAYER) * cfg.n_layers + 1
    forwards = st["prefill_calls"] + st["decode_steps"]
    check(gemm_launches == per_forward * forwards,
          f"pod-GEMM launches {gemm_launches} != {per_forward} x {forwards}")
    check(flash_launches == cfg.n_layers * st["prefill_calls"],
          f"flash launches {flash_launches} != {cfg.n_layers} x "
          f"{st['prefill_calls']} prefill calls")
    check(syncs == st["prefill_calls"] + st["chunks"],
          f"host syncs {syncs} != prefill groups + decode chunks")
    generated = sum(len(r.out) for r in reqs)
    pair = graphed_vs_eager("serve_paged", model, params, eng, run, reqs,
                            make_paged_requests, PAGED)
    emit("serve_paged", arch=cfg.name, n_layers=cfg.n_layers,
         attention_impl=model.impl, **PAGED,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=generated,
         wall_s=wall, prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         graphed_vs_eager=pair,
         host_syncs=syncs, pod_gemm_launches=gemm_launches,
         pod_gemm_by_mainloop=by_mainloop,
         flash_launches=flash_launches,
         flash_by_mainloop=flash_by_mainloop, recycled=eng.recycled,
         peak_paged_kv_stats=peak, largest_bucket=bucket,
         prefill_transient_kv_bytes=transient,
         device_peak_bytes_over_start=peak_over_start)
    return reqs, flash_by_mainloop


def layer0_qkv(cfg, params, tokens):
    """Layer 0's q, k, v (after RoPE) for a token batch: the real inputs
    the flash kernel meets first in a served prefill."""
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    h = apply_norm({k: v[0] for k, v in params["layers"]["ln_attn"].items()},
                   embed(params["embed"], tokens), cfg.norm)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    q, k, v = (pod_dense(h, p[n]) for n in ("q", "k", "v"))
    return (apply_rope(q, pos, cfg.rope_theta),
            apply_rope(k, pos, cfg.rope_theta), v)


def layer0_gate(cfg, params) -> dict:
    """The kernel on the real activations it meets first in a served
    prefill: layer 0's q, k, v of the first served prompts at bucket
    max_len. Random weights with the reference's fan-in (the [d, H, hd]
    projections scale by H) give scores in the hundreds, where the naive
    version's bf16 scores (ulp 2-4) pick other keys than f32 scores
    (PERF.md), so the kernel is held to the Pallas kernel's own arithmetic
    with its key tile, at flash_bf16_tiled_large_scores."""
    toks = np.zeros((PAGED["slots"], PAGED["max_len"]), np.int64)
    for g, r in enumerate(make_paged_requests(cfg.vocab)[:PAGED["slots"]]):
        toks[g, :len(r.prompt)] = r.prompt
    q, k, v = layer0_qkv(cfg, params, torch.from_numpy(toks).cuda())
    D = q.shape[-1]
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    tiled = flash_attention_tiled_ref(q, k, v, causal=True,
                                      block_k=fa.flash_plan(D, torch.bfloat16).block_k)
    # the score scale, over batch 0's first 256 rows (their causal pairs)
    qs = q[:1, :256].float() / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k[:1, :256].float()
                     .repeat_interleave(q.shape[2] // k.shape[2], dim=2))
    ok = torch.ones((256, 256), dtype=torch.bool, device=q.device).tril()
    return {"shape": list(q.shape),
            "score_std": float(s[:, :, ok].std()),
            "excess": TOLERANCES["flash_bf16_tiled_large_scores"].excess(
                got, tiled),
            "excess_at_flash_bf16_tiled":
                TOLERANCES["flash_bf16_tiled"].excess(got, tiled),
            "max_abs_err": float((got.double() - tiled.double())
                                 .abs().max())}


def phase_paged_oracle(model, params, served: list[Request]) -> None:
    """Paged against dense on the same flash model: the gathered page view
    is position-ordered and every lane's arithmetic is row-independent, so
    the tokens must be equal. On the first ORACLE_LAYERS layers, the paged
    flash engine against the per-token ReferenceEngine of the same model:
    the margin rule. Then the kernel on layer 0's real activations."""
    tol = TOLERANCES["token_margin"]
    cfg = model.cfg
    dense = make_paged_requests(cfg.vocab)
    wall = serve(ServeEngine(model, params, **dense_of(PAGED)), dense)
    unequal = [r.rid for r, d in zip(served, dense) if r.out != d.out]

    cut_model, cut_params = cut_depth(model, params, ORACLE_LAYERS)
    cut_served = make_paged_requests(cfg.vocab)
    eng = ServeEngine(cut_model, cut_params, **PAGED)
    serve(eng, cut_served)
    eng._pool.assert_drained()
    reqs = make_paged_requests(cfg.vocab)
    ref = ReferenceEngine(cut_model, cut_params, slots=PAGED["slots"],
                          max_len=PAGED["max_len"])
    serve(ref, reqs)
    cut = first_differences(cut_served, reqs, ref)

    real = layer0_gate(cfg, params)
    emit("paged_oracle", requests=len(served), dense_wall_s=wall,
         full_depth={"n_layers": cfg.n_layers,
                     "paged_equals_dense": len(served) - len(unequal),
                     "unequal_rids": unequal},
         cut_depth={"n_layers": ORACLE_LAYERS,
                    "token_exact_vs_oracle": len(cut_served) - len(cut),
                    "first_differences": cut},
         layer0_real_activations=real,
         margin_tolerance=f"{tol.atol} x max|logit|")
    check(not unequal, f"paged tokens differ from dense for requests "
                       f"{unequal} at full depth")
    for d in cut:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{ORACLE_LAYERS}-layer cut: paged flash engine differs from "
              f"its oracle for request {d['rid']} at token {d['step']} with "
              f"oracle margin {d['margin']} > {tol.atol} x max|logit| "
              f"{d['max_abs_logit']}")
    check(real["excess"] <= 1.0, f"kernel disagrees with the tiled plain "
                                 f"version on layer 0's activations {real}")


# --------------------------------------------------------------------------
# 17. serve_controls and 18. launch_serve
# --------------------------------------------------------------------------

# tests/test_admission.py's overload case: 2 slots, virtual time
OVERLOAD = dict(slots=2, max_len=64, decode_chunk=8)
CHAOS = dict(seed=3, p_fault=0.3, p_slow=0.3)
EXHAUSTED_REQUESTS = 4      # the paged prompts of three buckets


class EarlyWriteEngine(ServeEngine):
    """Planted control: each attempt runs the call, which writes the
    runner's static buffers and the caches in place, before the injector
    may raise. A retried decode chunk then runs on caches the failed
    attempt already advanced, so the tokens must differ from a clean
    run's."""

    def _device_call(self, kind, fn):
        while True:
            out = fn()
            try:
                self._chaos.before(kind)
                return out
            except TransientDeviceError:
                continue


def overload_requests(vocab: int) -> list[Request]:
    """12 prompts of 5-8 tokens, 6 new tokens each, deadlines 0.8 and 7.0
    s alternating (tests/test_admission.py)."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(12):
        p = rng.integers(0, vocab, int(rng.integers(5, 9)))
        reqs.append(Request(rid=i, prompt=p, max_new_tokens=6,
                            deadline_s=0.8 if i % 2 else 7.0))
    return reqs


def check_drained(phase: str, engine, reqs: list[Request]) -> None:
    """Every request terminal, no slot held, and (paged) no page in use
    or reserved."""
    check(not engine.queue and not any(engine.active),
          f"{phase}: a slot is still held or a request still queued")
    check(all(r.finished for r in reqs),
          f"{phase}: requests not terminal: "
          f"{[(r.rid, r.state) for r in reqs if not r.finished]}")
    if engine._pool is not None:
        engine._pool.assert_drained()


def overload_attainment(model, params) -> dict:
    """fifo, edf and slo-aware on the overload case under a VirtualClock:
    edf and slo-aware must beat fifo in SLO attainment."""
    out = {}
    for policy in POLICIES:
        clock = VirtualClock()
        eng = ServeEngine(model, params, clock=clock,
                          admission=AdmissionConfig(policy=policy),
                          chaos=ChaosConfig(seed=0, service_seconds=0.05),
                          **OVERLOAD)
        reqs = overload_requests(model.cfg.vocab)
        wall = serve(eng, reqs)
        check_drained(f"overload {policy}", eng, reqs)
        out[policy] = {"slo_attainment": eng.admission.slo_attainment,
                       "counts": dict(eng.admission.counts),
                       "virtual_s": clock.t, "wall_s": wall,
                       "graphs": eng.stats["graphs"]}
    att = {p: out[p]["slo_attainment"] for p in POLICIES}
    check(att["edf"] > att["fifo"] and att["slo-aware"] > att["fifo"],
          f"overload: edf and slo-aware must beat fifo in attainment {att}")
    return out


PREDICTOR_TRIALS = 3


def predictor_host_cost(cfg, reqs: list[Request]) -> dict:
    """The slo-aware predictor's host milliseconds for each new (prompt
    bucket, tokens) key of the served requests at full width, one reading
    per trial (each trial a fresh predictor, so every key is new again),
    and the slowest hit. A pricing allocates enough to set off Python's
    garbage collector; `full_gc_ms` lists the full (generation 2)
    collections that fell inside a reading, by key."""
    new_key_ms, hit_ms, full_gc_ms = {}, [], []
    started, pauses = [0.0], []

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        elif info["generation"] == 2:
            pauses.append(1e3 * (time.perf_counter() - started[0]))

    gc.callbacks.append(on_gc)
    try:
        for _ in range(PREDICTOR_TRIALS):
            pred, seen = WaveLatencyPredictor(cfg), set()
            for r in reqs:
                key = f"{pred._bucket(len(r.prompt))}x{r.max_new_tokens}"
                n_pauses = len(pauses)
                t0 = time.perf_counter()
                pred.model_seconds(len(r.prompt), r.max_new_tokens)
                t1 = time.perf_counter()
                pred.model_seconds(len(r.prompt), r.max_new_tokens)
                hit_ms.append(1e3 * (time.perf_counter() - t1))
                if key not in seen:
                    seen.add(key)
                    new_key_ms.setdefault(key, []).append(1e3 * (t1 - t0))
                    full_gc_ms += [[key, ms] for ms in pauses[n_pauses:]]
    finally:
        gc.callbacks.remove(on_gc)
    every = [ms for readings in new_key_ms.values() for ms in readings]
    return {"new_key_ms": new_key_ms,
            "new_key_ms_range": [min(every), max(every)],
            "full_gc_ms": full_gc_ms, "hit_ms_max": max(hit_ms)}


def controls_off_and_on(model, params) -> tuple[dict, list]:
    """The serve phase's requests with the defaults and with metrics and
    a tracer on, real clock: equal tokens, host syncs, graphs and launches
    by kernel and mainloop. Steady passes in turns (off, on, on, off)
    time the instrumentation on the host; the two instrumented ones, with
    fresh sinks, give the effective TOPS per phase and the token wait.
    Planted: a metrics hook that reads a device tensor must fail the sync
    gate. Returns the figures and the default engine's tokens."""
    cfg = model.cfg
    kw = dict(slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK)
    off = ServeEngine(model, params, **kw)
    off_reqs = make_requests(cfg.vocab)
    off_run = counted_serve(off, off_reqs)
    metrics, tracer = MetricsRegistry(), ServeTraceRecorder()
    on = ServeEngine(model, params, metrics=metrics, tracer=tracer, **kw)
    on_reqs = make_requests(cfg.vocab)
    on_run = counted_serve(on, on_reqs)
    by_mainloop = hopper_mainloops("serve_controls")
    tokens = [r.out for r in off_reqs]
    check([r.out for r in on_reqs] == tokens,
          "serve_controls: metrics and tracer changed the tokens")
    check(on_run["syncs"] == off_run["syncs"],
          f"serve_controls: host syncs with metrics and tracer "
          f"{on_run['syncs']} != {off_run['syncs']} without")
    check(on.stats["graphs"] == off.stats["graphs"],
          f"serve_controls: graphs {on.stats['graphs']} with controls != "
          f"{off.stats['graphs']} without")
    check(on_run["launches"] == off_run["launches"],
          f"serve_controls: launches {on_run['launches']} with controls != "
          f"{off_run['launches']} without")
    check(len(tracer.spans) == on_run["syncs"],
          f"serve_controls: {len(tracer.spans)} spans for "
          f"{on_run['syncs']} device calls")
    # steady passes (every call a replay) in turns off, on, on, off: the
    # instrumentation's host cost; the on engine's sinks start afresh
    metrics, tracer = MetricsRegistry(), ServeTraceRecorder()
    on.metrics = on.admission.metrics = metrics
    on.tracer = tracer
    graphs = (off.stats["graphs"], on.stats["graphs"])
    steady = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        engine = off if label == "off" else on
        st0 = dict(engine.stats)
        again = make_requests(cfg.vocab)
        run = counted_serve(engine, again)
        check([r.out for r in again] == tokens,
              f"serve_controls: a steady {label} pass changed the tokens")
        steady[label].append(pass_figures(engine, run, again, st0))
    check((off.stats["graphs"], on.stats["graphs"]) == graphs,
          "serve_controls: a steady pass captured a graph")
    syncs = steady["on"][0]["host_syncs"]
    check(len(tracer.spans) == 2 * syncs,
          f"serve_controls: {len(tracer.spans)} spans for two passes of "
          f"{syncs} device calls")
    tops = [dataclasses.asdict(r)
            for r in effective_tops_summary(tracer, cfg, metrics)]
    check({r["phase"] for r in tops} == {"prefill", "decode"},
          f"serve_controls: effective TOPS rows {tops}")
    wait = metrics.histogram("serve.decode.token_wait_us").summary()
    # planted: a metrics hook that reads the device costs a sync a chunk
    real = on._observe_decode

    def reading_hook(*args):
        real(*args)
        engine_mod.to_host(next(iter(on.cache.values()))["attn"].length)
    on._observe_decode = reading_hook
    try:
        planted = counted_serve(on, make_requests(cfg.vocab))
    finally:
        del on._observe_decode
    check(planted["syncs"] != syncs,
          "planted control (a metrics hook reading a device tensor) "
          "passed the sync gate")
    return {"host_syncs": off_run["syncs"],
            "graphs": off.stats["graphs"], "pod_gemm_by_mainloop":
            by_mainloop, "steady_passes": steady,
            "steady_decode_ms_per_step": {
                k: [f["decode_ms_per_step"] for f in v]
                for k, v in steady.items()},
            "effective_tops": tops,
            "token_wait_us": {k: wait[k] for k in ("count", "p50", "p99")},
            "decode_tok_s": metrics.value("serve.decode.tok_s"),
            "planted_metrics_read_syncs": [planted["syncs"], syncs]}, \
        tokens


def chaos_paged(model, params, clean_dense: list) -> dict:
    """The paged engine (flash prefill, a pool of half the dense pages),
    edf, real clock: clean, then with transient faults that heal (tokens,
    runners and graphs equal, nothing leaked), then with faults that
    exhaust the retries (requests rejected device-fault, nothing leaked).
    Planted: an engine whose call writes before the injector raises must
    fail token equality (dense, against the default engine's tokens)."""
    cfg = model.cfg
    kw = dict(PAGED, admission="edf")
    clean = ServeEngine(model, params, **kw)
    clean_reqs = make_paged_requests(cfg.vocab)
    serve(clean, clean_reqs)
    check_drained("chaos clean", clean, clean_reqs)
    eng = ServeEngine(model, params, chaos=ChaosConfig(**CHAOS),
                      max_retries=3, **kw)
    reqs = make_paged_requests(cfg.vocab)
    wall = serve(eng, reqs)
    check_drained("chaos", eng, reqs)
    injected = dict(eng._chaos.injected)
    check(injected["faults"] > 0, f"chaos: no fault injected {injected}")
    check(all(r.state == "done" for r in reqs),
          f"chaos: {[(r.rid, r.state, r.reason) for r in reqs]}")
    check([r.out for r in reqs] == [r.out for r in clean_reqs],
          "chaos: tokens differ from the chaos-free run")
    runners = (eng.prefill_compiles, eng.decode_compiles,
               eng.stats["graphs"])
    clean_runners = (clean.prefill_compiles, clean.decode_compiles,
                     clean.stats["graphs"])
    check(runners == clean_runners,
          f"chaos: runners and graphs {runners} != {clean_runners} clean")
    del clean, eng
    ex = ServeEngine(model, params, chaos=ChaosConfig(**CHAOS,
                                                      transient_tries=5),
                     max_retries=3, **kw)
    ex_reqs = make_paged_requests(cfg.vocab)[:EXHAUSTED_REQUESTS]
    serve(ex, ex_reqs)
    check_drained("chaos exhausted", ex, ex_reqs)
    rejected = [r for r in ex_reqs if r.state == "rejected"]
    check(rejected and all(r.reason == "device-fault" for r in rejected),
          f"chaos exhausted: {[(r.rid, r.state, r.reason) for r in ex_reqs]}")
    exhausted = {"states": [(r.rid, r.state, r.reason) for r in ex_reqs],
                 "injected": dict(ex._chaos.injected)}
    del ex
    planted = EarlyWriteEngine(model, params, chaos=ChaosConfig(**CHAOS),
                               slots=SLOTS, max_len=MAX_LEN,
                               decode_chunk=DECODE_CHUNK)
    planted_reqs = make_requests(cfg.vocab)
    serve(planted, planted_reqs)
    check(planted._chaos.injected["faults"] > 0,
          "planted early write: no fault injected")
    check([r.out for r in planted_reqs] != clean_dense,
          "planted control (writes before the injector raises) passed "
          "token equality after retry")
    return {"wall_s": wall, "injected": injected,
            "runners_prefill_decode_graphs": runners,
            "exhausted": exhausted,
            "planted_early_write_unequal": [
                r.rid for r, t in zip(planted_reqs, clean_dense)
                if r.out != t]}


def phase_serve_controls(model, flash_model, params) -> None:
    t0 = time.perf_counter()
    overload = overload_attainment(model, params)
    t1 = time.perf_counter()
    controls, tokens = controls_off_and_on(model, params)
    t2 = time.perf_counter()
    chaos = chaos_paged(flash_model, params, tokens)
    t3 = time.perf_counter()
    emit("serve_controls", gpu=gpu_name_and_power(),
         overload=overload, controls_off_and_on=controls, chaos=chaos,
         predictor_host_cost=predictor_host_cost(
             model.cfg, make_requests(model.cfg.vocab)),
         wall_s={"overload": t1 - t0, "controls": t2 - t1,
                 "chaos": t3 - t2, "total": time.perf_counter() - t0})


def phase_launch_serve() -> None:
    """repro_torch.launch.serve in-process at reduced granite-8b, edf,
    deadlines, chaos, metrics and a trace file: one span per device
    call, and the run through the pod GEMM and flash kernels."""
    from repro_torch.launch import serve as launch
    path = _build.REPO_ROOT / "build" / "serve_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", "granite-8b", "--reduced", "--metrics",
                     "--trace-out", str(path), "--policy", "edf",
                     "--deadline", "5", "--chaos-seed", "1"])
    launches = {"pod_gemm": KERNELS["nn"].launches,
                "flash": fa.flash_attention_cuda.launches}
    wall = time.perf_counter() - t0
    check(launches["pod_gemm"] > 0 and launches["flash"] > 0,
          f"launch_serve: the launcher ran no pod-GEMM or no flash kernel "
          f"{launches}")
    lines = out.getvalue().splitlines()
    start = lines.index("metrics snapshot:") + 1
    end = lines.index("}", start)
    counters = json.loads("\n".join(lines[start:end + 1]))["counters"]
    calls = counters.get("serve.decode.chunks", 0) + sum(
        v for k, v in counters.items()
        if k.startswith("serve.prefill.calls"))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e["ph"] == "X"]
    check(calls > 0 and len(spans) == calls,
          f"launch_serve: {len(spans)} spans for {calls} device calls")
    emit("launch_serve", wall_s=wall, spans=len(spans), device_calls=calls,
         launches=launches, summary=lines[start - 3:start - 1])


# --------------------------------------------------------------------------
# 11. serve_ssm and 12. ssm_oracle
# --------------------------------------------------------------------------

def reset_launch_counts() -> None:
    for fn in (sg.systolic_gemm_cuda, sg.systolic_gemm_nt_cuda,
               sg.grouped_systolic_gemm_cuda, fa.flash_attention_cuda,
               ssd_mod.ssd_cuda):
        fn.launches = 0
    for fn in KERNELS.values():
        fn.mainloop_launches = dict.fromkeys(sg.MAINLOOPS, 0)
    fa.flash_attention_cuda.mainloop_launches = dict.fromkeys(fa.MAINLOOPS, 0)
    ssd_mod.ssd_cuda.mainloop_launches = dict.fromkeys(ssd_mod.MAINLOOPS, 0)


def hopper_mainloops(phase: str, form: str = "nn") -> dict:
    """The NN (or NT) pod-GEMM launches of a served run by mainloop: every
    one on splitk or wgmma (bf16, TMA-aligned shapes), none on wmma or
    simt."""
    fn = KERNELS[form]
    by = dict(fn.mainloop_launches)
    check(by["wmma"] == 0 and by["simt"] == 0 and
          sum(by.values()) == fn.launches,
          f"{phase}: {form} pod-GEMM launches by mainloop {by}, total "
          f"{fn.launches}")
    return by


def flash_mainloops(phase: str) -> dict:
    """The flash launches of a served run by mainloop: every one on wgmma
    (bf16 at the served head dim, 128), none on mma or simt."""
    fn = fa.flash_attention_cuda
    by = dict(fn.mainloop_launches)
    check(by["wgmma"] == fn.launches and sum(by.values()) == fn.launches,
          f"{phase}: flash launches by mainloop {by}, total {fn.launches}")
    return by


def phase_serve_ssm(model, params):
    """mamba2-370m through bucketed prefill (SSD kernel) and fused decode
    (recurrent torch ops), every LM head on the NT kernel."""
    cfg = model.cfg
    # warm-up at the largest bucket: lazy set-up stays out of the timings
    serve(ServeEngine(model, params, **SSM_SERVE),
          [Request(rid=-1, prompt=np.arange(SSM_SERVE["max_len"] // 2 + 1)
                   % cfg.vocab, max_new_tokens=2)])
    reqs = make_paged_requests(cfg.vocab)
    eng = ServeEngine(model, params, **SSM_SERVE)
    run = counted_serve(eng, reqs)
    wall, syncs = run["wall_s"], run["syncs"]
    launches = {"pod_gemm": sg.systolic_gemm_cuda.launches,
                "gemm_nt": sg.systolic_gemm_nt_cuda.launches,
                "flash": fa.flash_attention_cuda.launches,
                "ssd": ssd_mod.ssd_cuda.launches}
    # every head on splitk (decode) or wgmma (prefill over 4 x bucket rows)
    launches["gemm_nt_by_mainloop"] = hopper_mainloops("serve_ssm", "nt")
    # every SSD call on chunked (bf16 at mamba2's tiles)
    launches["ssd_by_mainloop"] = dict(ssd_mod.ssd_cuda.mainloop_launches)
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    check_served("ssm", cfg, reqs)
    forwards = st["prefill_calls"] + st["decode_steps"]
    check(launches["gemm_nt"] == forwards,
          f"NT-GEMM launches {launches['gemm_nt']} != 1 x {forwards} "
          f"forwards")
    check(launches["ssd"] == cfg.n_layers * st["prefill_calls"],
          f"SSD launches {launches['ssd']} != {cfg.n_layers} x "
          f"{st['prefill_calls']} prefill calls (none per decode step)")
    check(launches["ssd_by_mainloop"]["chunked"] == launches["ssd"],
          f"SSD launches by mainloop {launches['ssd_by_mainloop']}, total "
          f"{launches['ssd']}: every one must run chunked")
    check(launches["pod_gemm"] == 0 and launches["flash"] == 0,
          f"mamba2 launched another kernel: {launches}")
    check(syncs == st["prefill_calls"] + st["chunks"],
          f"host syncs {syncs} != prefill groups + decode chunks")
    generated = sum(len(r.out) for r in reqs)
    pair = graphed_vs_eager("serve_ssm", model, params, eng, run, reqs,
                            make_paged_requests, SSM_SERVE)
    emit("serve_ssm", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, ssd_impl=model.ssd_impl, **SSM_SERVE,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=generated,
         wall_s=wall, prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         graphed_vs_eager=pair,
         host_syncs=syncs, launches=launches,
         largest_bucket=max(eng._bucket(len(r.prompt)) for r in reqs),
         ssm_state_bytes_per_lane=eng.cache["layers"]["ssm"].lane_bytes())
    return reqs, launches


def phase_ssm_oracle(model, params, served: list[Request],
                     phase: str = "ssm_oracle") -> None:
    """Engine vs per-token oracle on mamba2 (and on hymba, as phase
    hybrid_oracle: the oracle's exact-length prefill takes the ring's
    roll, the engine's bucketed one its gather): agreement reported at
    full depth, the margin rule held on ORACLE_LAYERS layers of the same
    weights (as phase_oracle)."""
    tol = TOLERANCES["token_margin"]
    cfg = model.cfg
    oracle_kw = dict(slots=SSM_SERVE["slots"], max_len=SSM_SERVE["max_len"])
    reqs = make_paged_requests(cfg.vocab)
    ref = ReferenceEngine(model, params, **oracle_kw)
    wall = serve(ref, reqs)
    full = first_differences(served, reqs, ref)
    cut_model, cut_params = cut_depth(model, params, ORACLE_LAYERS)
    cut_served = make_paged_requests(cfg.vocab)
    serve(ServeEngine(cut_model, cut_params, **SSM_SERVE), cut_served)
    cut_reqs = make_paged_requests(cfg.vocab)
    cut_ref = ReferenceEngine(cut_model, cut_params, **oracle_kw)
    serve(cut_ref, cut_reqs)
    cut = first_differences(cut_served, cut_reqs, cut_ref)
    emit(phase, arch=cfg.name, requests=len(reqs), oracle_wall_s=wall,
         full_depth={"n_layers": cfg.n_layers,
                     "token_exact": len(reqs) - len(full),
                     "first_differences": full},
         cut_depth={"n_layers": ORACLE_LAYERS,
                    "segments": [(sg_.name, sg_.n, sg_.window)
                                 for sg_ in cut_model.segs],
                    "token_exact": len(reqs) - len(cut),
                    "first_differences": cut},
         margin_tolerance=f"{tol.atol} x max|logit|")
    for d in cut:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{ORACLE_LAYERS}-layer {cfg.name} cut: request {d['rid']} "
              f"differs at token {d['step']} with oracle margin "
              f"{d['margin']} > {tol.atol} x max|logit| "
              f"{d['max_abs_logit']}")


# --------------------------------------------------------------------------
# 13. serve_moe and 14. moe_oracle
# --------------------------------------------------------------------------

def phase_serve_moe(model, params):
    """dbrx through exact-length prefill (flash, grouped and pod GEMMs) and
    fused decode; every MoE layer's experts on the grouped kernel."""
    cfg = model.cfg
    # warm-up: lazy set-up stays out of the timings
    serve(ServeEngine(model, params, **MOE_SERVE),
          [Request(rid=-1, prompt=np.arange(64), max_new_tokens=2)])
    reqs = make_paged_requests(cfg.vocab)
    eng = ServeEngine(model, params, **MOE_SERVE)
    shapes = []
    real_prefill = model.prefill

    def prefill(params, batch, cache):
        shapes.append(list(batch["tokens"].shape))
        return real_prefill(params, batch, cache)
    model.prefill = prefill
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        run = counted_serve(eng, reqs)
    finally:
        del model.prefill
    wall, syncs = run["wall_s"], run["syncs"]
    launches = {k: v["launches"] for k, v in run["launches"].items()}
    launches["pod_gemm_by_mainloop"] = hopper_mainloops("serve_moe")
    launches["grouped_by_mainloop"] = grouped_by = dict(
        sg.grouped_systolic_gemm_cuda.mainloop_launches)
    launches["flash_by_mainloop"] = flash_mainloops("serve_moe")
    peak = torch.cuda.max_memory_allocated()
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    check_served("moe", cfg, reqs)
    check(st["bucketed"] is False and eng.bucketed is False,
          "the moe engine took the bucketed prefill path")
    check(shapes == [[1, len(r.prompt)] for r in reqs],
          f"prefills {shapes} are not one [1, S] per request")
    check(st["prefill_calls"] == len(reqs),
          f"{st['prefill_calls']} prefill calls for {len(reqs)} requests")
    L = cfg.n_layers
    forwards = st["prefill_calls"] + st["decode_steps"]
    per_forward = {"grouped": 3 * L, "pod_gemm": 4 * L + 1}
    for name, n in per_forward.items():
        check(launches[name] == n * forwards,
              f"{name} launches {launches[name]} != {n} x {forwards} "
              f"forwards")
    check(launches["flash"] == L * st["prefill_calls"],
          f"flash launches {launches['flash']} != {L} x "
          f"{st['prefill_calls']} prefill calls (none per decode step)")
    # rows per expert of each prefill (the routing's groups x capacity):
    # the experts of those past 64 rows on wgmma, every other on wmma
    rows = [expert_rows(cfg, s) for s in (len(r.prompt) for r in reqs)]
    wide = 3 * L * sum(m > sg.SPLITK_MAX_M for m in rows)
    check(grouped_by["wgmma"] == wide and grouped_by["simt"] == 0 and
          grouped_by["wmma"] == launches["grouped"] - wide,
          f"grouped launches by mainloop {grouped_by}: {wide} should be "
          f"wgmma (rows per expert at prefill {rows}), the rest wmma")
    launches["grouped_rows_per_expert_at_prefill"] = rows
    check(launches["gemm_nt"] == 0 and launches["ssd"] == 0,
          f"dbrx launched an NT-GEMM or SSD kernel: {launches}")
    check(syncs == st["prefill_calls"] + st["chunks"],
          f"host syncs {syncs} != prefills + decode chunks")
    generated = sum(len(r.out) for r in reqs)
    pair = graphed_vs_eager("serve_moe", model, params, eng, run, reqs,
                            make_paged_requests, MOE_SERVE)
    emit("serve_moe", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
         attention_impl=model.impl, **MOE_SERVE,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=generated,
         wall_s=wall, bucketed=eng.bucketed, prefill_shapes=shapes,
         prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         graphed_vs_eager=pair,
         host_syncs=syncs, launches=launches,
         launches_per_forward=per_forward,
         gib_allocated_at_start=start_bytes / 2 ** 30,
         gib_peak=peak / 2 ** 30)
    return reqs, launches


def expert_rows(cfg, tokens: int) -> int:
    """Rows per expert of one MoE forward over `tokens` tokens: the
    routing's groups times its per-group capacity (models/moe.py)."""
    groups, per_group = moe._group_shape(tokens, cfg.moe.group_size)
    return groups * moe._capacity(per_group, cfg.moe)


def batch_first_differences(served, oracle, ref: ReferenceEngine):
    """first_differences, and those at the earliest differing step of the
    whole batch: at decode the batch is one routing group, so after one
    lane's token differs the others' expert capacity may differ too."""
    diffs = first_differences(served, oracle, ref)
    first = min((d["step"] for d in diffs), default=None)
    return diffs, [d for d in diffs if d["step"] == first]


def phase_moe_oracle(model, params) -> None:
    """ServeEngine vs the per-token oracle on MOE_ORACLE_REQUESTS = slots
    requests of equal budget, so every decode batch is fully live in both
    engines and no dead lane takes expert capacity. Agreement reported at
    MOE_LAYERS; the margin rule held at the batch's first difference on
    ORACLE_LAYERS layers of the same weights."""
    tol = TOLERANCES["token_margin"]
    cfg = model.cfg
    oracle_kw = dict(slots=MOE_SERVE["slots"], max_len=MOE_SERVE["max_len"])

    def requests():
        return make_paged_requests(cfg.vocab)[:MOE_ORACLE_REQUESTS]

    out = {}
    for label, (m, p) in (("full_depth", (model, params)),
                          ("cut_depth", cut_depth(model, params,
                                                  ORACLE_LAYERS))):
        served, oracle = requests(), requests()
        check(len({r.max_new_tokens for r in served}) == 1 and
              len(served) == MOE_SERVE["slots"],
              "the oracle batch must fill every slot with equal budgets")
        serve(ServeEngine(m, p, **MOE_SERVE), served)
        ref = ReferenceEngine(m, p, **oracle_kw)
        wall = serve(ref, oracle)
        diffs, earliest = batch_first_differences(served, oracle, ref)
        out[label] = {"n_layers": m.cfg.n_layers,
                      "token_exact": len(served) - len(diffs),
                      "first_differences": diffs,
                      "earliest_in_batch": earliest, "oracle_wall_s": wall}
    emit("moe_oracle", requests=MOE_ORACLE_REQUESTS, **out,
         margin_tolerance=f"{tol.atol} x max|logit| at the batch's first "
                          f"difference")
    for d in out["cut_depth"]["earliest_in_batch"]:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{ORACLE_LAYERS}-layer dbrx cut: request {d['rid']} differs "
              f"at token {d['step']} (the batch's first difference) with "
              f"oracle margin {d['margin']} > {tol.atol} x max|logit| "
              f"{d['max_abs_logit']}")


# --------------------------------------------------------------------------
# 15. serve_hybrid and 16. hybrid_oracle
# --------------------------------------------------------------------------

def flash_windows_per_forward(model, params, S: int) -> list:
    """The window of each flash launch of one eager [1, S] forward, in
    layer order, as the model hands it to the kernel."""
    windows = []
    real = fl_ops.flash_attention_cuda

    def spy(q, k, v, **kw):
        windows.append(kw.get("window"))
        return real(q, k, v, **kw)
    fl_ops.flash_attention_cuda = spy
    try:
        tokens = torch.arange(S, device="cuda")[None] % model.cfg.vocab
        model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        fl_ops.flash_attention_cuda = real
    return windows


def hybrid_launches(phase: str, cfg, st: dict, table: dict) -> dict:
    """A served hymba run's launches (launch_table) against its counts per
    forward: 7 pod GEMMs a layer and the untied head (the head, N = 32001,
    on wmma; the rest on splitk or wgmma by M), flash and SSD once a layer
    per prefill and never at decode (flash on wgmma, SSD on serial), no
    NT or grouped launch. `st`: the run's engine stats."""
    L = cfg.n_layers
    forwards = st["prefill_calls"] + st["decode_steps"]
    per_forward = HYBRID_GEMMS_PER_LAYER * L + 1
    gemm = table["pod_gemm"]
    by = gemm["by_mainloop"]
    check(gemm["launches"] == per_forward * forwards,
          f"{phase}: pod-GEMM launches {gemm['launches']} != {per_forward} "
          f"x {forwards} forwards")
    check(by["wmma"] == forwards and by["simt"] == 0 and
          by["splitk"] + by["wgmma"] == (per_forward - 1) * forwards,
          f"{phase}: pod-GEMM launches by mainloop {by}: the head's "
          f"{forwards} on wmma, the rest on splitk or wgmma")
    for name, mainloop in (("flash", "wgmma"), ("ssd", "serial")):
        t = table[name]
        check(t["launches"] == L * st["prefill_calls"] and
              t["by_mainloop"][mainloop] == t["launches"],
              f"{phase}: {name} launches {t} != {L} x "
              f"{st['prefill_calls']} prefill calls, all on {mainloop}")
    check(table["gemm_nt"]["launches"] == 0 and
          table["grouped"]["launches"] == 0,
          f"{phase}: hymba launched an NT or grouped GEMM: {table}")
    return {"per_forward": {"pod_gemm": per_forward, "flash_per_prefill": L,
                            "ssd_per_prefill": L}, **table}


def cache_bytes(cache: dict) -> dict:
    """Device bytes of a served cache's k, v, conv and state by kind:
    sliding-window rings, global KV (dense, or the paged pool), SSM state
    (conv window and state); lengths and page tables left out."""
    out = {"rings": 0, "global_kv": 0, "ssm_state": 0}
    for node in cache.values():
        for c in node.values():
            kind = {"RingKVCache": "rings", "SSMCache": "ssm_state"}.get(
                type(c).__name__, "global_kv")
            out[kind] += sum(getattr(c, f.name).nbytes
                             for f in dataclasses.fields(c)
                             if getattr(c, f.name).is_floating_point())
    return out


def phase_serve_hybrid(model, params):
    """hymba through bucketed prefill (windowed and global flash, the SSD
    kernel on serial, the ring gather) and fused decode (rings and a
    recurrent SSM step in torch ops), every projection and the untied
    head on the pod GEMM; dense, then paged for the global layers."""
    cfg = model.cfg
    dense_kw = dense_of(PAGED)
    # warm-up at the largest bucket: lazy set-up stays out of the timings
    serve(ServeEngine(model, params, **dense_kw),
          [Request(rid=-1, prompt=np.arange(PAGED["max_len"] // 2 + 1)
                   % cfg.vocab, max_new_tokens=2)])
    windows = flash_windows_per_forward(model, params, 1100)
    expect = [seg.window for seg in model.segs for _ in range(seg.n)]
    check(windows == expect and len(windows) == cfg.n_layers and
          windows.count(None) == len(cfg.global_attn_layers),
          f"flash windows per forward {windows}, expected {expect}")
    reqs = make_paged_requests(cfg.vocab)
    eng = ServeEngine(model, params, **dense_kw)
    run = counted_serve(eng, reqs)
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    check_served("hybrid", cfg, reqs)
    launches = hybrid_launches("serve_hybrid", cfg, st, run["launches"])
    check(run["syncs"] == st["prefill_calls"] + st["chunks"],
          f"host syncs {run['syncs']} != prefill groups + decode chunks")
    pair = graphed_vs_eager("serve_hybrid", model, params, eng, run, reqs,
                            make_paged_requests, dense_kw)
    tokens = [r.out for r in reqs]

    # paged for the global layers (rings and SSM state stay lane-resident):
    # two graphed passes, each equal to the dense tokens, the pool drained
    peng = ServeEngine(model, params, **PAGED)
    paged = []
    for _ in range(2):
        preqs = make_paged_requests(cfg.vocab)
        st0 = dict(peng.stats)
        prun = counted_serve(peng, preqs)
        check_served("hybrid paged", cfg, preqs)
        check([r.out for r in preqs] == tokens,
              f"hybrid paged tokens differ from dense: "
              f"{[r.rid for r, t in zip(preqs, tokens) if r.out != t]}")
        peng._pool.assert_drained()
        figures = pass_figures(peng, prun, preqs, st0)
        pst = {k: v - st0.get(k, 0) for k, v in peng.stats.items()
               if not isinstance(v, bool)}
        hybrid_launches("serve_hybrid paged", cfg, pst, prun["launches"])
        check(prun["syncs"] == pst["prefill_calls"] + pst["chunks"],
              f"paged host syncs {prun['syncs']} != prefill groups + "
              f"decode chunks")
        paged.append(figures)
    check(paged[1]["graphs"] == 0,
          f"the paged engine's second pass captured {paged[1]['graphs']}")
    weights = sum(t.nbytes for t in param_tensors(params))
    caches = cache_bytes(eng.cache)
    floor_bytes = weights + sum(caches.values())
    memory = {"weight_bytes": weights, "params": model.param_count(),
              "dense_cache_bytes": caches,
              "paged_cache_bytes": cache_bytes(peng.cache),
              "paged_kv_stats": peng.paged_kv_stats(),
              "graph_pool_bytes": {
                  "dense": pair["graphed"]["graph_pool_bytes"],
                  "paged": peng.graph_pool_bytes()},
              "static_lane_cache_bytes": {
                  "dense": pair["graphed"]["static_lane_cache_bytes"],
                  "paged": sum(t.nbytes for lane in
                               peng._lane_caches.values()
                               for t in cache_tensors(lane))},
              "decode_floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3,
              "decode_floor_is": "weights and dense caches once at the "
                                 "HBM rate"}
    emit("serve_hybrid", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, window=cfg.sliding_window,
         global_layers=list(cfg.global_attn_layers),
         segments=[(seg.name, seg.n, seg.window) for seg in model.segs],
         attention_impl=model.impl, ssd_impl=model.ssd_impl, **PAGED,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=sum(map(len, tokens)),
         wall_s=run["wall_s"], prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         host_syncs=run["syncs"], launches=launches,
         flash_windows_per_forward=windows, graphed_vs_eager=pair,
         paged_passes=paged, paged_recycled=peng.recycled, memory=memory,
         largest_bucket=max(eng._bucket(len(r.prompt)) for r in reqs))
    return reqs, launches


# --------------------------------------------------------------------------
# 17. kernels line
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the HBM rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pod_gemm_rows(cfg, phases, seed: int):
    """The pod GEMMs of one cfg forward (bf16, bf16 out) at each (phase, M,
    iters): per-shape rows, and per phase the sums over one forward (each
    projection once per layer, the head once). A MoE config's FFNs are
    the grouped kernel's, so it has no gate/up/down here."""
    d, vocab = cfg.d_model, cfg.vocab
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    q = cfg.n_heads * cfg.resolved_head_dim
    shapes = {"q": (d, q, None), "k": (d, kv, None), "v": (d, kv, None),
              "o": (q, d, None)}
    if cfg.moe is None:
        shapes.update(gate=(d, cfg.d_ff, "silu"), up=(d, cfg.d_ff, None),
                      down=(cfg.d_ff, d, None))
    shapes["head"] = (d, vocab, None)
    g = torch.Generator("cuda").manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows, worst = [], 0.0
    totals = {ph: dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"),
                                0.0) for ph, _, _ in phases}
    for phase, M, iters in phases:
        for name, (K, N, act) in shapes.items():
            x, w = gemm_inputs(M, K, N, torch.bfloat16, g)
            got = sg.systolic_gemm_cuda(x, w, activation=act,
                                        out_dtype=torch.bfloat16)
            ref = systolic_gemm_ref(x, w, activation=act,
                                    out_dtype=torch.bfloat16)
            err = float((got.double() - ref.double()).abs().max())
            check(TOLERANCES["gemm_bf16out"].ok(got, ref),
                  f"{cfg.name} {phase} {name}: kernel disagrees "
                  f"(max_abs_err {err})")
            worst = max(worst, err)
            del got, ref

            def library(x=x, w=w, act=act):
                y = torch.matmul(x, w)
                return F.silu(y) if act == "silu" else y
            row = {
                "gemm": name, "phase": phase, "M": M, "K": K, "N": N,
                "plan": list(sg.nn_plan(M, N, K, torch.bfloat16, True)),
                "ms": time_ms(lambda: sg.systolic_gemm_cuda(
                    x, w, activation=act, out_dtype=torch.bfloat16),
                    iters, flush),
                "plain_ms": time_ms(lambda: systolic_gemm_ref(
                    x, w, activation=act, out_dtype=torch.bfloat16),
                    iters, flush),
                "library_ms": time_ms(library, iters, flush),
                "max_abs_err": err,
            }
            row["bound_ms"], row["bound_by"] = bound(
                2 * M * N * K, 2 * (M * K + K * N + M * N))
            rows.append(row)
            per_forward = 1 if name == "head" else cfg.n_layers
            for key in totals[phase]:
                totals[phase][key] += per_forward * row[key]
            del x, w
    return rows, totals, worst, (len(shapes) - 1) * cfg.n_layers + 1


def gemm_line(cfg, launches: int, by_mainloop: dict, moe_cfg,
              moe_launches: int, moe_by_mainloop: dict, hybrid_cfg,
              hybrid_table: dict) -> dict:
    """granite-8b's pod GEMMs at decode (M = SLOTS) and a [SLOTS, 256]
    prefill, the line's own numbers; dbrx-132b's q/k/v/o and untied head
    at decode and at its longest exact-length prefill (M = 1277) under
    "moe"; hymba-1.5b's seven projections and untied head at decode and
    at a [SLOTS, 2048] prefill (M = 8192) under "hybrid", the head
    (N = 32001) on wmma. Launches by mainloop are the served runs'."""
    rows, totals, worst, per_fwd = pod_gemm_rows(
        cfg, (("decode", SLOTS, 20), ("prefill", SLOTS * 256, 5)), seed=2)
    moe_rows, moe_totals, moe_worst, moe_per_fwd = pod_gemm_rows(
        moe_cfg, (("decode", SLOTS, 20), ("prefill", 1277, 3)), seed=13)
    h_rows, h_totals, h_worst, h_per_fwd = pod_gemm_rows(
        hybrid_cfg, (("decode", SLOTS, 20), ("prefill", SLOTS * 2048, 3)),
        seed=17)
    head = [r for r in h_rows if r["gemm"] == "head"]
    check(all(r["plan"][0] == "wmma" for r in head),
          f"hymba's head ran {[r['plan'] for r in head]}, not wmma")
    dec = totals["decode"]
    return {
        "name": "systolic_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/systolic_gemm/csrc/systolic_gemm.cu",
        "replaces": "src/repro/kernels/systolic_gemm/systolic_gemm.py:121",
        "launches": launches, "launches_by_mainloop": by_mainloop,
        "max_abs_err": max(worst, moe_worst, h_worst),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": "bytes",
        "library_ms": dec["library_ms"],
        "ms_are": (f"sums over the {per_fwd} pod GEMMs of one {cfg.name} "
                   f"decode step at M={SLOTS} (per-shape rows below, L2 "
                   f"flushed); launches are its dense serve run's"),
        "prefill_forward": totals["prefill"],
        "shapes": rows,
        "moe": {"arch": moe_cfg.name, "n_layers": moe_cfg.n_layers,
                "launches": moe_launches,
                "launches_by_mainloop": moe_by_mainloop,
                "per_forward": moe_per_fwd,
                "decode_forward": moe_totals["decode"],
                "prefill_forward_1277": moe_totals["prefill"],
                "shapes": moe_rows},
        "hybrid": {"arch": hybrid_cfg.name, "n_layers": hybrid_cfg.n_layers,
                   "launches": hybrid_table["launches"],
                   "launches_by_mainloop": hybrid_table["by_mainloop"],
                   "per_forward": h_per_fwd,
                   "decode_forward": h_totals["decode"],
                   "prefill_forward_8192": h_totals["prefill"],
                   "head": head, "shapes": h_rows},
    }


FLASH_SEQS = (256, 2048)     # granite-8b prefill buckets, B = SLOTS


def flash_row(B, S, Hq, Hkv, D, iters: int, g, flush,
              window: int | None = None) -> dict:
    """One causal bf16 launch [B, S, Hq over Hkv, D] (over the last
    `window` keys, if given) on randn inputs: checked against the naive
    and tiled plain versions, then timed beside both and SDPA (with the
    window as a boolean mask: whichever backend PyTorch picks for it),
    with its plan and its rate."""
    q, k, v = (torch.randn((B, S, h, D), generator=g,
                           device="cuda").to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    plan = fa.flash_plan(D, q.dtype)
    mask = dict(causal=True, window=window)
    got = fa.flash_attention_cuda(q, k, v, **mask)
    ref = flash_attention_ref(q, k, v, **mask)
    tiled = flash_attention_tiled_ref(q, k, v, block_k=plan.block_k, **mask)
    err = float((got.double() - ref.double()).abs().max())
    check(TOLERANCES["flash_bf16"].ok(got, ref)
          and TOLERANCES["flash_bf16_tiled_served"].ok(got, tiled),
          f"flash {[B, S, Hq, Hkv, D]} window {window}: kernel disagrees "
          f"(max_abs_err {err})")
    del got, ref, tiled
    sdpa_mask = None
    if window is not None:
        pos = torch.arange(S, device="cuda")
        sdpa_mask = (pos[None, :] <= pos[:, None]) & \
            (pos[:, None] - pos[None, :] < window)

    def library(q=q, k=k, v=v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=sdpa_mask, is_causal=sdpa_mask is None,
            enable_gqa=True)
    # 4 D operations per unmasked (q, k) pair (QK^T and PV): row i sees
    # min(i + 1, window) keys; q, k, v read once, o written once
    pairs = sum(min(i + 1, window or S) for i in range(S))
    flops = 4 * B * Hq * D * pairs
    row = {
        "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "causal": True,
        "window": window, "mainloop": plan.mainloop,
        "block_k": plan.block_k,
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, **mask),
                      iters, flush),
        "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, **mask),
                            2, flush),
        "library_ms": time_ms(library, iters, flush),
        "max_abs_err": err,
    }
    row["tflop_s"] = flops / row["ms"] / 1e9
    row["library_tflop_s"] = flops / row["library_ms"] / 1e9
    row["bound_ms"], row["bound_by"] = bound(
        flops, 2 * B * S * D * (2 * Hq + 2 * Hkv))
    return row


def flash_line(cfg, by_mainloop: dict, moe_cfg, moe_by_mainloop: dict,
               hybrid_cfg, hybrid_table: dict) -> dict:
    """granite-8b's prefill attention at buckets 256 and 2048 (B = SLOTS),
    the line's own numbers (a forward's 36 launches at 2048), and dbrx-
    132b's longest exact-length prefill, [1, 1277, 48 over 8, 128]; under
    "hybrid", hymba-1.5b's [SLOTS, 2048, 25 over 5, 64] with its window
    and global, and their sum over a forward (29 windowed, 3 global).
    Launches by mainloop are the served runs' (granite paged; dbrx under
    "moe"; hymba dense under "hybrid")."""
    g = torch.Generator("cuda").manual_seed(4)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    D = cfg.resolved_head_dim
    rows = [flash_row(SLOTS, S, cfg.n_heads, cfg.n_kv_heads, D, iters, g,
                      flush) for S, iters in zip(FLASH_SEQS, (20, 5))]
    rows.append(flash_row(1, 1277, moe_cfg.n_heads, moe_cfg.n_kv_heads,
                          moe_cfg.resolved_head_dim, 10, g, flush))
    hc = hybrid_cfg
    h_rows = [flash_row(SLOTS, 2048, hc.n_heads, hc.n_kv_heads,
                        hc.resolved_head_dim, 10, g, flush, window=w)
              for w in (hc.sliding_window, None)]
    n_global = len(hc.global_attn_layers)
    n_window = hc.n_layers - n_global
    h_forward = {k: n_window * h_rows[0][k] + n_global * h_rows[1][k]
                 for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    top, L = rows[1], cfg.n_layers
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:72",
        "launches": sum(by_mainloop.values()),
        "launches_by_mainloop": by_mainloop,
        "moe": {"arch": moe_cfg.name, "n_layers": moe_cfg.n_layers,
                "launches_by_mainloop": moe_by_mainloop},
        "hybrid": {"arch": hc.name, "n_layers": hc.n_layers,
                   "launches": hybrid_table["launches"],
                   "launches_by_mainloop": hybrid_table["by_mainloop"],
                   "forward_2048": {**h_forward, "windowed": n_window,
                                    "global": n_global},
                   "shapes": h_rows},
        "max_abs_err": max(r["max_abs_err"] for r in rows + h_rows),
        "ms": L * top["ms"], "plain_ms": L * top["plain_ms"],
        "bound_ms": L * top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": L * top["library_ms"],
        "ms_are": (f"sums over the {L} launches of one {cfg.name} prefill "
                   f"forward at bucket {top['S']} (B={SLOTS}, bf16, causal; "
                   f"per-shape rows below, the last {moe_cfg.name}'s "
                   f"[1, 1277] prefill; L2 flushed)"),
        "shapes": rows,
    }


def gemm_nt_line(cfg, launches: int, by_mainloop: dict,
                 hybrid: dict) -> dict:
    """The tied LM head of cfg (x [M, d] @ tok [vocab, d]^T, bf16 out) at
    decode (M = SLOTS), at a [SLOTS, 256] prefill and at the largest
    bucketed prefill, [SLOTS, 2048] (M = 8192: the head runs over every
    position); one launch per forward. Launches by mainloop are the
    served run's."""
    K, N = cfg.d_model, cfg.vocab
    g = torch.Generator("cuda").manual_seed(8)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows, worst = [], 0.0
    for phase, M, iters in (("decode", SLOTS, 20), ("prefill", SLOTS * 256,
                                                     5),
                            ("prefill", SLOTS * 2048, 3)):
        x, w = gemm_inputs(M, K, N, torch.bfloat16, g, transposed=True)
        got = sg.systolic_gemm_nt_cuda(x, w, out_dtype=torch.bfloat16)
        ref = systolic_gemm_t_ref(x, w, out_dtype=torch.bfloat16)
        err = float((got.double() - ref.double()).abs().max())
        check(TOLERANCES["gemm_bf16out"].ok(got, ref),
              f"NT {phase}: kernel disagrees (max_abs_err {err})")
        worst = max(worst, err)
        row = {
            "phase": phase, "M": M, "K": K, "N": N,
            "plan": list(sg.gemm_plan("nt", M, N, K, torch.bfloat16, True)),
            "ms": time_ms(lambda: sg.systolic_gemm_nt_cuda(
                x, w, out_dtype=torch.bfloat16), iters, flush),
            "plain_ms": time_ms(lambda: systolic_gemm_t_ref(
                x, w, out_dtype=torch.bfloat16), iters, flush),
            "library_ms": time_ms(lambda: torch.matmul(x, w.t()), iters,
                                  flush),
            "max_abs_err": err,
        }
        row["bound_ms"], row["bound_by"] = bound(
            2 * M * N * K, 2 * (M * K + K * N + M * N))
        rows.append(row)
        del x, w, got, ref
    dec = rows[0]
    return {
        "name": "systolic_gemm_nt", "route": "cuda",
        "source": "src/repro_torch/kernels/systolic_gemm/csrc/systolic_gemm.cu",
        "replaces": "src/repro/kernels/systolic_gemm/systolic_gemm.py:249",
        "launches": launches, "launches_by_mainloop": by_mainloop,
        "max_abs_err": worst,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "ms_are": (f"one {cfg.name} LM head at decode, M={SLOTS} (one "
                   f"launch per forward; per-shape rows below, L2 flushed)"),
        "shapes": rows, "hybrid": hybrid,
    }


def ssd_bound(b, S, H, P, G, N, chunk) -> tuple[float, str]:
    """The least time for one SSD call: x, dt, B, C read once and y and the
    final state written once (bf16, dt f32) at the HBM rate, against the
    operations this causal chunk scan needs at the rate of their type:
    C B^T and M x over the lower triangle of each chunk on the bf16 tensor
    cores, C h^T and x^T B in f32 (as the Pallas kernel's dots) on the
    CUDA cores. The larger of the three."""
    nc = -(-S // chunk)
    pairs = b * H * nc * chunk * (chunk + 1) // 2
    bf16_ops = 2 * (N + P) * pairs
    f32_ops = 4 * b * H * nc * chunk * N * P
    nbytes = (2 * 2 * b * S * H * P + 2 * 2 * b * S * G * N + 4 * b * S * H
              + 2 * 4 * H + 2 * b * H * P * N)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(bf16_ops / BF16_FLOP_PER_S,
                               f32_ops / F32_FLOP_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def ssd_split_ms(args, chunk: int, flush: torch.Tensor) -> dict:
    """Device ms of each kernel one SSD call launches (chunked: the chunk
    states, the state pass, the chunk scan), from torch.profiler over 5
    calls, each after an L2 flush."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            ssd_mod.ssd_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"ssd_\w+", e.key)
        if name and e.device_time_total > 0:
            split[name.group(0)] = e.device_time_total / e.count / 1e3
    return split


def ssd_row(cfg, S: int, iters: int, g, flush) -> dict:
    """cfg's SSD call at [SLOTS, S] (bf16) on the mainloop ssd_plan picks,
    checked against the Pallas kernel's arithmetic, then timed beside the
    serial mainloop and the plain version, with its bound and each
    launch's device ms."""
    s = cfg.ssm
    H, P, N, chunk = s.n_heads(cfg.d_model), s.head_dim, s.d_state, \
        s.chunk_size
    shape = (SLOTS, S, H, P, s.n_groups, N)
    args = ssd_inputs(shape, torch.bfloat16, g)
    y, h = ssd_mod.ssd_cuda(*args, chunk=chunk)
    ky, kh = ssd_kernel_ref(*args, chunk=chunk)
    tol = TOLERANCES["ssd_bf16_kernel"]
    err = float((y.double() - ky.double()).abs().max())
    check(tol.ok(y, ky) and tol.ok(h, kh),
          f"ssd {cfg.name} S={S}: kernel disagrees (max_abs_err {err})")
    row = {"b": SLOTS, "S": S, "H": H, "P": P, "G": s.n_groups, "N": N,
           "chunk": chunk,
           "mainloop": ssd_mod.ssd_plan(P, N, chunk, torch.bfloat16),
           "ms": time_ms(lambda: ssd_mod.ssd_cuda(*args, chunk=chunk),
                         iters, flush),
           "serial_ms": time_ms(lambda: ssd_mod.ssd_cuda(
               *args, chunk=chunk, mainloop="serial"), iters, flush),
           "plain_ms": time_ms(lambda: ssd_kernel_ref(*args, chunk=chunk),
                               2, flush),
           "library_ms": None, "max_abs_err": err}
    row["bound_ms"], row["bound_by"] = ssd_bound(*shape, chunk)
    row["split_ms"] = ssd_split_ms(args, chunk, flush)
    return row


def ssd_line(cfg, launches: int, by_mainloop: dict, hybrid_cfg,
             hybrid_table: dict) -> dict:
    """mamba2's SSD call at [SLOTS, 256] and [SLOTS, 2048] (bf16), on the
    mainloop ssd_plan picks, with the serial mainloop (the earlier design)
    timed beside it on the same inputs; under "hybrid", hymba-1.5b's at
    [SLOTS, 2048] (50 heads, N 16: serial) and its forward's 32 launches.
    Launches by mainloop are the served runs'."""
    g = torch.Generator("cuda").manual_seed(9)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows = [ssd_row(cfg, S, iters, g, flush)
            for S, iters in ((256, 20), (2048, 10))]
    h_row = ssd_row(hybrid_cfg, 2048, 10, g, flush)
    check(h_row["mainloop"] == "serial",
          f"hymba's SSD plan is {h_row['mainloop']}, not serial")
    worst = max(r["max_abs_err"] for r in rows + [h_row])
    hL = hybrid_cfg.n_layers
    top, L = rows[-1], cfg.n_layers
    return {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:70",
        "launches": launches, "launches_by_mainloop": by_mainloop,
        "mainloop": top["mainloop"], "max_abs_err": worst,
        "ms": L * top["ms"], "plain_ms": L * top["plain_ms"],
        "bound_ms": L * top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "serial_ms": L * top["serial_ms"],
        "ms_are": (f"sums over the {L} launches of one {cfg.name} prefill "
                   f"forward at bucket {top['S']} (b={SLOTS}, bf16, on "
                   f"{top['mainloop']}; serial_ms the serial mainloop on the "
                   f"same inputs; per-shape rows below, L2 flushed; no "
                   f"single PyTorch call computes the chunk scan)"),
        "shapes": rows,
        "hybrid": {"arch": hybrid_cfg.name, "n_layers": hL,
                   "launches": hybrid_table["launches"],
                   "launches_by_mainloop": hybrid_table["by_mainloop"],
                   "forward_2048": {k: hL * h_row[k] for k in
                                    ("ms", "plain_ms", "bound_ms")},
                   "shapes": [h_row]},
    }


def grouped_line(cfg, launches: int, by_mainloop: dict,
                 hybrid: dict) -> dict:
    """dbrx's expert GEMMs (bf16, bf16 out): one decode step's three
    projections at M = 1 row per expert (x MOE_LAYERS layers = 24
    launches), and the up and down projections of a 1024-token prefill at
    M = 320; up at M = 384 too, the same three 128-row tiles per expert
    without the padding, shows what padding 320 rows costs. The library
    yardstick is torch.bmm of the same G GEMMs, plus SiLU for the gate.
    Launches by mainloop are the served run's."""
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    shapes = [("decode", "up", 1, d, f, None), ("decode", "gate", 1, d, f,
                                                "silu"),
              ("decode", "down", 1, f, d, None),
              ("prefill", "up", 320, d, f, None),
              ("prefill", "down", 320, f, d, None),
              ("prefill", "up", 384, d, f, None)]
    g = torch.Generator("cuda").manual_seed(12)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows, worst = [], 0.0
    for phase, name, M, K, N, act in shapes:
        x, w = grouped_inputs(E, M, K, N, torch.bfloat16, g)
        got = sg.grouped_systolic_gemm_cuda(x, w, activation=act,
                                            out_dtype=torch.bfloat16)
        ref = grouped_systolic_gemm_ref(x, w, activation=act,
                                        out_dtype=torch.bfloat16)
        err = float((got.double() - ref.double()).abs().max())
        check(TOLERANCES["gemm_bf16out"].ok(got, ref),
              f"grouped {phase} {name}: kernel disagrees (max_abs_err {err})")
        worst = max(worst, err)
        del got, ref

        def library(x=x, w=w, act=act):
            y = torch.bmm(x, w)
            return F.silu(y) if act == "silu" else y
        iters = 20 if phase == "decode" else 5
        row = {"gemm": name, "phase": phase, "G": E, "M": M, "K": K, "N": N,
               "plan": list(sg.gemm_plan("grouped", M, N, K, torch.bfloat16,
                                         True)),
               "ms": time_ms(lambda: sg.grouped_systolic_gemm_cuda(
                   x, w, activation=act, out_dtype=torch.bfloat16),
                   iters, flush),
               "plain_ms": time_ms(lambda: grouped_systolic_gemm_ref(
                   x, w, activation=act, out_dtype=torch.bfloat16), 3,
                   flush),
               "library_ms": time_ms(library, iters, flush),
               "max_abs_err": err}
        row["bound_ms"], row["bound_by"] = bound(
            2 * E * M * N * K, 2 * E * (M * K + K * N + M * N))
        rows.append(row)
        del x, w
    L = cfg.n_layers
    dec = {k: L * sum(r[k] for r in rows if r["phase"] == "decode")
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return {
        "name": "grouped_systolic_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/systolic_gemm/csrc/systolic_gemm.cu",
        "replaces": "src/repro/kernels/systolic_gemm/systolic_gemm.py:182",
        "launches": launches, "launches_by_mainloop": by_mainloop,
        "max_abs_err": worst,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": "bytes",
        "library_ms": dec["library_ms"],
        "ms_are": (f"sums over the {3 * L} grouped launches of one "
                   f"{cfg.name} ({L} layers) decode step, M = 1 row per "
                   f"expert (per-shape rows below, the prefill rows per "
                   f"launch; L2 flushed)"),
        "shapes": rows, "hybrid": hybrid,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        phase_build()
        phase_kernel()
        torch.cuda.synchronize()
        phase_gemm_nt()
        torch.cuda.synchronize()
        phase_flash()
        torch.cuda.synchronize()
        phase_ssd()
        torch.cuda.synchronize()
        phase_grouped()
        torch.cuda.synchronize()

        cfg = get_arch(ARCH)
        t0 = time.perf_counter()
        model = Model(cfg, use_pallas=True)
        flash_model = Model(cfg, attention_impl="pallas", use_pallas=True)
        params = model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=cfg.name, params=model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)

        served, launches, by_mainloop = phase_serve(model, params)
        torch.cuda.synchronize()
        phase_oracle(model, params, served)
        torch.cuda.synchronize()
        paged, flash_by_mainloop = phase_serve_paged(flash_model, params)
        torch.cuda.synchronize()
        phase_paged_oracle(flash_model, params, paged)
        torch.cuda.synchronize()
        phase_serve_controls(model, flash_model, params)
        torch.cuda.synchronize()
        phase_launch_serve()
        torch.cuda.synchronize()
        del params
        torch.cuda.empty_cache()

        ssm_cfg = get_arch(SSM_ARCH)
        t0 = time.perf_counter()
        ssm_model = Model(ssm_cfg, ssd_impl="pallas", use_pallas=True)
        ssm_params = ssm_model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=ssm_cfg.name, params=ssm_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        ssm_served, ssm_launches = phase_serve_ssm(ssm_model, ssm_params)
        torch.cuda.synchronize()
        phase_ssm_oracle(ssm_model, ssm_params, ssm_served)
        torch.cuda.synchronize()
        del ssm_params
        torch.cuda.empty_cache()

        moe_cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
        t0 = time.perf_counter()
        moe_model = Model(moe_cfg, attention_impl="pallas", use_pallas=True)
        moe_params = moe_model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=moe_cfg.name, n_layers=MOE_LAYERS,
             of_layers=get_arch(MOE_ARCH).n_layers,
             params=moe_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        _, moe_launches = phase_serve_moe(moe_model, moe_params)
        torch.cuda.synchronize()
        phase_moe_oracle(moe_model, moe_params)
        torch.cuda.synchronize()
        emit("moe_memory",
             gib_peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        del moe_params
        torch.cuda.empty_cache()

        hybrid_cfg = get_arch(HYBRID_ARCH)
        t0 = time.perf_counter()
        hybrid_model = Model(hybrid_cfg, attention_impl="pallas",
                             ssd_impl="pallas", use_pallas=True)
        hybrid_params = hybrid_model.init(
            torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=hybrid_cfg.name, params=hybrid_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        hybrid_served, hybrid = phase_serve_hybrid(hybrid_model,
                                                   hybrid_params)
        torch.cuda.synchronize()
        phase_ssm_oracle(hybrid_model, hybrid_params, hybrid_served,
                         phase="hybrid_oracle")
        torch.cuda.synchronize()
        del hybrid_params
        torch.cuda.empty_cache()

        kernels = {"kernels": [gemm_line(
            cfg, launches, by_mainloop, moe_cfg, moe_launches["pod_gemm"],
            moe_launches["pod_gemm_by_mainloop"], hybrid_cfg,
            hybrid["pod_gemm"]),
                               flash_line(cfg, flash_by_mainloop, moe_cfg,
                                          moe_launches["flash_by_mainloop"],
                                          hybrid_cfg, hybrid["flash"]),
                               gemm_nt_line(
                                   ssm_cfg, ssm_launches["gemm_nt"],
                                   ssm_launches["gemm_nt_by_mainloop"],
                                   hybrid["gemm_nt"]),
                               ssd_line(ssm_cfg, ssm_launches["ssd"],
                                        ssm_launches["ssd_by_mainloop"],
                                        hybrid_cfg, hybrid["ssd"]),
                               grouped_line(
                                   moe_cfg, moe_launches["grouped"],
                                   moe_launches["grouped_by_mainloop"],
                                   hybrid["grouped"])]}
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
