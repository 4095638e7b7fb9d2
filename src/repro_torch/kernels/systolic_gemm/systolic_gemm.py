"""ctypes wrappers of the Hopper pod-GEMM kernels (csrc/systolic_gemm.cu).

`systolic_gemm_cuda` (w [K, N]), `systolic_gemm_nt_cuda` (w [N, K], read
in that layout: the tied LM head) and `grouped_systolic_gemm_cuda` (G
independent GEMMs x [G, M, K] @ w [G, K, N] in one launch: the MoE
experts) check their inputs, allocate the output, launch the kernel on
PyTorch's current stream and raise if the launch failed. They take only
CUDA tensors: the plain version for CPU tensors is chosen in ops.py,
never here. Each counts its own launches in `.launches` and splits that
count by mainloop in `.mainloop_launches`.

Every form picks its mainloop by shape with `gemm_plan`, a pure function
the CPU tests read (bf16: splitk at decode, wgmma at prefill; the grouped
form keeps wmma at M <= 64); the kernel takes the plan as plain ints.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import build

SOURCES = [Path(__file__).with_name("csrc") / "systolic_gemm.cu"]
ACTIVATIONS = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "relu2": 4}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAINLOOPS = {"wmma": 0, "splitk": 1, "wgmma": 2, "simt": 3}

# The splitk mainloop (csrc: SK_BK): K advances in steps of 32 rows of w,
# and a split keeps at least SPLITK_MIN_K of K. It aims for two blocks per
# SM of an H100 SXM (132 SMs) in flight.
SPLITK_MAX_M = 64
SPLITK_K_STEP = 32
SPLITK_MIN_K = 256
SPLITK_TARGET_BLOCKS = 2 * 132
WGMMA_BLOCK_N = 128     # the wgmma mainloop's tile is 128 x 128


FORMS = ("nn", "nt", "grouped")


class GemmPlan(NamedTuple):
    mainloop: str        # "splitk", "wgmma", "wmma" or "simt"
    splits: int          # K ranges summed apart (splitk, wgmma); else 1
    block_n: int         # columns per splitk or wgmma block; else 0


@functools.lru_cache(maxsize=1024)
def gemm_plan(form: str, M: int, N: int, K: int, dtype: torch.dtype,
              aligned: bool) -> GemmPlan:
    """The mainloop of one launch of `form` ("nn": x [M, K] @ w [K, N];
    "nt": w [N, K]; "grouped": M rows per group, w [G, K, N]) in `dtype`,
    with x and w 16-byte aligned when `aligned`:

    * splitk: NN and NT, bf16, M <= 64, K and N multiples of 8, aligned
      (decode);
    * wgmma: every form, bf16, M > 64, the same alignment, which TMA
      needs (prefill);
    * wmma: every other bf16 shape (the ragged ones, and the grouped form
      at M <= 64, which reads its experts near the byte bound there);
    * simt: f32 and int8.

    splitk and wgmma sum K in the same `splits` ranges, which depend on N
    and K only, never on M or the form, so a row's result is bit-equal at
    every M and a grouped launch with G = 1 equals the NN launch (the
    kernel's header says why): the smallest power of two of K ranges
    that brings splitk's blocks (strips of 128 columns, 64 where 128
    cannot reach the target) to SPLITK_TARGET_BLOCKS while each range
    keeps SPLITK_MIN_K of K; then the most ranges, up to that many, that
    are all non-empty and each an even number of k-steps."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if dtype != torch.bfloat16:
        return GemmPlan("simt", 1, 0)
    if not (aligned and K % 8 == 0 and N % 8 == 0):
        return GemmPlan("wmma", 1, 0)
    max_splits = max(1, K // SPLITK_MIN_K)
    block_n = 128
    if math.ceil(N / 128) * max_splits < SPLITK_TARGET_BLOCKS:
        block_n = 64
    strips = math.ceil(N / block_n)
    splits = 1
    while strips * splits < SPLITK_TARGET_BLOCKS and 2 * splits <= max_splits:
        splits *= 2
    # the most ranges, at most that many, none empty, each an even number
    # of k-steps (wgmma adds the ranges between its 64-deep stages)
    steps = math.ceil(K / SPLITK_K_STEP)
    for s in range(splits, 0, -1):
        per = math.ceil(steps / s)
        if (s - 1) * per < steps and (s == 1 or per % 2 == 0):
            splits = s
            break
    if M > SPLITK_MAX_M:
        return GemmPlan("wgmma", splits, WGMMA_BLOCK_N)
    if form == "grouped":
        return GemmPlan("wmma", 1, 0)
    return GemmPlan("splitk", splits, block_n)


def nn_plan(M: int, N: int, K: int, dtype: torch.dtype,
            aligned: bool) -> GemmPlan:
    """gemm_plan of the NN form."""
    return gemm_plan("nn", M, N, K, dtype, aligned)


def splitk_ranges(K: int, splits: int) -> list[tuple[int, int]]:
    """The [start, stop) of K that each split range of a splitk or wgmma
    launch sums: as the kernel cuts them, ceil(steps / splits) k-steps
    each."""
    steps = math.ceil(K / SPLITK_K_STEP)
    per = math.ceil(steps / splits)
    return [(i * per * SPLITK_K_STEP, min(K, (i + 1) * per * SPLITK_K_STEP))
            for i in range(splits)]


def _lib() -> ctypes.CDLL:
    lib = build("systolic_gemm", SOURCES)
    fn = lib.systolic_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn = lib.systolic_gemm_nt_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn = lib.grouped_systolic_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# Per device: the split-K workspace (f32 partials, grown on demand) and the
# strips' arrival counters (zeroed once here; every launch leaves them 0).
# Growing replaces a tensor, so it must not happen while a CUDA graph is
# captured: the graph would keep writing the freed one. A shape runs
# eagerly first (serve/graphs.py warms up before it captures), and a graph
# keeps a reference to the tensors it captured (`workspaces`).
_SPLITK_SCRATCH: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _splitk_scratch(device: torch.device, floats: int, strips: int):
    ws, counters = _SPLITK_SCRATCH.get(device, (None, None))
    grow_ws = ws is None or ws.numel() < floats
    grow_counters = counters is None or counters.numel() < strips
    if (grow_ws or grow_counters) and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"the split-K workspace would grow (to {floats} floats, "
            f"{strips} counters) during CUDA graph capture; run the shape "
            f"eagerly before capturing it")
    if grow_ws:
        ws = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                         device=device)
    if grow_counters:
        counters = torch.zeros(max(strips, 4096), dtype=torch.int32,
                               device=device)
    _SPLITK_SCRATCH[device] = (ws, counters)
    return ws, counters


def workspaces(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The split-K workspace and counters on `device` now (none before a
    split-K launch): what a graph captured with them must keep alive."""
    return _SPLITK_SCRATCH.get(device, ())


def _check_vec(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 "
                         f"{list(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, scale, bias, activation,
            out_dtype, form: str) -> tuple[torch.Tensor, GemmPlan]:
    """form: "nn" (x [M, K], w [K, N]), "nt" (w [N, K]) or "grouped"
    (x [G, M, K], w [G, K, N], scale/bias [G, N]). Returns the output and
    the plan it ran."""
    name = {"nn": "systolic_gemm_cuda", "nt": "systolic_gemm_nt_cuda",
            "grouped": "grouped_systolic_gemm_cuda"}[form]
    grouped = form == "grouped"
    rank = 3 if grouped else 2
    k_axis = -1 if form == "nt" else -2
    if x.dim() != rank or w.dim() != rank or \
            x.shape[-1] != w.shape[k_axis] or x.shape[:-2] != w.shape[:-2]:
        want = {"nn": "[M, K] @ [K, N]", "nt": "[M, K] @ [N, K]^T",
                "grouped": "[G, M, K] @ [G, K, N]"}[form]
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(w.shape)} do "
                         f"not form {want}")
    if x.dtype != w.dtype or x.dtype not in _IN_DTYPES:
        raise ValueError(f"x and w must share one of {list(_IN_DTYPES)}, "
                         f"got {x.dtype} and {w.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {list(_OUT_DTYPES)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    G = x.shape[0] if grouped else 1
    M, K = x.shape[-2:]
    N = w.shape[-2] if form == "nt" else w.shape[-1]
    if min(M, K, N) <= 0 or max(M, K, N) >= 2 ** 31:
        raise ValueError(f"unsupported GEMM size M={M} K={K} N={N}")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} needs x and w on one CUDA device, got "
                         f"{x.device} and {w.device}")
    lead = (G,) if grouped else ()
    for vname, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            _check_vec(vname, t, lead + (N,), x.device)
    lib = _lib()
    out = torch.empty(lead + (M, N), dtype=out_dtype, device=x.device)
    args = [x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr()]
    args += [G, M, N, K] if grouped else [M, N, K]
    args += [_IN_DTYPES[x.dtype], _OUT_DTYPES[out_dtype],
             ACTIVATIONS[activation]]
    plan = gemm_plan(form, M, N, K, x.dtype, x.data_ptr() % 16 == 0
                     and w.data_ptr() % 16 == 0)
    args += [MAINLOOPS[plan.mainloop], plan.splits, plan.block_n]
    if not grouped:
        ws = counters = None
        if plan.mainloop == "splitk" and plan.splits > 1:
            strips = -(-N // plan.block_n)
            ws, counters = _splitk_scratch(
                x.device, strips * plan.block_n * plan.splits * M, strips)
        args += [None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr()]
    args.append(torch.cuda.current_stream(x.device).cuda_stream)
    fn = {"nn": lib.systolic_gemm_launch, "nt": lib.systolic_gemm_nt_launch,
          "grouped": lib.grouped_systolic_gemm_launch}[form]
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} (G={G} M={M} K={K} N={N}, {x.dtype}, "
                           f"{plan})")
    return out, plan


def systolic_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                       scale: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None, *,
                       activation: str | None = None,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """act((x @ w) * scale + bias) -> out_dtype on the card.
    x [M, K], w [K, N]: both float32, both bfloat16 or both int8,
    contiguous, on one CUDA device. scale, bias: float32 [N] or None.
    The mainloop is gemm_plan's; a split-K launch uses this module's
    per-device workspace, so launches on one device share one stream."""
    out, plan = _launch(x, w, scale, bias, activation, out_dtype, "nn")
    systolic_gemm_cuda.launches += 1
    systolic_gemm_cuda.mainloop_launches[plan.mainloop] += 1
    return out


def systolic_gemm_nt_cuda(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None, *,
                          activation: str | None = None,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """act((x @ w^T) * scale + bias) -> out_dtype on the card, with w
    [N, K] read in its stored layout (no transpose copy). Otherwise as
    systolic_gemm_cuda (gemm_plan's "nt" mainloop)."""
    out, plan = _launch(x, w, scale, bias, activation, out_dtype, "nt")
    systolic_gemm_nt_cuda.launches += 1
    systolic_gemm_nt_cuda.mainloop_launches[plan.mainloop] += 1
    return out


def grouped_systolic_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                               scale: torch.Tensor | None = None,
                               bias: torch.Tensor | None = None, *,
                               activation: str | None = None,
                               out_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """G independent act((x[g] @ w[g]) * scale[g] + bias[g]) -> out_dtype
    in one launch on the card. x [G, M, K], w [G, K, N] (one dtype as in
    systolic_gemm_cuda), scale, bias: float32 [G, N] or None. The kernel
    refuses G > 65535 (the grid's z limit), and this raises. The mainloop
    is gemm_plan's "grouped" one."""
    out, plan = _launch(x, w, scale, bias, activation, out_dtype, "grouped")
    grouped_systolic_gemm_cuda.launches += 1
    grouped_systolic_gemm_cuda.mainloop_launches[plan.mainloop] += 1
    return out


for _fn in (systolic_gemm_cuda, systolic_gemm_nt_cuda,
            grouped_systolic_gemm_cuda):
    _fn.launches = 0
    _fn.mainloop_launches = dict.fromkeys(MAINLOOPS, 0)
