"""ctypes wrappers of the Hopper pod-GEMM kernels (csrc/systolic_gemm.cu).

`systolic_gemm_cuda` (w [K, N]), `systolic_gemm_nt_cuda` (w [N, K], read
in that layout: the tied LM head) and `grouped_systolic_gemm_cuda` (G
independent GEMMs x [G, M, K] @ w [G, K, N] in one launch: the MoE
experts) check their inputs, allocate the output, launch the kernel on
PyTorch's current stream and raise if the launch failed. They take only
CUDA tensors: the plain version for CPU tensors is chosen in ops.py,
never here. Each counts its own launches in `.launches`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import build

SOURCES = [Path(__file__).with_name("csrc") / "systolic_gemm.cu"]
ACTIVATIONS = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "relu2": 4}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build("systolic_gemm", SOURCES)
    for fn in (lib.systolic_gemm_launch, lib.systolic_gemm_nt_launch):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.grouped_systolic_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_vec(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 "
                         f"{list(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, scale, bias, activation,
            out_dtype, form: str) -> torch.Tensor:
    """form: "nn" (x [M, K], w [K, N]), "nt" (w [N, K]) or "grouped"
    (x [G, M, K], w [G, K, N], scale/bias [G, N])."""
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
             ACTIVATIONS[activation],
             torch.cuda.current_stream(x.device).cuda_stream]
    fn = {"nn": lib.systolic_gemm_launch, "nt": lib.systolic_gemm_nt_launch,
          "grouped": lib.grouped_systolic_gemm_launch}[form]
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} (G={G} M={M} K={K} N={N}, {x.dtype})")
    return out


def systolic_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                       scale: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None, *,
                       activation: str | None = None,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """act((x @ w) * scale + bias) -> out_dtype on the card.
    x [M, K], w [K, N]: both float32, both bfloat16 or both int8,
    contiguous, on one CUDA device. scale, bias: float32 [N] or None."""
    out = _launch(x, w, scale, bias, activation, out_dtype, "nn")
    systolic_gemm_cuda.launches += 1
    return out


def systolic_gemm_nt_cuda(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None, *,
                          activation: str | None = None,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """act((x @ w^T) * scale + bias) -> out_dtype on the card, with w
    [N, K] read in its stored layout (no transpose copy). Otherwise as
    systolic_gemm_cuda."""
    out = _launch(x, w, scale, bias, activation, out_dtype, "nt")
    systolic_gemm_nt_cuda.launches += 1
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
    refuses G > 65535 (the grid's z limit), and this raises."""
    out = _launch(x, w, scale, bias, activation, out_dtype, "grouped")
    grouped_systolic_gemm_cuda.launches += 1
    return out


systolic_gemm_cuda.launches = 0
systolic_gemm_nt_cuda.launches = 0
grouped_systolic_gemm_cuda.launches = 0
