"""ctypes wrappers of the Hopper pod-GEMM kernels (csrc/systolic_gemm.cu).

`systolic_gemm_cuda` (w [K, N]) and `systolic_gemm_nt_cuda` (w [N, K],
read in that layout: the tied LM head) check their inputs, allocate the
output, launch the kernel on PyTorch's current stream and raise if the
launch failed. They take only CUDA tensors: the plain version for CPU
tensors is chosen in ops.py, never here. Each counts its own launches in
`.launches`.
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
    return lib


def _check_vec(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 [{n}] tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, scale, bias, activation,
            out_dtype, transposed: bool) -> torch.Tensor:
    name = "systolic_gemm_nt_cuda" if transposed else "systolic_gemm_cuda"
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} needs x and w on one CUDA device, got "
                         f"{x.device} and {w.device}")
    k_axis = 1 if transposed else 0
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[k_axis]:
        form = "[M, K] @ [N, K]^T" if transposed else "[M, K] @ [K, N]"
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(w.shape)} do "
                         f"not form {form}")
    if x.dtype != w.dtype or x.dtype not in _IN_DTYPES:
        raise ValueError(f"x and w must share one of {list(_IN_DTYPES)}, "
                         f"got {x.dtype} and {w.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {list(_OUT_DTYPES)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    M, K = x.shape
    N = w.shape[1 - k_axis]
    if min(M, K, N) <= 0 or max(M, K, N) >= 2 ** 31:
        raise ValueError(f"unsupported GEMM size M={M} K={K} N={N}")
    for vname, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            _check_vec(vname, t, N, x.device)
    lib = _lib()
    fn = lib.systolic_gemm_nt_launch if transposed else \
        lib.systolic_gemm_launch
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), M, N, K, _IN_DTYPES[x.dtype],
            _OUT_DTYPES[out_dtype], ACTIVATIONS[activation], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} (M={M} K={K} N={N}, {x.dtype})")
    return out


def systolic_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                       scale: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None, *,
                       activation: str | None = None,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """act((x @ w) * scale + bias) -> out_dtype on the card.
    x [M, K], w [K, N]: both float32, both bfloat16 or both int8,
    contiguous, on one CUDA device. scale, bias: float32 [N] or None."""
    out = _launch(x, w, scale, bias, activation, out_dtype, False)
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
    out = _launch(x, w, scale, bias, activation, out_dtype, True)
    systolic_gemm_nt_cuda.launches += 1
    return out


systolic_gemm_cuda.launches = 0
systolic_gemm_nt_cuda.launches = 0
