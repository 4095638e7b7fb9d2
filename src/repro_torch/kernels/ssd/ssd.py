"""ctypes wrapper of the Hopper SSD chunk-scan kernel (csrc/ssd.cu).

`ssd_cuda` checks its inputs, allocates y and the final state, launches
the kernel on PyTorch's current stream and raises if the launch failed.
It takes only CUDA tensors: the plain version for CPU tensors is chosen in
ops.py, never here. `ssd_cuda.launches` counts its launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import build

SOURCES = [Path(__file__).with_name("csrc") / "ssd.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build("ssd", SOURCES)
    lib.ssd_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    lib.ssd_launch.restype = ctypes.c_int
    lib.ssd_run_chunk.argtypes = [ctypes.c_int] * 4
    lib.ssd_run_chunk.restype = ctypes.c_int
    return lib


def run_chunk(chunk: int, P: int, N: int, dtype: torch.dtype) -> int:
    """The chunk the kernel runs for `chunk`: itself, or in f32 where its
    tiles pass a block's shared memory the largest divisor that is a
    multiple of 16 and fits (128 at mamba2's P 64, N 128). 0 if none."""
    return _lib().ssd_run_chunk(chunk, P, N, _DTYPES[dtype])


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [b,S,H,P], h_final [b,H,P,N]), both in x's dtype, on the card.
    x [b,S,H,P] and B, C [b,S,G,N] (G | H) share float32 or bfloat16;
    dt [b,S,H], A and D [H] are float32; S is a multiple of chunk; all
    contiguous on one CUDA device."""
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (dt, A, B, C, D)):
        raise ValueError(f"ssd_cuda needs every input on one CUDA device, "
                         f"got x on {x.device}")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x must be [b,S,H,P] and B, C [b,S,G,N], got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B and C must share one of {list(_DTYPES)}, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    shapes = {"B": (B, (b, S, G, N)), "C": (C, (b, S, G, N)),
              "dt": (dt, (b, S, H)), "A": (A, (H,)), "D": (D, (H,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if name in ("dt", "A", "D") and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C, D)):
        raise ValueError("every input must be contiguous")
    if H % G or chunk <= 0 or S % chunk or not 0 < P <= 128:
        raise ValueError(f"unsupported SSD shape H={H} G={G} P={P} S={S} "
                         f"chunk={chunk} (G | H, chunk | S, P <= 128)")
    y = torch.empty_like(x)
    h_final = torch.empty((b, H, P, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().ssd_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                           B.data_ptr(), C.data_ptr(), D.data_ptr(),
                           y.data_ptr(), h_final.data_ptr(), b, S, H, P, G,
                           N, chunk, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed with CUDA error {rc} "
                           f"(x {tuple(x.shape)}, N={N}, chunk={chunk}, "
                           f"{x.dtype}; error 1 is also a chunk whose "
                           f"tiles exceed a block's shared memory)")
    ssd_cuda.launches += 1
    return y, h_final


ssd_cuda.launches = 0
