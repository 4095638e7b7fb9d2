"""ctypes wrapper of the Hopper SSD chunk-scan kernel (csrc/ssd.cu).

`ssd_cuda` checks its inputs, allocates y and the final state, launches
the kernel on PyTorch's current stream and raises if the launch failed.
It takes only CUDA tensors: the plain version for CPU tensors is chosen in
ops.py, never here. `ssd_cuda.launches` counts its calls and
`.mainloop_launches` splits that count by mainloop.

The mainloop comes from `ssd_plan(P, N, chunk, dtype)`, a pure function
the CPU tests read: `chunked` (chunk states in parallel, a sequential f32
state pass, the chunk scan on every SM; three launches a call) for bf16 at
mamba2's tiles, `serial` (one block per (batch, head) walking its chunks)
for f32 and every other shape. x, B and C are read by stride (the views
the model splits off one projection), with the last dim contiguous.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import build

SOURCES = [Path(__file__).with_name("csrc") / "ssd.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAINLOOPS = {"serial": 0, "chunked": 1}
CHUNKED_TILES = (64, 128, 256)   # P, N, chunk: csrc ck::P, ck::N, ck::C


def ssd_plan(P: int, N: int, chunk: int, dtype: torch.dtype) -> str:
    """The mainloop of a launch at head dim P, state dim N and `chunk`:

    * chunked: bf16 at (P, N, chunk) = (64, 128, 256), mamba2's tiles;
    * serial: f32 (in 128-token sub-chunks where a chunk's f32 tiles pass
      a block's shared memory) and every other bf16 shape.

    The plan depends on these four alone, never on b or S, and each
    mainloop sums in an order fixed by P, N and the chunk: a prompt's rows
    are bit-equal alone and in a bucket."""
    if dtype not in _DTYPES:
        raise ValueError(f"ssd takes {list(_DTYPES)}, got {dtype}")
    if dtype == torch.bfloat16 and (P, N, chunk) == CHUNKED_TILES:
        return "chunked"
    return "serial"


def resolve_mainloop(P: int, N: int, chunk: int, dtype: torch.dtype,
                     mainloop: str | None) -> str:
    """ssd_plan's mainloop, or the one asked for: serial at any shape,
    chunked only where the plan picks it."""
    plan = ssd_plan(P, N, chunk, dtype)
    if mainloop is None:
        return plan
    if mainloop not in MAINLOOPS or (mainloop == "chunked" and
                                     plan != "chunked"):
        raise ValueError(f"mainloop {mainloop!r} does not take P={P} N={N} "
                         f"chunk={chunk} {dtype} (plan {plan!r})")
    return mainloop


def _lib() -> ctypes.CDLL:
    lib = build("ssd", SOURCES)
    lib.ssd_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
        [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.ssd_launch.restype = ctypes.c_int
    lib.ssd_run_chunk.argtypes = [ctypes.c_int] * 4
    lib.ssd_run_chunk.restype = ctypes.c_int
    return lib


def run_chunk(chunk: int, P: int, N: int, dtype: torch.dtype) -> int:
    """The chunk the kernel runs for `chunk`: itself, or in f32 where its
    tiles pass a block's shared memory the largest divisor that is a
    multiple of 16 and fits (128 at mamba2's P 64, N 128). 0 if none."""
    return _lib().ssd_run_chunk(chunk, P, N, _DTYPES[dtype])


def check_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                 chunk: int) -> None:
    """Raises ValueError on what ssd_cuda does not take. x [b,S,H,P] and
    B, C [b,S,G,N] (G | H) share float32 or bfloat16 and may be strided
    views: any batch and row strides, head (group) stride P (N), last dim
    contiguous. dt [b,S,H], A and D [H] are contiguous float32; S is a
    multiple of chunk."""
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
    if not all(t.is_contiguous() for t in (dt, A, D)):
        raise ValueError("dt, A and D must be contiguous")
    for name, t, inner in (("x", x, P), ("B", B, N), ("C", C, N)):
        if t.stride(3) != 1 or t.stride(2) != inner or min(t.stride()) < 0:
            raise ValueError(f"{name} must have a contiguous last dim and "
                             f"head/group stride {inner}, got strides "
                             f"{t.stride()}")
    if H % G or chunk <= 0 or S % chunk or not 0 < P <= 128:
        raise ValueError(f"unsupported SSD shape H={H} G={G} P={P} S={S} "
                         f"chunk={chunk} (G | H, chunk | S, P <= 128)")


def _vector_ready(t: torch.Tensor) -> bool:
    """16-byte aligned at every row: what the chunked mainloop's 16-byte
    loads need."""
    return t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and \
        t.stride(1) % 8 == 0


# Per device: the chunked mainloop's f32 workspace (each chunk's state,
# then h_prev in place; exp(cum_end) after them), grown on demand. Launches
# on one device share one stream, as the pod GEMM's split-K workspace, and
# as there, growing raises during a CUDA graph capture (the graph would
# keep writing the replaced tensor): a shape runs eagerly first.
_WORKSPACE: dict[torch.device, torch.Tensor] = {}


def _workspace(device: torch.device, floats: int) -> torch.Tensor:
    ws = _WORKSPACE.get(device)
    if ws is None or ws.numel() < floats:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the SSD workspace would grow (to {floats} floats) during "
                f"CUDA graph capture; run the shape eagerly before "
                f"capturing it")
        ws = torch.empty(floats, dtype=torch.float32, device=device)
        _WORKSPACE[device] = ws
    return ws


def workspaces(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The chunked mainloop's workspace on `device` now (none before a
    chunked launch): what a graph captured with it must keep alive."""
    ws = _WORKSPACE.get(device)
    return () if ws is None else (ws,)


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int, mainloop: str | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [b,S,H,P], h_final [b,H,P,N]), both contiguous in x's dtype, on
    the card; inputs as check_inputs takes them, on one CUDA device. The
    mainloop is ssd_plan's; `mainloop="serial"` runs the serial one on any
    shape (to time it beside the plan's), and a mainloop the dtype or shape
    does not allow raises."""
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (dt, A, B, C, D)):
        raise ValueError(f"ssd_cuda needs every input on one CUDA device, "
                         f"got x on {x.device}")
    check_inputs(x, dt, A, B, C, D, chunk=chunk)
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    mainloop = resolve_mainloop(P, N, chunk, x.dtype, mainloop)
    ws = None
    if mainloop == "chunked":
        # a view whose rows are not 16-byte aligned is copied, once
        x, B, C = (t if _vector_ready(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (x, B, C))
        ws = _workspace(x.device, b * H * (S // chunk) * (P * N + 1))
    y = torch.empty((b, S, H, P), dtype=x.dtype, device=x.device)
    h_final = torch.empty((b, H, P, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().ssd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), y.data_ptr(), h_final.data_ptr(),
        None if ws is None else ws.data_ptr(), b, S, H, P, G, N, chunk,
        x.stride(0), x.stride(1), B.stride(0), B.stride(1), C.stride(0),
        C.stride(1), _DTYPES[x.dtype], MAINLOOPS[mainloop], stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed with CUDA error {rc} "
                           f"(x {tuple(x.shape)}, N={N}, chunk={chunk}, "
                           f"{x.dtype}, {mainloop}; error 1 is also a chunk "
                           f"whose tiles exceed a block's shared memory)")
    ssd_cuda.launches += 1
    ssd_cuda.mainloop_launches[mainloop] += 1
    return y, h_final


ssd_cuda.launches = 0
ssd_cuda.mainloop_launches = dict.fromkeys(MAINLOOPS, 0)
