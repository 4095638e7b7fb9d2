"""ctypes wrapper of the Hopper flash-attention kernel
(csrc/flash_attention.cu).

`flash_attention_cuda` checks its inputs, allocates the output, launches the
kernel on PyTorch's current stream and raises if the launch failed. It
takes only CUDA tensors: the plain version for CPU tensors is chosen in
ops.py, never here. `flash_attention_cuda.launches` counts its launches and
`.mainloop_launches` splits that count by mainloop.

The mainloop and its tiles come from `flash_plan(D, dtype)`, a pure
function the CPU tests read (bf16: wgmma at D = 64 and 128, mma at every
other D; f32: simt); the kernel takes the plan as plain ints.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import build

SOURCES = [Path(__file__).with_name("csrc") / "flash_attention.cu"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAINLOOPS = {"mma": 0, "wgmma": 1, "simt": 2}
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_BLOCK_K = 128     # csrc: WG_BK


class FlashPlan(NamedTuple):
    mainloop: str        # "wgmma", "mma" or "simt"
    block_q: int         # q rows per block
    block_k: int         # keys per tile: where p is rounded at the running max


def flash_plan(D: int, dtype: torch.dtype) -> FlashPlan:
    """The mainloop and tiles of a launch at head dim D in `dtype`:

    * wgmma: bf16 at D = 64 and 128 (TMA ring, wgmma, 128 x 128 tiles);
    * mma: bf16 at every other D (mma.sync, 64-row q tiles, 64 keys a
      tile, 32 past D = 128);
    * simt: f32 (one warp per q row, key by key: block_k 1).

    The key tile depends on D and the dtype only, never on Sq, Skv or B:
    the kernel rounds p at the running max of whole key tiles aligned at
    multiples of block_k from key 0, so a row's output is bit-equal
    whatever bucket, batch lane or q tile it falls in."""
    if dtype == torch.float32:
        return FlashPlan("simt", 4, 1)
    if dtype != torch.bfloat16:
        raise ValueError(f"flash attention takes {list(_DTYPES)}, got {dtype}")
    if D in WGMMA_HEAD_DIMS:
        return FlashPlan("wgmma", 128, WGMMA_BLOCK_K)
    return FlashPlan("mma", 64, 64 if D <= 128 else 32)


def _lib() -> ctypes.CDLL:
    lib = build("flash_attention", SOURCES)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, kv_len: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[B, Skv, Hkv, D] for q {tuple(q.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if min(B, Sq, Skv, Hq, Hkv) <= 0 or Hq % Hkv:
        raise ValueError(f"need non-empty shapes and Hq % Hkv == 0, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim D={D} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(_DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len {kv_len} must lie in [1, Skv={Skv}]")
    if max(B * Sq * Hq * D, B * Skv * Hkv * D) >= 2 ** 31 or \
            max(Hq, B) > 65535:
        raise ValueError(f"unsupported size q {tuple(q.shape)}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softmax_scale: float | None = None,
                         kv_len: int | None = None) -> torch.Tensor:
    """softmax((q * scale) k^T, masked) v -> [B, Sq, Hq, D] in q's dtype,
    on the card. q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]: all float32 or all
    bfloat16, contiguous, 16-byte aligned, on one CUDA device. kv_len masks
    keys at or past it (default Skv). The mainloop is flash_plan's."""
    Skv = k.shape[1] if k.dim() == 4 else 0
    kv_len = Skv if kv_len is None else int(kv_len)
    _check(q, k, v, window, kv_len)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    B, Sq, Hq, D = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    # the reference multiplies q by the scale in q's dtype: round it there
    scale = float(torch.tensor(scale, dtype=q.dtype))
    plan = flash_plan(D, q.dtype)
    lib = _lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        Hq, k.shape[2], D, scale, int(bool(causal)), window or 0, kv_len,
        _DTYPES[q.dtype], MAINLOOPS[plan.mainloop], plan.block_k, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}, {plan})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.mainloop_launches[plan.mainloop] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.mainloop_launches = dict.fromkeys(MAINLOOPS, 0)
