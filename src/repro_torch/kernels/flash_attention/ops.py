"""Public flash-attention entry point (counterpart of
repro/kernels/flash_attention/ops.py).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
Hopper kernel, which raises if it cannot run. There is no other path. The
kernel has no backward: with grad mode on, an input that requires grad
raises on both devices (runtime.refuse_autograd); training attends through
models/attention.py::chunked_attention and its flash backward.

The JAX wrapper pads Sq and Skv to block multiples and masks the padded
keys through kv_len. The Hopper kernel masks ragged Sq and Skv itself, so
nothing is padded here. Its tiles come from the head dim and dtype alone
(flash_attention.py::flash_plan), so the reference's block_q/block_k have
no counterpart.
"""

from __future__ import annotations

from ...runtime import refuse_autograd
from .flash_attention import flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softmax_scale: float | None = None):
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D]."""
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention runs on cuda or cpu, not {q.device}")
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window,
                                softmax_scale=softmax_scale)
