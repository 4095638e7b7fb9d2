"""Public pod-GEMM entry points (counterpart of
repro/kernels/systolic_gemm/ops.py): `systolic_gemm` and the serving
hot-loop form `fused_lane_gemm`, their transposed-weight forms
`systolic_gemm_t` / `fused_lane_gemm_t` (w [N, K], the tied LM head), and
`grouped_gemm` (G independent GEMMs in one launch, the MoE experts), with
the same signatures and contract.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
Hopper kernel, which raises if it cannot run. There is no other path. No
form has a backward: with grad mode on, an input that requires grad
raises on both devices (runtime.refuse_autograd).

The JAX wrappers pad to block multiples, call the kernel and slice back.
The Hopper kernel masks ragged M/N/K edges itself, so nothing is padded
here and the result has the same [M, N] contract. Every form's mainloop
and split-K geometry come from the form and shape alone
(systolic_gemm.py::gemm_plan: splitk for NN and NT at M <= 64, wgmma for
every form above, wmma for ragged shapes and the grouped form at M <=
64). The NN and grouped forms accept and check explicit `block_m/n/k`,
which, as on the TPU, do not change the result; the transposed forms take
no blocks. The TPU's autotuner (parallel/autoshard.py::choose_blocks) is
not ported.
"""

from __future__ import annotations

import math

import torch

from ...runtime import refuse_autograd
from .guard import OFF, guarded_gemm
from .ref import (grouped_systolic_gemm_ref, systolic_gemm_ref,
                  systolic_gemm_t_ref)
from .systolic_gemm import (grouped_systolic_gemm_cuda, systolic_gemm_cuda,
                            systolic_gemm_nt_cuda)


def _gemm(plain, kernel, x, w, scale, bias, activation, out_dtype):
    refuse_autograd("systolic_gemm", x, w, scale, bias)
    if x.device.type == "cpu":
        return plain(x, w, scale, bias, activation=activation,
                     out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"systolic_gemm runs on cuda or cpu, not {x.device}")
    return kernel(x.contiguous(), w.contiguous(), scale, bias,
                  activation=activation, out_dtype=out_dtype)


def _check_blocks(*blocks) -> None:
    for b in blocks:
        if b is not None and b <= 0:
            raise ValueError(f"block sizes must be positive, got {b}")


def systolic_gemm(x, w, scale=None, bias=None, *, activation=None,
                  block_m: int | None = None, block_n: int | None = None,
                  block_k: int | None = None, out_dtype=torch.float32):
    """out = epilogue((x @ w) * scale + bias). x [M,K], w [K,N].

    int8 x int8 -> int32 accumulate; bf16/f32 -> f32 accumulate."""
    _check_blocks(block_m, block_n, block_k)
    return _gemm(systolic_gemm_ref, systolic_gemm_cuda, x, w, scale, bias,
                 activation, out_dtype)


def systolic_gemm_t(x, w, scale=None, bias=None, *, activation=None,
                    out_dtype=torch.float32):
    """out = epilogue((x @ w.T) * scale + bias). x [M,K], w [N,K].

    The transposed-weight pod GEMM: w is read in its stored layout (no
    [K,N] transpose copy), so the tied-embedding unembed runs the [vocab, d]
    token table as the LM head directly. Same contract as systolic_gemm."""
    return _gemm(systolic_gemm_t_ref, systolic_gemm_nt_cuda, x, w, scale,
                 bias, activation, out_dtype)


def grouped_gemm(x, w, scale=None, bias=None, *, activation=None,
                 block_m: int | None = None, block_n: int | None = None,
                 block_k: int | None = None, out_dtype=torch.float32):
    """G independent GEMMs in ONE kernel launch: x [G,M,K] @ w [G,K,N]
    -> [G,M,N], with a per-group (scale, bias) [G,N] and a shared
    activation in the epilogue. Same contract as `systolic_gemm`."""
    _check_blocks(block_m, block_n, block_k)
    return _gemm(grouped_systolic_gemm_ref, grouped_systolic_gemm_cuda, x,
                 w, scale, bias, activation, out_dtype)


def fused_lane_gemm(x, w, scale=None, bias=None, *, activation=None,
                    out_dtype=None, block_m: int | None = None,
                    block_n: int | None = None, block_k: int | None = None,
                    guard=None):
    """Fused-lane GEMM: x [..., K] @ w [K, N] -> [..., N].

    All leading axes of x (decode lanes, sequence positions, batch) fold
    into the GEMM M axis: one pod GEMM instead of a fan of GEMVs. The
    leading shape is restored on return. `out_dtype=None` means float32.

    `guard` (a guard.PodGuard, or None) diverts to the SDC-checked path
    (ABFT checksums or a Freivalds probe, guard.py); None or mode "off"
    takes the unguarded kernel call unchanged."""
    lead = x.shape[:-1]
    m = math.prod(lead)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if guard is not None and guard.mode != OFF:
        out = guarded_gemm(x.reshape(m, x.shape[-1]), w, scale, bias,
                           guard=guard, activation=activation,
                           out_dtype=out_dtype)
    else:
        out = systolic_gemm(x.reshape(m, x.shape[-1]), w, scale, bias,
                            activation=activation, block_m=block_m,
                            block_n=block_n, block_k=block_k,
                            out_dtype=out_dtype)
    return out.reshape(*lead, w.shape[1])


def fused_lane_gemm_t(x, w, scale=None, bias=None, *, activation=None,
                      out_dtype=None, guard=None):
    """Fused-lane transposed GEMM: x [..., K] @ w [N, K]^T -> [..., N].
    The LM-head entry point: every decode lane and sequence position folds
    into M of ONE GEMM against the stored [vocab, d] table. `guard` as in
    `fused_lane_gemm` (transposed-layout checksums)."""
    lead = x.shape[:-1]
    m = math.prod(lead)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if guard is not None and guard.mode != OFF:
        out = guarded_gemm(x.reshape(m, x.shape[-1]), w, scale, bias,
                           guard=guard, activation=activation,
                           out_dtype=out_dtype, transpose=True)
    else:
        out = systolic_gemm_t(x.reshape(m, x.shape[-1]), w, scale, bias,
                              activation=activation, out_dtype=out_dtype)
    return out.reshape(*lead, w.shape[0])
