"""Plain PyTorch version of the pod GEMM (counterpart of
repro/kernels/systolic_gemm/ref.py). The CPU path of ops.py runs it, and
the card compares the kernel against it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...runtime import no_tf32
from .systolic_gemm import splitk_ranges


def _matmul_exact_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 x int8 with exact integer accumulation, as f32. The CPU has an
    int64 matmul; CUDA has none, so the card uses float64, exact for sums
    below 2**53 (float32 would not be past 2**24 = K * 127**2, K >= 1041)."""
    if x.is_cuda:
        return (x.double() @ w.double()).float()
    return (x.long() @ w.long()).float()


def epilogue_ref(acc: torch.Tensor, scale=None, bias=None, *,
                 activation=None) -> torch.Tensor:
    """scale, bias and activation on an f32 accumulator."""
    if scale is not None:
        acc = acc * scale.float()[None, :]
    if bias is not None:
        acc = acc + bias.float()[None, :]
    if activation == "relu":
        acc = torch.clamp_min(acc, 0.0)
    elif activation == "gelu":
        acc = F.gelu(acc, approximate="tanh")   # jax.nn.gelu's default
    elif activation == "silu":
        acc = acc * torch.sigmoid(acc)
    elif activation == "relu2":
        acc = torch.square(torch.clamp_min(acc, 0.0))
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return acc


def systolic_gemm_ref(x, w, scale=None, bias=None, *, activation=None,
                      out_dtype=torch.float32):
    if x.dtype == torch.int8:
        acc = _matmul_exact_int8(x, w)
    else:
        with no_tf32():
            acc = x.float() @ w.float()
    return epilogue_ref(acc, scale, bias,
                        activation=activation).to(out_dtype)


def splitk_partials(x, w, splits: int) -> list[torch.Tensor]:
    """The f32 partial products x[:, r] @ w[r] over the K ranges r that
    the splitk mainloop's splits sum (systolic_gemm.splitk_ranges)."""
    with no_tf32():
        return [x[:, a:b].float() @ w[a:b].float()
                for a, b in splitk_ranges(x.shape[1], splits)]


def systolic_gemm_splitk_ref(x, w, scale=None, bias=None, *, splits: int,
                             activation=None, out_dtype=torch.float32):
    """The splitk mainloop's order of summation: its f32 partials added in
    split order 0..splits-1, then the epilogue."""
    parts = splitk_partials(x, w, splits)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return epilogue_ref(acc, scale, bias,
                        activation=activation).to(out_dtype)


def systolic_gemm_t_ref(x, w, scale=None, bias=None, *, activation=None,
                        out_dtype=torch.float32):
    """The transposed-weight variant: x [M, K] @ w [N, K]^T."""
    return systolic_gemm_ref(x, w.t(), scale, bias, activation=activation,
                             out_dtype=out_dtype)


def systolic_gemm_t_splitk_ref(x, w, scale=None, bias=None, *, splits: int,
                               activation=None, out_dtype=torch.float32):
    """The NT form's splitk and wgmma order of summation, w [N, K]: the
    same K ranges in the same order as the NN form's."""
    return systolic_gemm_splitk_ref(x, w.t(), scale, bias, splits=splits,
                                    activation=activation,
                                    out_dtype=out_dtype)


def grouped_systolic_gemm_ref(x, w, scale=None, bias=None, *,
                              activation=None, out_dtype=torch.float32):
    """G independent GEMMs: x [G, M, K] @ w [G, K, N], scale/bias [G, N].
    Per group exactly systolic_gemm_ref (the JAX package's tests loop its
    ref over groups the same way)."""
    return torch.stack([
        systolic_gemm_ref(x[g], w[g],
                          None if scale is None else scale[g],
                          None if bias is None else bias[g],
                          activation=activation, out_dtype=out_dtype)
        for g in range(x.shape[0])])


def grouped_systolic_gemm_splitk_ref(x, w, scale=None, bias=None, *,
                                     splits: int, activation=None,
                                     out_dtype=torch.float32):
    """The grouped form's wgmma order of summation: per group the NN
    form's split ranges, x [G, M, K] @ w [G, K, N]."""
    return torch.stack([
        systolic_gemm_splitk_ref(x[g], w[g],
                                 None if scale is None else scale[g],
                                 None if bias is None else bias[g],
                                 splits=splits, activation=activation,
                                 out_dtype=out_dtype)
        for g in range(x.shape[0])])
