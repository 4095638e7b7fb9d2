"""Mamba-2 SSD blocks (counterpart of repro/models/ssm.py).

Prefill runs the chunked SSD: `impl="jnp"` is the reference's own
arithmetic in torch ops (ssd_reference), `impl="pallas"` the SSD kernel
(kernels/ssd: the Hopper kernel on the card, the plain version of the
Pallas kernel's arithmetic on the CPU). Decode is the recurrent form
h <- exp(dt A) h + dt B x in torch ops, as in the reference.

Casts sit where the reference has them, so a bf16 model rounds at the
same places; where a 3-operand einsum of the reference rounds a bf16
pairwise product, the pair is the one JAX's contraction path picks. The
SSMCache is updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..kernels.ssd.ops import ssd as ssd_kernel
from ..kernels.ssd.ref import ssd_ref as ssd_reference
from .attention import einsum, grad_as_forward, split_safe
from .layers import ParamSpec

__all__ = ["SSMCache", "apply_ssm", "ssd_chunked", "ssd_decode_step",
           "ssd_reference", "ssm_schema"]


def ssm_schema(cfg: ArchConfig, layers: int | None = None) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    G, N, K = s.n_groups, s.d_state, s.conv_kernel
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    conv_dim = di + 2 * G * N
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "in_proj": ParamSpec(lead + (d, 2 * di + 2 * G * N + H),
                             la + ("embed", "ssm_inner")),
        "conv_w": ParamSpec(lead + (K, conv_dim), la + (None, "ssm_inner")),
        "conv_b": ParamSpec(lead + (conv_dim,), la + ("ssm_inner",),
                            init="zeros"),
        "A_log": ParamSpec(lead + (H,), la + ("ssm_heads",), init="zeros"),
        "D": ParamSpec(lead + (H,), la + ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec(lead + (H,), la + ("ssm_heads",), init="zeros"),
        "norm": ParamSpec(lead + (di,), la + ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec(lead + (di, d), la + ("ssm_inner", "embed")),
    }


def _silu(x):
    """jax.nn.silu as XLA evaluates it on the CPU: x * 1 / (1 + exp(-x)),
    each step rounded in x's dtype (torch.sigmoid rounds a bf16 input
    once, and differs from it by one bf16 ulp in about a third of the
    elements)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _split_proj(zxbcdt, cfg: ArchConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    G, N = s.n_groups, s.d_state
    H = s.n_heads(cfg.d_model)
    return torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)


def _causal_conv(x, w, b, cache=None, true_lens=None):
    """Depthwise causal conv1d. x [B,S,Cd], w [K,Cd]; cache [B, K-1, Cd]
    trailing context for decode. Returns (y, new context). true_lens [B]:
    per-lane valid length of a right-padded prefill; the returned window
    then ends at each lane's true last token (context index L is input
    position L - (K-1)), so a lane shorter than K-1 takes part of its
    window from the zero padding, as the reference's dynamic_slice does."""
    K = w.shape[0]
    if cache is None:
        ctx = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    else:
        ctx = torch.cat([cache, x], dim=1)
    S = x.shape[1]
    y = sum(ctx[:, k:k + S, :] * w[k] for k in range(K)) + b
    if K == 1:
        new_cache = ctx[:, :0, :]
    elif true_lens is not None:
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        cols = true_lens[:, None] + torch.arange(K - 1, device=x.device)
        new_cache = ctx[rows, cols]
    else:
        new_cache = ctx[:, -(K - 1):, :]
    return y, new_cache


def ssd_chunked(x, dt, A, B, C, D, chunk: int, impl: str = "jnp"):
    """SSD forward. x [b,S,H,P]; dt [b,S,H]; A [H] (negative); B, C
    [b,S,G,N]. Returns y [b,S,H,P] and the final state [b,H,P,N]."""
    if impl == "pallas":
        return ssd_kernel(x, dt, A, B, C, D, chunk=chunk)
    if impl != "jnp":
        raise ValueError(f"unknown ssd impl {impl!r}")
    return ssd_reference(x, dt, A, B, C, D, chunk)


def ssd_decode_step(x, dt, A, B, C, D, h):
    """One-token recurrence. x [b,H,P]; dt [b,H]; B, C [b,G,N];
    h [b,H,P,N]."""
    H, P = x.shape[1], x.shape[2]
    G, N = B.shape[1], B.shape[2]
    Bh = B.repeat_interleave(H // G, dim=1)               # [b,H,N]
    Ch = C.repeat_interleave(H // G, dim=1)
    dtf = dt.float()
    dA = torch.exp(dtf * A[None, :])[..., None, None].to(h.dtype)
    dtx = dtf.to(x.dtype)[..., None]                      # [b,H,1]
    if N > P:
        upd = (dtx * x)[..., :, None] * Bh[..., None, :]
    else:
        upd = x[..., :, None] * (dtx * Bh)[..., None, :]
    h_new = h * dA + upd
    y = einsum("bHn,bHpn->bHp", Ch, h_new) + x * D[None, :, None]
    return y, h_new


@dataclasses.dataclass
class SSMCache:
    """Decode state: conv context + SSD state (optionally layer-stacked),
    updated in place."""
    conv: torch.Tensor     # [(L,) B, K-1, conv_dim]
    state: torch.Tensor    # [(L,) B, H, P, N]

    @staticmethod
    def zeros(cfg: ArchConfig, batch: int, layers: int | None = None,
              dtype=torch.bfloat16, device=None) -> "SSMCache":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        H = s.n_heads(cfg.d_model)
        conv_dim = di + 2 * s.n_groups * s.d_state
        cshape = (batch, s.conv_kernel - 1, conv_dim)
        sshape = (batch, H, s.head_dim, s.d_state)
        if layers:
            cshape = (layers,) + cshape
            sshape = (layers,) + sshape
        return SSMCache(torch.zeros(cshape, dtype=dtype, device=device),
                        torch.zeros(sshape, dtype=dtype, device=device))

    def layer(self, i: int) -> "SSMCache":
        """Layer i of a stacked cache, as views: writes land in the stack."""
        return SSMCache(self.conv[i], self.state[i])

    def lane_bytes(self) -> int:
        """Device bytes of ONE lane's SSM state (conv window + SSD state),
        whatever the context length: nothing here for a page pool to
        page, so paged serving keeps it lane-resident."""
        batch = self.conv.shape[-3]
        return (self.conv.nbytes + self.state.nbytes) // batch


def apply_ssm(p: dict, u, cfg: ArchConfig, cache: SSMCache | None = None,
              impl: str = "jnp", true_lens=None):
    """Full Mamba-2 mixer. u [B,S,D] -> [B,S,D]; a given cache is written
    in place. S == 1 with a cache takes the recurrent path.

    true_lens [B] (bucketed prefill): the input is right-padded to a
    shared bucket and the recurrence must not integrate the padding:
    dt <- dt * (pos < L) makes a padded step an exact identity on the
    state (exp(0 A) = 1, 0 B x = 0) and a zero in every real row's output,
    so real lanes match an exact-length prefill; the conv window is
    gathered at the true length (_causal_conv)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    P = s.head_dim
    G, N = s.n_groups, s.d_state

    zxbcdt = einsum("bsd,de->bse", u, p["in_proj"])
    z, x, B, C, dt = _split_proj(zxbcdt, cfg)
    xBC = torch.cat([x, B, C], dim=-1)
    conv_cache = cache.conv if cache is not None else None
    if true_lens is not None and u.shape[1] == 1:
        true_lens = None                        # decode: nothing is padded
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_cache,
                                 true_lens=true_lens)
    xBC = _silu(xBC)
    x, B, C = torch.split(xBC, [di, G * N, G * N], dim=-1)

    dt = dt.float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))        # softplus
    if true_lens is not None:
        valid = torch.arange(u.shape[1], device=u.device)[None, :] < \
            true_lens[:, None]
        dt = dt * valid[..., None]              # exact 0 at padded steps
    A = -torch.exp(p["A_log"].float())
    bsz, S = u.shape[0], u.shape[1]
    xh = grad_as_forward(split_safe(x, -1, H).reshape(bsz, S, H, P))
    Bh = split_safe(B, -1, G).reshape(bsz, S, G, N)
    Ch = split_safe(C, -1, G).reshape(bsz, S, G, N)

    if cache is not None and S == 1:
        y, h_new = ssd_decode_step(xh[:, 0], dt[:, 0], A, Bh[:, 0],
                                   Ch[:, 0], p["D"], cache.state)
        y = y[:, None]
    else:
        y, h_new = ssd_chunked(xh, dt, A, Bh, Ch, p["D"], s.chunk_size, impl)

    y = grad_as_forward(split_safe(y, 2, H).reshape(bsz, S, di))
    # gated RMSNorm (Mamba-2)
    yf = (y * _silu(z)).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6)).to(u.dtype) * p["norm"]
    out = einsum("bse,ed->bsd", y, p["out_proj"])
    if cache is not None:
        cache.conv.copy_(new_conv)
        cache.state.copy_(h_new)
    return out
