"""Plain PyTorch versions of the Mamba-2 SSD chunk scan.

* `ssd_ref`: the port of repro/models/ssm.py::ssd_reference, rounding
  where it rounds: its state and its inter-chunk output are kept in x's
  dtype (bf16 in the served model).
* `ssd_kernel_ref`: the arithmetic of the Pallas kernel
  repro/kernels/ssd/ssd.py::_ssd_kernel, chunk by chunk: f32 cumsum of
  dt*A, M = (C B^T) * exp(seg) * dt_s in f32 rounded to x's dtype before
  M @ x, y_inter = exp(cum_t) * (C h_prev^T) in f32, an f32 state
  h <- exp(cum_end) h + (x w)^T B carried across chunks, + D x in f32 and
  one cast at the end. It returns that f32 state (cast to x's dtype) as
  the final state, as the Hopper kernel does. This is the version the
  card holds the kernel to at about one bf16 ulp.
* `ssd_chunked_ref`: the same arithmetic in the chunked mainloop's order
  (every chunk's own state, a sequential f32 state pass, then every
  chunk's scan), with the planted faults of that order as options. Used by
  the tests and chip_smoke.py only.

Both take x [b, S, H, P], dt [b, S, H], A and D [H], B and C [b, S, G, N]
with G | H, pad S to a chunk multiple (dt = 0 there, which leaves the
state unchanged) and return (y [b, S, H, P], h_final [b, H, P, N]). The
CPU path of ops.ssd runs `ssd_kernel_ref`; the CPU tests hold both
against the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...runtime import no_tf32


def pad_chunks(x, dt, B, C, chunk: int):
    """Right-pad S to a chunk multiple, with dt = 0 on the padded rows (a
    step that leaves the state unchanged)."""
    pad = (-x.shape[1]) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    return x, dt, B, C


def _tril(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


def ssd_ref(x, dt, A, B, C, D, chunk: int):
    """repro/models/ssm.py::ssd_reference, step for step. Where the
    reference's 3-operand einsums round a bf16 pairwise product, the pair
    is the one JAX's contraction path picks: the smaller intermediate
    first, the first pair on a tie."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x, dt, B, C = pad_chunks(x, dt, B, C, chunk)
    nc = x.shape[1] // chunk
    L = nc * chunk
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2)                # [b, L, H, N]
    Ch = C.repeat_interleave(rep, dim=2)
    xc = x.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H).float()
    Bc = Bh.reshape(b, nc, chunk, H, N)
    Cc = Ch.reshape(b, nc, chunk, H, N)

    dA = dtc * A.float()[None, None, None, :]
    cum = torch.cumsum(dA, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b, nc, t, s, H]
    tri = _tril(chunk, x.device)[None, None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    with no_tf32():
        scores = torch.einsum("bqthn,bqshn->bqtsh", Cc, Bc).float()
        M = scores * decay * dtc[:, :, None, :, :]
        y_intra = torch.einsum("bqtsh,bqshp->bqthp", M.to(x.dtype), xc)

        decay_end = torch.exp(cum[:, :, -1:, :] - cum)
        w = (decay_end * dtc).to(x.dtype)[..., None]        # [b, nc, c, H, 1]
        if N > P:
            states = torch.einsum("bqshn,bqshp->bqhpn", Bc, w * xc)
        else:
            states = torch.einsum("bqshn,bqshp->bqhpn", w * Bc, xc)

        chunk_decay = torch.exp(cum[:, :, -1, :])           # [b, nc, H]
        h = torch.zeros((b, H, P, N), dtype=x.dtype, device=x.device)
        h_prev = []
        for q in range(nc):
            h_prev.append(h)
            h = h * chunk_decay[:, q, :, None, None].to(h.dtype) + states[:, q]
        h_prev = torch.stack(h_prev, dim=1)                # [b, nc, H, P, N]

        e = torch.exp(cum).to(x.dtype)[..., None]           # [b, nc, c, H, 1]
        if N > P:
            y_inter = e * torch.einsum("bqthn,bqhpn->bqthp", Cc, h_prev)
        else:
            y_inter = torch.einsum("bqthn,bqhpn->bqthp", e * Cc, h_prev)
    y = (y_intra + y_inter).reshape(b, L, H, P)[:, :S]
    y = y + x.reshape(b, L, H, P)[:, :S] * D[None, None, :, None]
    return y, h


def ssd_kernel_ref(x, dt, A, B, C, D, *, chunk: int):
    """The Pallas kernel's arithmetic (see the module docstring), every
    (batch, head) at once, one chunk at a time. The mask is applied before
    exp, so the overflowing exponents above the diagonal never meet 0."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x, dt, B, C = pad_chunks(x, dt, B, C, chunk)
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).float()        # [b, L, H, N]
    Ch = C.repeat_interleave(rep, dim=2).float()
    Af, Df = A.float(), D.float()
    tri = _tril(chunk, x.device)[None, :, :, None]      # [1, t, s, 1]
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    with no_tf32():
        for c0 in range(0, x.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            xc, xf = x[:, sl], x[:, sl].float()             # [b, c, H, P]
            dtc = dt[:, sl].float()                         # [b, c, H]
            Bc, Cc = Bh[:, sl], Ch[:, sl]                   # [b, c, H, N]
            cum = torch.cumsum(dtc * Af, dim=1)             # [b, c, H]
            seg = cum[:, :, None, :] - cum[:, None, :, :]   # [b, t, s, H]
            decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)),
                                0.0)
            scores = torch.einsum("bthn,bshn->btsh", Cc, Bc)
            M = scores * decay * dtc[:, None, :, :]
            y = torch.einsum("btsh,bshp->bthp", M.to(x.dtype).float(), xf)
            y = y + torch.exp(cum)[..., None] * torch.einsum(
                "bthn,bhpn->bthp", Cc, h)
            w = torch.exp(cum[:, -1:, :] - cum) * dtc       # [b, c, H]
            h = torch.exp(cum[:, -1, :])[..., None, None] * h + torch.einsum(
                "bshp,bshn->bhpn", xf * w[..., None], Bc)
            ys.append((y + Df[None, None, :, None] * xf).to(x.dtype))
    return torch.cat(ys, dim=1)[:, :S], h.to(x.dtype)


CHUNKED_FAULTS = ("state_pass_without_decay", "cum_across_chunks")


def ssd_chunked_ref(x, dt, A, B, C, D, *, chunk: int, fault=None):
    """ssd_kernel_ref's arithmetic in three phases, as the chunked
    mainloop runs it: (1) per chunk, cum = cumsum(dt A) restarting at the
    chunk, w = exp(cum_end - cum) dt and s_c = (x w)^T B in f32; (2) for
    c = 0 .. nc-1, h_prev[c] = h and h = exp(cum_end_c) h + s_c; (3) per
    chunk, y = M x + exp(cum) (C h_prev[c]^T) + D x with M = (C B^T) *
    decay * dt masked before exp and rounded to x's dtype. One of
    CHUNKED_FAULTS plants an error of that order: the state pass without
    its decay, or cum carried across chunk boundaries."""
    if fault not in (None, *CHUNKED_FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x, dt, B, C = pad_chunks(x, dt, B, C, chunk)
    nc = x.shape[1] // chunk
    rep = H // G
    xf = x.float().reshape(b, nc, chunk, H, P)
    Bc = B.repeat_interleave(rep, dim=2).float().reshape(b, nc, chunk, H, N)
    Cc = C.repeat_interleave(rep, dim=2).float().reshape(b, nc, chunk, H, N)
    dtc = dt.float().reshape(b, nc, chunk, H)
    dA = dtc * A.float()
    if fault == "cum_across_chunks":
        cum = torch.cumsum(dA.reshape(b, nc * chunk, H), dim=1).reshape(
            b, nc, chunk, H)
    else:
        cum = torch.cumsum(dA, dim=2)                  # [b, nc, c, H]
    tri = _tril(chunk, x.device)[None, :, :, None]     # [1, t, s, 1]
    with no_tf32():
        # 1. each chunk's own state, [b, nc, H, P, N]
        w = torch.exp(cum[:, :, -1:, :] - cum) * dtc
        states = torch.stack([torch.einsum(
            "bshp,bshn->bhpn", xf[:, q] * w[:, q, ..., None], Bc[:, q])
            for q in range(nc)], dim=1)
        # 2. the state pass
        decay_end = torch.exp(cum[:, :, -1, :])         # [b, nc, H]
        if fault == "state_pass_without_decay":
            decay_end = torch.ones_like(decay_end)
        h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
        h_prev = []
        for q in range(nc):
            h_prev.append(h)
            h = decay_end[:, q, :, None, None] * h + states[:, q]
        # 3. each chunk's scan
        ys = []
        for q in range(nc):
            seg = cum[:, q, :, None, :] - cum[:, q, None, :, :]
            decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)),
                                0.0)
            M = torch.einsum("bthn,bshn->btsh", Cc[:, q], Bc[:, q]) * \
                decay * dtc[:, q, None, :, :]
            y = torch.einsum("btsh,bshp->bthp", M.to(x.dtype).float(),
                             xf[:, q])
            y = y + torch.exp(cum[:, q])[..., None] * torch.einsum(
                "bthn,bhpn->bthp", Cc[:, q], h_prev[q])
            ys.append((y + D.float()[None, None, :, None] * xf[:, q])
                      .to(x.dtype))
    return torch.cat(ys, dim=1)[:, :S], h.to(x.dtype)
