"""Public SSD entry point (counterpart of repro/kernels/ssd/ops.py):
`ssd(x, dt, A, B, C, D, *, chunk)` -> (y, h_final).

A CPU tensor runs the plain version of the Pallas kernel's arithmetic
(ref.ssd_kernel_ref); a CUDA tensor launches the Hopper kernel, which
raises if it cannot run. There is no other path. The kernel has no
backward: with grad mode on, an input that requires grad raises on both
devices (runtime.refuse_autograd).

Against the JAX wrapper: groups are not repeated to heads (the kernel
reads group h // (H / G) in place), x, B and C are read by stride where
the model hands over views of one projection, S is padded to a chunk
multiple with dt = 0 (a step that leaves the state unchanged, so padded
rows are inert), and the final state is the kernel's own f32 state cast
to x's dtype. The JAX wrapper recomputes it with the jnp reference, whose
state is bf16 in a bf16 model; tests/test_torch_ssd.py states that drift.
"""

from __future__ import annotations

from ...runtime import refuse_autograd
from .ref import pad_chunks, ssd_kernel_ref
from .ssd import ssd_cuda


def ssd(x, dt, A, B, C, D, *, chunk: int = 128):
    """x [b,S,H,P]; dt [b,S,H]; A, D [H]; B, C [b,S,G,N] with G | H.
    Returns (y [b,S,H,P], h_final [b,H,P,N]) in x's dtype."""
    refuse_autograd("ssd", x, dt, A, B, C, D)
    if x.device.type == "cpu":
        return ssd_kernel_ref(x, dt, A, B, C, D, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    S = x.shape[1]
    x, dt, B, C = pad_chunks(x, dt.float(), B, C, chunk)
    # x, B and C go by stride (the model's split views are not copied)
    y, h_final = ssd_cuda(x, dt.contiguous(), A.float().contiguous(), B, C,
                          D.float().contiguous(), chunk=chunk)
    return y[:, :S], h_final
