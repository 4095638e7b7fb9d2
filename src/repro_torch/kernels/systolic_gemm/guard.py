"""SDC safety for the pod-GEMM path: ABFT checksums and Freivalds probes
(counterpart of repro/kernels/systolic_gemm/guard.py).

One bit flip inside one tile of the GEMM corrupts one output element, and
one wrong logit emits wrong tokens from then on. This module wraps the
pod GEMM in an algorithm-based fault tolerance envelope:

  * **abft**: append the column-sum row to A and the row-sum column to B,
    so ``C_aug = A_aug @ B_aug`` carries a checksum row and column of C.
    Comparing them with the data block's own sums detects a corruption,
    and a single corrupted element is located at (argmax row residual,
    argmax column residual) and repaired by an exact f32 recompute of
    that one dot product.
  * **probe**: a randomized Freivalds check, ``C @ v`` against
    ``A @ (B @ v)`` for a Rademacher vector v. It detects and does not
    locate. A single element off by more than the tolerance is always
    caught (its row residual is exactly +-delta); an adversarial pattern
    E escapes one probe only if ``E @ v = 0``, which for a Rademacher v
    has probability <= 1/2, so <= 2**-probes over all probes.
  * **off**: the guard is never consulted, and the serving path is the
    unguarded one (tokens, runners, graphs, launches, host syncs).

A guarded GEMM runs the raw kernel (no scale, no bias, no activation, f32
out: the accumulator itself), verifies and repairs, then applies the
epilogue the fused kernel would have (ref.py::epilogue_ref). On the card
the raw call launches the Hopper pod-GEMM kernel; the augmented shapes
[M+1, K] x [K, N+1] are ragged, so `gemm_plan` gives them the wmma
mainloop. Everything after the raw call is torch ops on the device.

Nothing in the guarded path reads the device from the host, because it
runs inside the serve engine's CUDA graphs (serve/graphs.py): the
element is located with argmax and repaired with index_put on tensor
indices, the verdicts are device flags summed on the tape, and
the injection plan is a device tensor. The probe vectors come from the
static `probe_seed` and are made once per (N, probe, seed, device) at
their first use, which in the engine is a runner's eager warm-up (a
host-to-device copy cannot be captured).

Float tolerance: checksums are summed in f32 but stored in the input
dtype, so for bf16 the checksum row carries ~2**-9 relative rounding
noise against the f32 sums of the data. The default rtol of 1/64 sits ~8x
above that noise and far below any corruption worth detecting. int8 is
rejected under abft: an int8 column sum overflows the int8 checksum row.
"""

from __future__ import annotations

import dataclasses

import torch

from ...runtime import no_tf32
from .ref import epilogue_ref

OFF, PROBE, ABFT = "off", "probe", "abft"
MODES = (OFF, PROBE, ABFT)

# corrupted elements per GEMM, at most (two on distinct rows and columns
# defeat the single-corruption location: uncorrectable)
MAX_SDC_ELEMS = 2


@dataclasses.dataclass(frozen=True)
class PodGuard:
    """SDC-guard configuration of the pod-GEMM path.

    mode:   "off" (the unguarded path), "probe" (Freivalds, detect only),
            "abft" (checksum row and column: detect, locate and repair a
            single corruption).
    rtol:   float-noise tolerance, relative to the largest augmented
            output magnitude.
    probes: independent Freivalds probes; an adversarial corruption is
            missed with probability <= 2**-probes.
    probe_seed: seed of the Rademacher probe vectors.
    """

    mode: str = OFF
    rtol: float = 1.0 / 64.0
    probes: int = 1
    probe_seed: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"PodGuard.mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if not (0.0 < self.rtol < 1.0):
            raise ValueError(f"rtol must be in (0, 1), got {self.rtol}")
        if self.probes < 1:
            raise ValueError("probes must be >= 1")


def as_guard(guard) -> PodGuard:
    """None -> off; a mode string -> PodGuard(mode); PodGuard passes."""
    if guard is None:
        return PodGuard(mode=OFF)
    if isinstance(guard, str):
        return PodGuard(mode=guard)
    if isinstance(guard, PodGuard):
        return guard
    raise TypeError(f"guard must be None, str, or PodGuard, got "
                    f"{type(guard).__name__}")


# ---------------------------------------------------------------------------
# GuardTape: scopes a PodGuard over a model call without touching the
# Model API. layers.pod_dense and layers.unembed consult active_guard();
# each guarded GEMM takes the next index and records its verdicts on the
# tape; the engine packs tape.totals() into the call's one host read.
# ---------------------------------------------------------------------------

_TAPES: list["GuardTape"] = []


class GuardTape:
    """Context manager scoping a PodGuard (and an optional SDC injection
    plan) over every pod GEMM called inside the ``with`` block, in call
    order.

    ``inject`` is an int64[3] device tensor ``(target_gemm, draw_seed,
    n_elems)`` (or None): the guarded GEMM whose index equals
    ``target_gemm`` gets ``n_elems`` elements of its raw output moved by
    ``magnitude``; ``target_gemm < 0`` disarms."""

    def __init__(self, guard: PodGuard, inject=None,
                 magnitude: float = 1e4):
        self.guard = guard
        self.inject = inject
        self.magnitude = float(magnitude)
        self._next = 0
        self._draws = None
        self._corrected: list[torch.Tensor] = []
        self._uncorrected: list[torch.Tensor] = []

    def __enter__(self):
        _TAPES.append(self)
        return self

    def __exit__(self, *exc):
        popped = _TAPES.pop()
        assert popped is self, "unbalanced GuardTape nesting"
        return False

    def next_index(self) -> int:
        i = self._next
        self._next += 1
        return i

    @property
    def draws(self) -> torch.Tensor:
        """The injection plan's two draws (sdc_draws), made once a tape."""
        if self._draws is None:
            self._draws = sdc_draws(self.inject[1])
        return self._draws

    def record(self, corrected, uncorrected) -> None:
        """One guarded GEMM's verdicts, 0-dim device flags (bool or
        integer); None counts as 0."""
        if corrected is not None:
            self._corrected.append(corrected)
        self._uncorrected.append(uncorrected)

    def totals(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(corrected, uncorrected) over the tape: int64 scalars on the
        device of the recorded flags (of the plan when none was
        recorded)."""
        flags = self._uncorrected + self._corrected
        device = (flags[0].device if flags else
                  self.inject.device if self.inject is not None else None)

        def total(fl: list) -> torch.Tensor:
            if not fl:
                return torch.zeros((), dtype=torch.int64, device=device)
            return torch.stack(fl).sum(dtype=torch.int64)

        return total(self._corrected), total(self._uncorrected)

    @property
    def gemms(self) -> int:
        """Guarded GEMMs called so far under this tape."""
        return self._next


def active_tape():
    return _TAPES[-1] if _TAPES else None


def active_guard():
    """The PodGuard of the innermost tape, or None (the unguarded path)."""
    tape = active_tape()
    if tape is None or tape.guard.mode == OFF:
        return None
    return tape.guard


# ---------------------------------------------------------------------------
# ABFT math
# ---------------------------------------------------------------------------

def augment_x(x):
    """Append the column-sum checksum row: [M, K] -> [M+1, K]."""
    ck = x.sum(dim=0, keepdim=True, dtype=torch.float32).to(x.dtype)
    return torch.cat([x, ck], dim=0)


def augment_w(w):
    """Append the row-sum checksum column: [K, N] -> [K, N+1]."""
    ck = w.sum(dim=1, keepdim=True, dtype=torch.float32).to(w.dtype)
    return torch.cat([w, ck], dim=1)


def augment_wt(w):
    """Transposed-layout checksum: w [N, K] -> [N+1, K]; the appended row
    is the sum over N, so ``x_aug @ w_aug.T`` carries the same checksum
    column as the [K, N] layout would."""
    ck = w.sum(dim=0, keepdim=True, dtype=torch.float32).to(w.dtype)
    return torch.cat([w, ck], dim=0)


def _tol(c_aug, rtol: float):
    """Detection threshold, relative to the largest augmented magnitude,
    so float accumulation noise stays under it while any corruption worth
    catching clears it (also when the corrupted element is the largest)."""
    return rtol * (c_aug.abs().max() + 1.0)


def _row(t, i):
    """Row i (a device index [1]) of a 2-D tensor, as [N]."""
    return t.index_select(0, i)[0]


def _col(t, j):
    return t.index_select(1, j)[:, 0]


def abft_verify(c_aug, x, w, *, rtol: float, transpose: bool = False):
    """Check (and repair) one raw augmented GEMM output.

    c_aug: [M+1, N+1] f32 raw output of the augmented operands.
    x:     [M, K] the original left operand.
    w:     [K, N] ([N, K] when ``transpose``) the original right operand.

    Returns ``(c, report)``: c the verified, possibly repaired [M, N] data
    block (a new tensor), report 0-dim device tensors (flags as bool):

      detected    any residual above the tolerance
      corrected   contained: a single data element repaired by an exact
                  recompute, or a hit on the checksums only (data clean)
      uncorrected detected but not provably repaired: the caller must
                  recompute (the engine retries the device call)
      row, col    the located element (argmax residuals; meaningful only
                  when a single data corruption was found)
    """
    M = x.shape[0]
    N = w.shape[0] if transpose else w.shape[1]
    c = c_aug[:M, :N]
    # checksum column (per row) and checksum row (per column) against the
    # data block's own sums
    row_res = c_aug[:M, N] - c.sum(dim=1)
    col_res = c_aug[M, :N] - c.sum(dim=0)
    row_abs, col_abs = row_res.abs(), col_res.abs()
    tol = _tol(c_aug, rtol)
    n_row = (row_abs > tol).sum()
    n_col = (col_abs > tol).sum()
    r = row_abs.argmax().view(1)
    cc = col_abs.argmax().view(1)
    # repair by an exact f32 recompute of the located dot product: adding
    # the residual would fold the checksums' rounding into the value
    xr = _row(x, r).float()
    wc = (_row(w, cc) if transpose else _col(w, cc)).float()
    fix = torch.dot(xr, wc).view(1)
    old = c[r, cc]
    # recheck the repaired row and column (their residuals with the fix in
    # place of old): a multi-corruption that looks like a single one leaves
    # a residual after the fix, uncorrected
    moved = old - fix
    rr_after = (row_res.index_select(0, r) + moved).abs()
    cr_after = (col_res.index_select(0, cc) + moved).abs()
    fix_ok = ((n_row == 1) & (n_col == 1) & (rr_after <= tol)
              & (cr_after <= tol))
    out = c.clone()
    out.index_put_((r, cc), torch.where(fix_ok, fix, old))
    # a data corruption at (r, cc) moves row_res[r] AND col_res[cc] by the
    # same -delta; a hit on the checksum row or column moves one side only:
    # the data block is clean and the checksums are dropped
    row_hit, col_hit = n_row > 0, n_col > 0
    detected = row_hit | col_hit
    corrected = (fix_ok[0] | (row_hit != col_hit)) & detected
    report = {"detected": detected, "corrected": corrected,
              "uncorrected": detected & ~corrected, "row": r[0],
              "col": cc[0]}
    return out, report


_PROBES: dict[tuple, torch.Tensor] = {}


def probe_vector(n: int, p: int, seed: int, device, dtype) -> torch.Tensor:
    """Probe p's Rademacher vector (+-1) of length n for `seed`, drawn on
    the CPU from torch.Generator(seed, p) and kept on `device` in `dtype`
    from its first use on. Making one inside a CUDA graph capture raises:
    the runner's eager warm-up makes every vector its graph reads."""
    device = torch.device(device)
    key = (n, p, seed, device, dtype)
    v = _PROBES.get(key)
    if v is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"probe vector (n={n}, p={p}) first needed inside a CUDA "
                f"graph capture; the runner's warm-up should have made it")
        g = torch.Generator().manual_seed(seed * 65537 + p)
        bits = torch.randint(0, 2, (n,), generator=g)
        v = (2.0 * bits - 1.0).to(device=device, dtype=dtype)
        _PROBES[key] = v
    return v


def freivalds_detect(c, x, w, *, probes: int, seed: int, rtol: float,
                     transpose: bool = False):
    """Randomized verification: ``C @ v`` against ``A @ (B @ v)`` in f32
    for `probes` independent Rademacher vectors. Returns an int64 device
    flag. An adversarial corruption is missed with probability <=
    2**-probes; a lone element above the tolerance is always caught (its
    row residual is exactly +-delta). B @ v sums w's products with +-1,
    which are exact in w's dtype, in f32 (no f32 copy of w)."""
    xf = x.float()
    N = c.shape[1]
    tol = _tol(c, rtol * max(1, int(N)) ** 0.5)   # residuals sum ~sqrt(N)
    worst = []
    for p in range(probes):
        v = probe_vector(N, p, seed, c.device, torch.float32)
        vw = probe_vector(N, p, seed, c.device, w.dtype)
        if transpose:                             # w [N, K]
            bv = (w * vw[:, None]).sum(dim=0, dtype=torch.float32)
        else:                                     # w [K, N]
            bv = (w * vw[None, :]).sum(dim=1, dtype=torch.float32)
        with no_tf32():
            worst.append((c @ v - xf @ bv).abs().amax())
    worst = worst[0] if probes == 1 else torch.stack(worst).amax()
    return (worst > tol).long()


def tile_of(row, col, block_m: int, block_n: int):
    """Map a located element to its (block_m, block_n) output tile."""
    return row // block_m, col // block_n


# ---------------------------------------------------------------------------
# Deterministic kernel-level SDC injection (a testing hook: serve/chaos.py
# draws the plan on the host, the corruption itself runs on the device)
# ---------------------------------------------------------------------------

_MINSTD = (48271, 2147483647)      # Park-Miller: no int64 overflow


def sdc_draws(seed) -> torch.Tensor:
    """A plan's draw seed (an int64 device scalar) hashed to two draws on
    the device, [2] int64: MINSTD steps, no overflow in int64."""
    a, m = _MINSTD
    z = (seed % m + 1) * a % m * a % m
    return torch.stack([z, z * a % m])


def inject_sdc(c, gemm_index: int, plan, magnitude: float, data_m: int,
               data_n: int, draws=None):
    """Corrupt the raw GEMM output c (contiguous, data in its first data_m
    rows and data_n columns) in place per an int64[3] plan
    ``(target_gemm, draw_seed, n_elems)`` and return it. A no-op unless
    ``target_gemm == gemm_index``. Element e lands at ``((r0+e) % data_m,
    (c0+e) % data_n)`` with (r0, c0) drawn from ``draw_seed``
    (``draws``, sdc_draws of it, when given): successive elements occupy
    distinct rows AND columns (for data_m, data_n >= 2), so
    ``n_elems >= 2`` always defeats the single-corruption location."""
    if draws is None:
        draws = sdc_draws(plan[1])
    e = torch.arange(MAX_SDC_ELEMS, device=c.device)
    rows = (draws[0] % data_m + e) % data_m
    cols = (draws[1] % data_n + e) % data_n
    armed = (plan[0] == gemm_index) & (e < plan[2])
    amt = torch.where(armed, magnitude, 0.0).to(c.dtype)
    c.view(-1).scatter_add_(0, rows * c.shape[1] + cols, amt)
    return c


# ---------------------------------------------------------------------------
# The guarded GEMM
# ---------------------------------------------------------------------------

def guarded_gemm(x, w, scale=None, bias=None, *, guard: PodGuard,
                 activation: str | None = None, out_dtype=torch.float32,
                 transpose: bool = False):
    """Pod GEMM under a PodGuard: raw kernel -> (inject) -> verify and
    repair -> epilogue. x [M, K]; w [K, N] ([N, K] when ``transpose``).

    Records (corrected, uncorrected) on the active GuardTape; a call
    without a tape just returns the verified output."""
    if guard.mode == OFF:
        raise ValueError("guarded_gemm called with guard off: the caller "
                         "should take the unguarded path")
    M = x.shape[0]
    N = w.shape[0] if transpose else w.shape[1]
    if guard.mode == ABFT and x.dtype == torch.int8:
        raise ValueError("abft guard does not support int8 operands: the "
                         "column-sum checksum row overflows int8; use "
                         "mode='probe' or dequantize first")
    from .ops import systolic_gemm, systolic_gemm_t
    kern = systolic_gemm_t if transpose else systolic_gemm

    tape = active_tape()
    idx = tape.next_index() if tape is not None else 0
    inject = tape is not None and tape.inject is not None
    if guard.mode == ABFT:
        x_aug = augment_x(x)
        w_aug = augment_wt(w) if transpose else augment_w(w)
        c_aug = kern(x_aug, w_aug, None, None, activation=None,
                     out_dtype=torch.float32)
        if inject:
            inject_sdc(c_aug, idx, tape.inject, tape.magnitude, M, N,
                       draws=tape.draws)
        c, report = abft_verify(c_aug, x, w, rtol=guard.rtol,
                                transpose=transpose)
        corrected, uncorrected = report["corrected"], report["uncorrected"]
    else:                                       # PROBE: detect only
        c = kern(x, w, None, None, activation=None, out_dtype=torch.float32)
        if inject:
            inject_sdc(c, idx, tape.inject, tape.magnitude, M, N,
                       draws=tape.draws)
        uncorrected = freivalds_detect(c, x, w, probes=guard.probes,
                                       seed=guard.probe_seed,
                                       rtol=guard.rtol, transpose=transpose)
        corrected = None
    if tape is not None:
        tape.record(corrected, uncorrected)
    return epilogue_ref(c, scale, bias, activation=activation).to(out_dtype)
