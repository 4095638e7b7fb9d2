"""What a per-layer metric reads: the run's window, the engine's spans,
the steps' true work and the device trace, and the readers that the
files in metrics/ call. A reader returns None where its window holds
nothing to read, and the harness then leaves the metric out.
"""

from __future__ import annotations

import dataclasses

from . import trace as tr
from . import work
from .load import Load


@dataclasses.dataclass
class Context:
    cfg: dict
    mix: dict
    load: Load
    spans: list                 # load.Span, the engine's device calls
    prompt_len: dict            # rid -> true prompt length
    dev: list | None = None     # device ops of the traced steps
    host: list | None = None

    # -- the measured window -------------------------------------------
    def window_spans(self, prefix: str) -> list:
        ld = self.load
        return [s for s in self.spans if s.name.startswith(prefix)
                and ld.t_open <= s.t0 and s.t1 <= ld.t_close]

    @property
    def window_s(self) -> float:
        """The window less the profiler's own stop inside it."""
        return self.load.window_s - self.load.paused_s

    # -- the traced steps ----------------------------------------------
    @property
    def traced(self) -> tuple | None:
        return self.load.trace_window if self.dev else None

    @property
    def traced_s(self) -> float:
        a, b = self.traced
        return b - a

    def traced_steps(self) -> list:
        a, b = self.traced
        return [s for s in self.load.steps if a <= s.t0 and s.t1 <= b]

    def traced_prefill_calls(self) -> list[list[int]]:
        a, b = self.traced
        return [[self.prompt_len[r] for r in s.args["rids"]]
                for s in self.spans if s.name.startswith("prefill/")
                and a <= s.t0 and s.t1 <= b]

    def traced_decode_live(self) -> list[int]:
        return [n for s in self.traced_steps() for n in s.live]


def kernel_family(op: tr.Op) -> str | None:
    """pod_nn, pod_nt, grouped or flash for the port's kernels, by name and,
    for the wmma and simt mainloops that every GEMM form shares, by the
    launch's grid (z counts the groups); None for every other operation."""
    name = tr.short_name(op.name)
    base, _, targs = name.partition("<")
    args = [a.strip() for a in targs.rstrip(">").split(",")]
    if base.startswith("flash_fwd"):
        return "flash"
    if base == "gemm_bf16_splitk":
        return "pod_nt" if args[2] == "true" else "pod_nn"
    if base == "gemm_bf16_wgmma":
        return {"0": "pod_nn", "1": "pod_nt", "2": "grouped"}.get(args[0])
    if base in ("gemm_bf16_wmma", "gemm_simt"):
        if args[1 if base == "gemm_bf16_wmma" else 0] == "true":
            return "pod_nt"
        return "grouped" if len(op.grid) == 3 and op.grid[2] > 1 \
            else "pod_nn"
    return None


def kernel_seconds(ctx: Context, family: str) -> float:
    return sum(o.dur for o in ctx.dev if o.cat == "kernel"
               and kernel_family(o) == family) / 1e6


# -- readers -------------------------------------------------------------

def prefill_share(ctx: Context):
    """Percent of the window that the engine's prefill calls took."""
    if ctx.window_s <= 0:
        return None
    busy = sum(s.t1 - s.t0 for s in ctx.window_spans("prefill/"))
    return 100.0 * busy / ctx.window_s


def decode_step_ms(ctx: Context):
    """Wall milliseconds of the window's decode chunks per decode step."""
    spans = ctx.window_spans("decode/")
    steps = sum(s.args["steps"] for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / steps


def prefill_lane_efficiency(ctx: Context, slots: int):
    """Percent of the rows the window's prefill calls computed that were
    true prompt tokens: a bucketed call computes slots x bucket rows, an
    exact-length one its prompt."""
    spans = ctx.window_spans("prefill/")
    rows = sum((slots if s.name.startswith("prefill/bucket") else 1)
               * s.args["bucket"] for s in spans)
    if not rows:
        return None
    return 100.0 * sum(s.args["tokens"] for s in spans) / rows


def mfu(ctx: Context):
    """Percent of the bf16 peak that the traced steps' true tokens need."""
    if ctx.traced is None:
        return None
    steps = ctx.traced_steps()
    prompts = [P for s in steps for P in s.prefills]
    dec = sum(sum(s.live) for s in steps)
    flops = work.model_flops(ctx.cfg, prompts, sum(s.dec_ctx for s in steps),
                             dec)
    return 100.0 * flops / (ctx.traced_s * work.PEAK_FLOPS)


def roofline(ctx: Context, family: str):
    """Percent: the least time of the family's launches over their device
    time in the traced steps."""
    if ctx.traced is None:
        return None
    seconds = kernel_seconds(ctx, family)
    calls = ctx.traced_prefill_calls()
    live = ctx.traced_decode_live()
    if family == "pod_nn":
        w = work.pod(ctx.cfg, calls, live)
    elif family == "grouped":
        w = work.grouped(ctx.cfg, calls, live)
    elif family == "flash":
        w = work.flash(ctx.cfg, calls)
    else:
        raise ValueError(family)
    if seconds <= 0 or w.least_s <= 0:
        return None
    return 100.0 * w.least_s / seconds


def idle_share(ctx: Context):
    """Percent of the traced window in which no operation ran on the
    device."""
    if ctx.traced is None:
        return None
    return 100.0 * (1.0 - tr.busy_us(ctx.dev) / 1e6 / ctx.traced_s)
