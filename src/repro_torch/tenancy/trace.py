# Copy of src/repro/tenancy/trace.py (the port imports nothing of repro).
"""Trace bridge: serve/engine.py request streams -> GemmSpec tenants.

`ServeTraceRecorder` plugs into `ServeEngine(tracer=...)` and records the
engine's actual prefill / step-locked-decode events as it serves a request
stream. `trace_to_gemms` then lowers the recorded timeline to the same
GEMM-trace form as core/workloads.py: each prefill contributes the prompt's
projection/attention/FFN GEMMs at d1 = prompt length; each decode step
contributes the *fused* batched GEMMs the continuous batcher actually runs
(d1 = live lanes for the weight GEMMs — many tenants' decode GEMVs fused
into one GEMM is exactly the paper's §6.1 multi-tenant utilization
argument) plus the per-step attention reads at the lanes' true context
lengths.

The result feeds the co-schedule planner (tenancy/planner.py) with
realistic serving workloads instead of hand-written suite traces:

    rec = ServeTraceRecorder()
    engine = ServeEngine(model, params, tracer=rec)
    ... submit / run_to_completion ...
    t = trace_tenant("llm-serve", rec, model.cfg, slo_latency_s=1e-3)
    plans = plan_mixes([TenantMix("serve+cnn", (t, cnn_tenant))], designs)
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig
from ..core.tiling import GemmSpec
from ..core.workloads import _Trace
from ..obs.export import Span
from .mix import Tenant


@dataclasses.dataclass
class ServeTraceRecorder:
    """Engine-side event log; see ServeEngine(tracer=...) in serve/engine.py.

    Events are ("prefill", prompt_len, t) and ("decode", lanes, contexts,
    t) — the step-locked sequence the pods would see. `t` is the event's
    engine-relative start time; when the caller doesn't pass one (synthetic
    traces, older callers) a monotonically increasing record index stands
    in, so recording order is the time order. `trace_to_gemms` sorts on
    `t` before lowering: priority scheduling can *record* interleaved
    prefill/decode spans out of wall-clock order (a short-deadline lane's
    prefill lands between decode chunks that were recorded first), and the
    wave-model latency prediction is only faithful on the time-ordered
    stream.

    Events carry the GEMM-shaping facts (what `trace_to_gemms` lowers);
    `spans` additionally carry the host wall-clock of every device call
    the engine made (one span per prefill launch / fused decode chunk),
    which `obs.export.to_chrome_trace` turns into a Perfetto-loadable
    timeline and `obs.drift` pairs with the wave-model prediction.
    """

    events: list[tuple] = dataclasses.field(default_factory=list)
    spans: list[Span] = dataclasses.field(default_factory=list)

    def _stamp(self, t: float | None) -> float:
        return float(len(self.events)) if t is None else float(t)

    def on_prefill(self, rid: int, prompt_len: int,
                   t: float | None = None) -> None:
        self.events.append(("prefill", int(prompt_len), self._stamp(t)))

    def on_decode(self, lanes: int, contexts: list[int],
                  t: float | None = None) -> None:
        self.events.append(("decode", int(lanes),
                            tuple(int(c) for c in contexts),
                            self._stamp(t)))

    def on_span(self, name: str, ts: float, dur: float, cat: str = "serve",
                **args) -> None:
        self.spans.append(Span(name=name, ts=float(ts), dur=float(dur),
                               cat=cat, args=args))

    @property
    def num_prefills(self) -> int:
        return sum(1 for e in self.events if e[0] == "prefill")

    @property
    def num_decode_steps(self) -> int:
        return sum(1 for e in self.events if e[0] == "decode")

    def phase_seconds(self, cat: str) -> float:
        """Total host wall-clock spent in spans of category `cat`."""
        return sum(s.dur for s in self.spans if s.cat == cat)

    def phase_tokens(self, kind: str) -> int:
        """Tokens processed by events of `kind`: prompt tokens for
        prefills, emitted (per-lane) tokens for decode steps."""
        return sum(e[1] for e in self.events if e[0] == kind)


def _event_time(ev: tuple) -> float:
    """Start time of a recorded event (the tuple's trailing stamp);
    events appended without one (hand-built tuples) sort as t=0, which the
    stable sort keeps in recording order."""
    return ev[-1] if isinstance(ev[-1], float) else 0.0


def _layer_gemms(t: _Trace, cfg: ArchConfig, d1: int, attn_d1: int,
                 ctx: int, include_attention: bool) -> None:
    """One transformer layer's GEMMs at batch-rows d1 (fused lanes)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    kv = max(1, cfg.n_kv_heads)
    prev = t._next - 1
    q = t.add(d1, d, cfg.n_heads * hd, deps=(prev,), name="q")
    k = t.add(d1, d, kv * hd, deps=(prev,), name="k")
    v = t.add(d1, d, kv * hd, deps=(prev,), name="v")
    last: tuple[int, ...] = (q, k, v)
    if include_attention and ctx > 0:
        sc = t.add(attn_d1, hd, ctx, deps=(q, k), name="qk")
        av = t.add(attn_d1, ctx, hd, deps=(sc, v), name="av")
        last = (av,)
    o = t.add(d1, cfg.n_heads * hd, d, deps=last, name="o")
    f1 = t.add(d1, d, cfg.d_ff, deps=(o,), name="ffn_up")
    t.add(d1, cfg.d_ff, d, deps=(f1,), name="ffn_down")


def trace_to_gemms(recorder: ServeTraceRecorder, cfg: ArchConfig,
                   include_attention: bool = True,
                   include_lm_head: bool = False,
                   kinds: tuple[str, ...] | None = None,
                   max_events: int | None = None) -> list[GemmSpec]:
    """Lower a recorded serving timeline to a GemmSpec stream.

    Events chain sequentially (the engine is step-locked: a prefill or a
    decode step must drain before the next step launches), layers chain
    within an event — the same dependency discipline as
    workloads.transformer_lm, with d1 set by what the engine actually
    batched rather than a hypothetical shape.

    `kinds` restricts the lowering to a subset of event kinds (e.g.
    ``("decode",)`` for the per-phase drift rows of obs/drift.py); the
    filtered events still chain sequentially among themselves.
    `max_events` caps the number of (filtered) events lowered — the
    slice-accurate scheduler the drift check runs is O(tiles), so drift
    sampling bounds it.

    Events are lowered in *start-time* order, not record order: admission
    policies that reorder lanes (serve/admission.py priority scheduling)
    may record a prefill span after decode chunks that started later, and
    the sequential-chain dependency discipline below is only correct on
    the time-ordered stream. The sort is stable, so events recorded
    without timestamps (synthetic traces) keep their recording order.
    """
    t = _Trace()
    events = sorted(recorder.events, key=_event_time)
    if kinds is not None:
        events = [e for e in events if e[0] in kinds]
    if max_events is not None:
        events = events[:max_events]
    for ev in events:
        if ev[0] == "prefill":
            seq = ev[1]
            for _ in range(cfg.n_layers):
                # prompt attention: all heads' (seq x hd) @ (hd x seq)
                # score GEMMs fused row-wise, like the decode events below
                _layer_gemms(t, cfg, d1=seq, attn_d1=seq * cfg.n_heads,
                             ctx=seq, include_attention=include_attention)
        else:
            lanes, contexts = ev[1], ev[2]
            ctx = max(1, round(sum(contexts) / len(contexts))) \
                if contexts else 0
            for _ in range(cfg.n_layers):
                # decode: weight GEMMs fuse all live lanes into d1 = lanes;
                # attention reads are per-lane-per-head GEMVs at the mean
                # context length of the step's lanes
                _layer_gemms(t, cfg, d1=lanes,
                             attn_d1=lanes * cfg.n_heads, ctx=ctx,
                             include_attention=include_attention)
        if include_lm_head and cfg.vocab:
            # ev[1] is rows either way: prompt length or fused lanes
            t.add(ev[1], cfg.d_model, cfg.vocab, name="lm_head")
    return t.gemms


def request_gemms(cfg: ArchConfig, prompt_len: int, new_tokens: int,
                  lanes: int = 1, include_attention: bool = True,
                  include_lm_head: bool = False) -> list[GemmSpec]:
    """The GEMM stream ONE request would put through the engine: a
    prefill event at the prompt length followed by `new_tokens` decode
    steps at growing context — the same lowering `trace_to_gemms` applies
    to recorded timelines, built *predictively* for a request that has not
    run yet. `lanes` prices the decode steps as if fused with that many
    live lanes (1 = the request decodes alone, the conservative admission
    estimate). This is the admission controller's per-request cost model
    (serve/admission.py): the wave model turns it into predicted service
    seconds, so `TenancyPlan.slo_attainment`-style SLO accounting can
    *choose* admission instead of only reporting after the fact."""
    rec = ServeTraceRecorder()
    rec.on_prefill(0, prompt_len)
    for s in range(max(0, int(new_tokens))):
        rec.on_decode(lanes, [prompt_len + s] * lanes)
    return trace_to_gemms(rec, cfg, include_attention=include_attention,
                          include_lm_head=include_lm_head)


def trace_tenant(name: str, recorder: ServeTraceRecorder, cfg: ArchConfig,
                 replicas: int = 1, slo_latency_s: float | None = None,
                 **kw) -> Tenant:
    """Recorded serving stream as a planner Tenant (see tenancy/mix.py)."""
    gemms = trace_to_gemms(recorder, cfg, **kw)
    if not gemms:
        wanted = kw.get("kinds") or ("prefill", "decode")
        recorded = sorted({e[0] for e in recorder.events})
        missing = [k for k in wanted if k not in recorded] or list(wanted)
        raise ValueError(
            f"tenant {name!r}: recorder saw no {'/'.join(missing)} events"
            f" (recorded phases: {', '.join(recorded) if recorded else 'none'})"
            " — construct the engine with ServeEngine(tracer=recorder) (the"
            " `tracer` kwarg) and run it through the missing phase before"
            " lowering the trace")
    return Tenant(name=name, gemms=tuple(gemms), replicas=replicas,
                  slo_latency_s=slo_latency_s)
