"""Multi-tenant co-scheduling walkthrough on the PyTorch port's copy of
repro.tenancy (counterpart of examples/tenancy_mix.py).

Three stops:
  1. the Fig-11 reproduction — ResNet + 2x BERT co-scheduled vs
     back-to-back sequential, across pod counts (one batched planner call);
  2. policy face-off — time-multiplexed vs space-shared pods, with
     per-tenant latency, SLO attainment and Jain fairness;
  3. the serve bridge — a recorded continuous-batching timeline
     (synthetic here; ServeEngine(tracer=...) records a real one) planned
     against a CNN tenant.

Run:  PYTHONPATH=src python examples/torch_tenancy_mix.py
"""

from __future__ import annotations

from repro_torch.configs import get_arch, reduced
from repro_torch.core.workloads import bert, resnet
from repro_torch.tenancy import (SPACE_SHARE, TIME_MUX, ServeTraceRecorder,
                                 Tenant, TenantMix, fig11_mixes, plan_mixes,
                                 plan_time_mux, trace_tenant)


def show(plan) -> None:
    print(f"  [{plan.policy:>11}] {plan.mix}: "
          f"eff={plan.effective_tops_at_tdp:6.1f} TOPS  "
          f"seq={plan.sequential_effective_tops:6.1f}  "
          f"gain={plan.parallel_gain:.2f}x  fair={plan.fairness:.3f}  "
          f"slo={plan.slo_attainment:.0%}")
    for s in plan.streams:
        tag = "" if s.slo_met is None else ("  SLO ok" if s.slo_met
                                            else "  SLO MISS")
        print(f"      {s.tenant:<18} {s.latency_s * 1e6:8.1f} us "
              f"(solo {s.solo_latency_s * 1e6:8.1f} us, "
              f"x{s.slowdown:.2f}, {s.pods} pods){tag}")


def main() -> None:
    print("== Fig 11: co-scheduling vs sequential (batch 1) ==")
    mixes = fig11_mixes(batches=(1,))
    for pods in (128, 256):
        plan = plan_time_mux(mixes, [(32, 32, "butterfly-2", pods)])[0][0]
        print(f"  {pods} pods: gain={plan.parallel_gain:.2f}x "
              f"(paper: 1.44x at 256)")

    print("\n== policy face-off on 256 pods ==")
    slo_mix = TenantMix(name="rn+bert", tenants=(
        Tenant(name="resnet50", gemms=tuple(resnet(50, 224)),
               slo_latency_s=120e-6),
        Tenant(name="bert-medium", gemms=tuple(bert("medium", 100)),
               replicas=2, slo_latency_s=80e-6)))
    for policy in (TIME_MUX, SPACE_SHARE):
        plan = plan_mixes([slo_mix], [(32, 32, "butterfly-2", 256)],
                          policy=policy)[0][0]
        show(plan)

    print("\n== serve-engine trace as a tenant ==")
    cfg = reduced(get_arch("granite-8b"))
    rec = ServeTraceRecorder()          # ServeEngine(tracer=rec) feeds this
    rec.on_prefill(0, 24)
    for step in range(8):
        rec.on_decode(2, [24 + step, 16 + step])
    lm = trace_tenant("lm-serve", rec, cfg)
    plan = plan_time_mux(
        [TenantMix(name="serve+cnn", tenants=(
            lm, Tenant(name="resnet50", gemms=tuple(resnet(50, 64)))))],
        [(32, 32, "butterfly-2", 64)])[0][0]
    show(plan)


if __name__ == "__main__":
    main()
