"""The port's copy of repro.tenancy's modules that the serving controls
need: the admission controller prices requests with the wave model
(`planner.predict_latency_s` over `trace.request_gemms`), and the engine
records its timeline with `trace.ServeTraceRecorder`. `sweep.py` (the
Fig-11 reproduction) is not copied: no ported module runs it.

  mix.py     - declarative tenant mixes; merged co-schedules
  planner.py - time-multiplexed vs space-shared co-schedule planner and
               the per-request latency prediction
  trace.py   - the engine's recorded timeline lowered to GEMM streams
"""

from .mix import (Tenant, TenantMix, mix_grid, pack_mixes, solo_workloads,
                  tenant, tenant_depths)
from .planner import (SPACE_SHARE, TIME_MUX, TenancyPlan, TenantReport,
                      partition_pods, plan_mix_scalar, plan_mixes,
                      plan_space_share, plan_time_mux, predict_latency_s)
from .trace import (ServeTraceRecorder, request_gemms, trace_tenant,
                    trace_to_gemms)

__all__ = [
    "Tenant", "TenantMix", "mix_grid", "pack_mixes", "solo_workloads",
    "tenant", "tenant_depths",
    "SPACE_SHARE", "TIME_MUX", "TenancyPlan", "TenantReport",
    "partition_pods", "plan_mix_scalar", "plan_mixes", "plan_space_share",
    "plan_time_mux", "predict_latency_s",
    "ServeTraceRecorder", "request_gemms", "trace_tenant", "trace_to_gemms",
]
