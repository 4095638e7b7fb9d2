"""The port's copy of repro.tenancy's modules: the admission controller
prices requests with the wave model (`planner.predict_latency_s` over
`trace.request_gemms`), the engine records its timeline with
`trace.ServeTraceRecorder`, and examples/torch_tenancy_mix.py runs the
Fig-11 reproduction (`sweep.fig11_mixes`).

  mix.py     - declarative tenant mixes; merged co-schedules
  planner.py - time-multiplexed vs space-shared co-schedule planner and
               the per-request latency prediction
  sweep.py   - the batched Fig-11 reproduction + tenant-mix DSE
  trace.py   - the engine's recorded timeline lowered to GEMM streams
"""

from .mix import (Tenant, TenantMix, mix_grid, pack_mixes, solo_workloads,
                  tenant, tenant_depths)
from .planner import (SPACE_SHARE, TIME_MUX, TenancyPlan, TenantReport,
                      partition_pods, plan_mix_scalar, plan_mixes,
                      plan_space_share, plan_time_mux, predict_latency_s)
from .sweep import (default_mixes, dse_designs, fig11_mixes, fig11_sweep,
                    mix_dse)
from .trace import (ServeTraceRecorder, request_gemms, trace_tenant,
                    trace_to_gemms)

__all__ = [
    "Tenant", "TenantMix", "mix_grid", "pack_mixes", "solo_workloads",
    "tenant", "tenant_depths",
    "SPACE_SHARE", "TIME_MUX", "TenancyPlan", "TenantReport",
    "partition_pods", "plan_mix_scalar", "plan_mixes", "plan_space_share",
    "plan_time_mux", "predict_latency_s",
    "default_mixes", "dse_designs", "fig11_mixes", "fig11_sweep", "mix_dse",
    "ServeTraceRecorder", "request_gemms", "trace_tenant", "trace_to_gemms",
]
