"""Distribution runtime (counterpart of repro/parallel): sharding rules on
DeviceMesh and DTensor, butterfly collectives (the paper's interconnect as
a collective schedule) on torch.distributed, SOSA-driven autosharding,
gradient compression."""

from .sharding import (act_pspec, batch_axes, batch_sharding, make_constrain,
                       pspec_for_axes, pspecs_from_schema,
                       shardings_from_schema, zero1_pspec)
from .collectives import (butterfly_all_gather, butterfly_all_reduce,
                          butterfly_all_reduce_expansion2,
                          butterfly_reduce_scatter, ring_all_reduce,
                          COLLECTIVES)
from .compression import compressed_psum, compression_ratio
from .autoshard import (ShardPlan, choose_blocks, choose_plan, device_gemms,
                        plan_report, tiles_exposed)
