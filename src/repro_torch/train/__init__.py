"""Training (counterpart of repro/train): AdamW with f32 master weights
(optimizer.py), the train step with per-layer remat and microbatches
(train_step.py), checkpoints in the reference's layout (checkpoint.py),
the synthetic token stream (data.py) and the fault-tolerance hooks
(fault.py); data.py and fault.py are copies of the reference's files."""

from .optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw, lr_schedule
from .train_step import TrainConfig, make_eval_step, make_train_step
from .checkpoint import (latest_step, prune_checkpoints, restore_checkpoint,
                         save_checkpoint)
from .data import DataConfig, batches
from .fault import ElasticMesh, Heartbeat, StragglerPolicy
