"""Parallel training (``iotml.parallel``'s twin): the device mesh and
its shard-map runtime, the multi-process join, data-parallel training
and its streaming feeds, ring attention and the sequence-parallel
SensorFormer step, the pipeline schedule and expert parallelism."""

from . import distributed  # noqa: F401
from .data_parallel import (ShardedTrainer, make_sharded_eval_step,  # noqa: F401
                            param_specs, shard_params)
from .expert_parallel import make_ep_train_step, shard_expert_params  # noqa: F401
from .mesh import auto_mesh, batch_sharding, make_mesh, replicated  # noqa: F401
from .pipeline import (make_pp_train_step, pipeline_apply,  # noqa: F401
                       pipeline_schedule)
from .ring_attention import make_ring_attention, ring_attention  # noqa: F401
from .seq_parallel import make_sp_train_step  # noqa: F401
