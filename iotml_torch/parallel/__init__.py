"""Parallel training (``iotml.parallel``'s twin): the device mesh, the
multi-process join, data-parallel training and its streaming feeds, and
the one-device form of the sequence-parallel SensorFormer step.  Ring
attention, the multi-device sequence-parallel step and the pipeline
schedule are ROADMAP A11; expert parallelism is A12."""

from . import distributed  # noqa: F401
from .data_parallel import (ShardedTrainer, make_sharded_eval_step,  # noqa: F401
                            param_specs, shard_params)
from .mesh import auto_mesh, batch_sharding, make_mesh, replicated  # noqa: F401
from .seq_parallel import make_sp_train_step  # noqa: F401
