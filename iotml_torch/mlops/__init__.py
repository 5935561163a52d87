"""iotml_torch.mlops — the model lifecycle (``iotml.mlops``'s twin):
async checkpoints, a versioned registry, zero-downtime rollout,
rollback-on-regression.

- ``ModelRegistry``: monotonic versions, manifest-as-commit-marker
  publication, offsets + metrics + lineage per version, torn-publish
  recovery, channel pointers with promote/rollback history — the JAX
  package's directory layout and JSON, so each package reads the other's;
- ``AsyncCheckpointer``: one device→host snapshot on the train thread,
  Keras h5 + ``state.npz`` serialization and the fsynced publish on a
  writer thread behind a bounded drop-oldest queue; group offsets commit
  only AFTER the checkpoint is durable;
- ``RegistryWatcher``: scorers hot-swap to a newly promoted version
  between super-batches;
- ``ABRollout`` + ``RolloutGate``: two versions score the same stream
  into their own prediction topics; the detection-quality gate promotes
  the candidate or rolls back.

The chaos points ``ckpt.write`` and ``registry.commit`` and the mlops
metric families are wired as in the JAX package.  The live drills
(``iotml.mlops.drill``) need the supervisor and are ROADMAP A14.
"""

from .checkpoint import AsyncCheckpointer, restore_trainer
from .registry import Manifest, ModelRegistry
from .rollout import ABRollout, RegistryWatcher, RolloutGate, scorer_quality

__all__ = ["AsyncCheckpointer", "restore_trainer", "Manifest",
           "ModelRegistry", "ABRollout", "RegistryWatcher", "RolloutGate",
           "scorer_quality"]
