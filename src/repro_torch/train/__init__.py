"""repro_torch.train: the port's copy of ``repro.train``.

:func:`make_train_step` (microbatched AdamW, int8 error feedback,
rematerialised units through the model), :func:`make_serve_step` and
:func:`make_prefill`; checkpoints in the reference's format
(:mod:`.checkpoint`); the retrying runner, straggler watch and elastic
re-mesh (:mod:`.fault`); and the partition rules with their placement
over ``torch.distributed`` ranks (:mod:`.sharding`): given a mesh of
ranks, the train step, the serve step, prefill and checkpoints are
sharded.
"""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .fault import RetryingRunner, StragglerWatch, elastic_remesh
from .sharding import batch_shardings, param_shardings, state_shardings
from .step import (TrainParts, make_prefill, make_serve_step,
                   make_train_parts, make_train_step)

__all__ = ["make_train_step", "make_train_parts", "TrainParts",
           "make_serve_step", "make_prefill",
           "param_shardings", "batch_shardings", "state_shardings",
           "save_checkpoint", "restore_checkpoint", "latest_step",
           "RetryingRunner", "StragglerWatch", "elastic_remesh"]
