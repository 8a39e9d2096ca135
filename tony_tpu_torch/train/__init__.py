"""Training library: train step (one device, or dp x pp x fsdp x ep x tp x sp
over a mesh, pp through the GPipe and 1F1B pipeline losses), loop, data,
checkpointing."""

from tony_tpu_torch.train.data import DataConfig, make_batches
from tony_tpu_torch.train.loop import FitConfig, fit
from tony_tpu_torch.train.prefetch import PrefetchIterator
from tony_tpu_torch.train.trainer import (
    TrainState,
    default_optimizer,
    make_train_state,
    make_train_step,
    pp_rules,
)

__all__ = [
    "DataConfig",
    "FitConfig",
    "PrefetchIterator",
    "TrainState",
    "default_optimizer",
    "fit",
    "make_batches",
    "make_train_state",
    "make_train_step",
    "pp_rules",
]
