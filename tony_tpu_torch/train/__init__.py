"""Training library: train step (one device, or dp x fsdp over a mesh), loop,
data, checkpointing."""

from tony_tpu_torch.train.data import DataConfig, make_batches
from tony_tpu_torch.train.loop import FitConfig, fit
from tony_tpu_torch.train.prefetch import PrefetchIterator
from tony_tpu_torch.train.trainer import (
    TrainState,
    default_optimizer,
    make_train_state,
    make_train_step,
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
]
