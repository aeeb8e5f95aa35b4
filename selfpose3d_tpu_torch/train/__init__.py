from selfpose3d_tpu_torch.train.schedule import multistep_lr
from selfpose3d_tpu_torch.train.step import make_ssv_train_step
from selfpose3d_tpu_torch.train.train_state import (
    TrainState,
    create_train_state,
    make_optimizer,
    trainable_labels,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "make_ssv_train_step",
    "multistep_lr",
    "trainable_labels",
]
