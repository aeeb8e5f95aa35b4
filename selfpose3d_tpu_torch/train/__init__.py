from selfpose3d_tpu_torch.train.schedule import multistep_lr
from selfpose3d_tpu_torch.train.step import (
    SSVLosses,
    distribute,
    inner_model,
    make_inference_step,
    make_ssv_debug_forward,
    make_ssv_train_step,
    make_supervised_train_step,
)
from selfpose3d_tpu_torch.train.train_state import (
    TrainState,
    create_train_state,
    make_optimizer,
    trainable_labels,
)

__all__ = [
    "SSVLosses",
    "TrainState",
    "create_train_state",
    "distribute",
    "inner_model",
    "make_inference_step",
    "make_optimizer",
    "make_ssv_debug_forward",
    "make_ssv_train_step",
    "make_supervised_train_step",
    "multistep_lr",
    "trainable_labels",
]
