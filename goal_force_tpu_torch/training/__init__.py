"""ControlNet training on the port (``train_step``: loss, optimizer, step;
``trainer``: the epoch loop, checkpoints and resume)."""
from goal_force_tpu_torch.training.train_step import (
    AdamW,
    TrainState,
    make_optimizer,
    make_train_step,
    training_loss,
)

__all__ = ["AdamW", "TrainState", "make_optimizer", "make_train_step", "training_loss"]
