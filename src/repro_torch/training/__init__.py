"""The train step (the counterpart of ``repro.training``)."""

from repro_torch.training.step import (
    TrainStepConfig, init_train_state, make_train_step,
)

__all__ = ["TrainStepConfig", "init_train_state", "make_train_step"]
