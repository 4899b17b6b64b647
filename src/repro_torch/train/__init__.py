from .losses import cross_entropy
from .step import (TrainState, TrainStep, make_eval_step, make_train_step,
                   train_state_init)

__all__ = ["TrainState", "TrainStep", "make_eval_step", "make_train_step",
           "train_state_init", "cross_entropy"]
