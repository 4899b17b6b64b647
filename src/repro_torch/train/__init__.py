from .losses import cross_entropy
from .step import (DonatedStep, TrainState, TrainStep, make_eval_step,
                   make_train_step, train_state_init, train_state_specs)

__all__ = ["DonatedStep", "TrainState", "TrainStep", "make_eval_step",
           "make_train_step", "train_state_init", "train_state_specs",
           "cross_entropy"]
