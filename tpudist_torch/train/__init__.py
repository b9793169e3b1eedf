"""The port's training state and trainer (counterpart of
:mod:`tpudist.train`)."""

from tpudist_torch.train.state import TrainState, adam, fold_in, sgd
from tpudist_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["TrainState", "Trainer", "TrainerConfig", "adam", "fold_in",
           "sgd"]
