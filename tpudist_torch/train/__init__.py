"""The port's training state (counterpart of :mod:`tpudist.train`)."""

from tpudist_torch.train.state import TrainState, adam, fold_in, sgd

__all__ = ["TrainState", "adam", "fold_in", "sgd"]
