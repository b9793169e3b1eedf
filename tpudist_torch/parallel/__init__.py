"""The port's parallel strategies (counterpart of :mod:`tpudist.parallel`):
so far the one-process data-parallel train step."""

from tpudist_torch.parallel.data_parallel import make_dp_train_step

__all__ = ["make_dp_train_step"]
