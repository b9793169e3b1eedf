"""The port's checkpointing (counterpart of :mod:`tpudist.elastic`); the
elastic loop and workers come with ROADMAP Queue A 8."""

from tpudist_torch.elastic.checkpoint import (
    Checkpointer,
    latest_step,
    restore_pytree,
    save_pytree,
)

__all__ = ["Checkpointer", "latest_step", "restore_pytree", "save_pytree"]
