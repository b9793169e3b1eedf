"""Rank-stamped logging (counterpart of :mod:`tpudist.utils.logging`):
standard :mod:`logging` with a ``[pN]`` process stamp.

The rank is read at emission time from ``torch.distributed`` when a
process group is up, and is 0 otherwise, so a logger made at import
time stamps the right rank once the trainer has joined its group.
"""

from __future__ import annotations

import logging
import sys

import torch.distributed as dist

_configured = False


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class _RankFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        record.rank = _rank()
        return super().format(record)


def get_logger(name: str = "tpudist_torch") -> logging.Logger:
    """A logger under the ``tpudist_torch`` root, which writes INFO and
    above to stderr with the time, rank and logger name."""
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_RankFormatter(
            fmt="%(asctime)s [p%(rank)s] %(name)s %(levelname)s: "
                "%(message)s",
            datefmt="%H:%M:%S"))
        root = logging.getLogger("tpudist_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logger


def coordinator_only(logger: logging.Logger) -> logging.Logger:
    """Silence INFO output on every rank but 0 (call once the process
    group is up) to avoid N-way duplicated logs."""
    if _rank() != 0:
        logger.setLevel(logging.WARNING)
    return logger
