"""Configuration helpers (counterpart of :mod:`tpudist.utils.config`).

The port keeps its own copy of what it needs: it imports nothing of the
JAX package, not even modules there that do not import JAX."""

from __future__ import annotations

import os

_FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str, default: bool = False) -> bool:
    """Parse a boolean environment variable the way users expect: unset
    (or empty) means ``default``; ``0`` / ``false`` / ``no`` / ``off``
    (any case) mean False; anything else means True."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in _FALSY
