"""Configuration helpers (counterpart of :mod:`tpudist.utils.config`):
boolean environment flags, and one dataclass config per workload with a
generated CLI in which any field can be overridden with ``--field value``.

The port keeps its own copy of what it needs: it imports nothing of the
JAX package, not even modules there that do not import JAX."""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Sequence, Type, TypeVar

T = TypeVar("T")

_FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str, default: bool = False) -> bool:
    """Parse a boolean environment variable the way users expect: unset
    (or empty) means ``default``; ``0`` / ``false`` / ``no`` / ``off``
    (any case) mean False; anything else means True."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in _FALSY


def config_field(default: Any, help: str = "") -> Any:  # noqa: A002 - argparse parlance
    return dataclasses.field(default=default, metadata={"help": help})


def _add_field_arg(parser: argparse.ArgumentParser,
                   f: dataclasses.Field) -> None:
    name = "--" + f.name.replace("_", "-")
    help_text = f.metadata.get("help", "")
    if f.type in ("bool", bool) or isinstance(f.default, bool):
        parser.add_argument(
            name,
            type=lambda s: s.lower() in ("1", "true", "yes"),
            default=f.default,
            help=f"{help_text} (default: {f.default})",
        )
    else:
        typ = type(f.default) if f.default is not None else str
        parser.add_argument(
            name, type=typ, default=f.default,
            help=f"{help_text} (default: {f.default})")


def make_parser(config_cls: Type[T],
                description: str = "") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    for f in dataclasses.fields(config_cls):
        if f.metadata.get("cli", True):
            _add_field_arg(parser, f)
    return parser


def cli_override(config_cls: Type[T], argv: Sequence[str] | None = None,
                 description: str = "") -> T:
    """Parse ``argv`` into an instance of ``config_cls``."""
    parser = make_parser(config_cls, description)
    ns = parser.parse_args(argv)
    names = {f.name for f in dataclasses.fields(config_cls)}
    return config_cls(**{k: v for k, v in vars(ns).items() if k in names})
