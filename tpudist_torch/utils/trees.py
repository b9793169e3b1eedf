"""Helpers over nested state (counterpart of :mod:`tpudist.utils.trees`).

tpudist's checkpoints are pytrees; the port's are nested mappings (and
lists) of tensors and plain numbers: a model's ``state_dict()``, an
optimizer's ``state_dict()["state"]`` (keyed by parameter index),
counters.  Leaves are named by their ``/``-joined path
(``params/dense.0.weight``, ``opt_state/3/exp_avg``), which are the
member names of a checkpoint's ``.npz`` archive.  The port's random
state is an integer seed, so there is no key leaf to special-case
(tpudist's ``is_prng_key``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch


def _children(node: Any) -> Iterator[tuple[str, Any]] | None:
    if isinstance(node, Mapping):
        return ((str(k), v) for k, v in node.items())
    if isinstance(node, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(node))
    return None


def _leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix or ".", tree
        return
    for k, v in kids:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else k)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over every leaf; mappings come back as dicts with the same
    keys, lists and tuples as their own type."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_dtype(leaf: Any) -> np.dtype:
    """The numpy dtype a leaf is stored as (bfloat16, which numpy lacks,
    as float32)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def leaf_to_host(x: Any) -> np.ndarray:
    """One leaf as a host numpy array that aliases nothing the caller
    can mutate (a tensor is copied off its device, an array is
    copied)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy().copy()
    return np.array(x, copy=True)


def tree_to_numpy(tree: Any) -> Any:
    """Every leaf copied to host numpy (:func:`leaf_to_host`)."""
    return tree_map(leaf_to_host, tree)


def tree_size_bytes(tree: Any) -> int:
    total = 0
    for _, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total


def flatten_with_names(tree: Any) -> dict[str, np.ndarray]:
    """``{path: host array}`` with stable, human-readable keys (tensors
    copied to the host, arrays and numbers as they are)."""
    return {k: leaf_to_host(v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in _leaves(tree)}


def _like(leaf: Any, val: np.ndarray) -> Any:
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(val, copy=True)).to(
            device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return val
    return type(leaf)(val.item()) if isinstance(
        leaf, (bool, int, float)) else val


def unflatten_like(template: Any, named: Mapping[str, np.ndarray]) -> Any:
    """Inverse of :func:`flatten_with_names` given a structural template:
    each leaf checked against the template's shape and stored dtype, and
    returned as the template's kind (a tensor on the template's device and
    in its dtype, an array, a Python number).  A leaf the template has and
    ``named`` lacks, or the other way round, raises ``KeyError``; a shape
    or dtype that differs raises ``ValueError``."""
    want = dict(_leaves(template))
    extra = sorted(set(named) - set(want))
    if extra:
        raise KeyError(f"checkpoint has leaves the template lacks: {extra}")
    for key, leaf in want.items():
        if key not in named:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        val = np.asarray(named[key])
        shape = tuple(leaf.shape) if isinstance(
            leaf, (torch.Tensor, np.ndarray)) else ()
        if tuple(val.shape) != shape:
            raise ValueError(f"checkpoint leaf {key!r} shape {val.shape} != "
                             f"template {shape}")
        if val.dtype != _host_dtype(leaf):
            raise ValueError(f"checkpoint leaf {key!r} dtype {val.dtype} != "
                             f"template {_host_dtype(leaf)}")

    def rebuild(node: Any, prefix: str) -> Any:
        if isinstance(node, Mapping):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}/{i}" if prefix
                                      else str(i))
                              for i, v in enumerate(node))
        return _like(node, np.asarray(named[prefix or "."]))

    return rebuild(template, "")
