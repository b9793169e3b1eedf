"""Durable checkpoints of nested training state (counterpart of
:mod:`tpudist.elastic.checkpoint`).

A checkpoint is one ``.npz`` archive keyed by leaf path
(:func:`tpudist_torch.utils.trees.flatten_with_names`) plus a JSON
metadata sidecar, written atomically (temporary file, fsync, rename), so
a preemption mid-write never corrupts the latest restore point.  No
framework object is pickled: any numpy reads it, and a restore is checked
leaf by leaf against a template's shapes and dtypes.

:class:`Checkpointer` adds step-numbered directories with ``COMMITTED``
markers and retention (``layout="steps"``), or one rolling file
(``layout="flat"``, the trainer's ``snapshot_path``), and asynchronous
saves.  The hazard an async save guards against: the optimizer updates
the parameters and its state *in place* right after ``save()`` returns
(tpudist's form of it is buffer donation).  So ``save()`` starts a copy
of every leaf before it returns: a CUDA tensor is copied into a pinned
host buffer by a ``non_blocking`` copy on a side stream, which waits for
the work the caller has queued, and the caller's stream then waits for
the copies, so no later in-place update can overtake them; a CPU tensor
or array is copied at once.  The writer thread waits for the copies'
event, then writes.  A failed background write is re-raised from the
next ``wait()``/``save()``/``restore_latest()``, never swallowed.
``last_blocked_s`` is the time the last ``save()`` held its caller.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tpudist_torch.utils.trees import (
    flatten_with_names,
    tree_map,
    tree_to_numpy,
    unflatten_like,
)

_STEP_RE = re.compile(r"^step_(\d+)$")


def _stage(tree: Any) -> tuple[Any, list]:
    """Start a copy of every leaf (see the module docstring): ``(the
    staged tree, the CUDA events its copies complete)``."""
    streams: dict[torch.device, Any] = {}

    def stage(leaf):
        if isinstance(leaf, np.ndarray):
            return leaf.copy()
        if not isinstance(leaf, torch.Tensor):
            return leaf
        t = leaf.detach()
        if t.device.type != "cuda":
            return t.clone()
        side = streams.get(t.device)
        if side is None:
            side = torch.cuda.Stream(t.device)
            side.wait_stream(torch.cuda.current_stream(t.device))
            streams[t.device] = side
        with torch.cuda.stream(side):
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
        return buf

    staged = tree_map(stage, tree)
    events = []
    for dev, side in streams.items():
        events.append(side.record_event())
        torch.cuda.current_stream(dev).wait_stream(side)
    return staged, events


def _meta_jsonable(meta: dict | None) -> dict | None:
    """``meta`` with tensors and numpy scalars as plain JSON values."""
    if meta is None:
        return None
    out = {}
    for k, v in meta.items():
        if v is None or isinstance(v, (str, bool, int, float)):
            out[k] = v
            continue
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        out[k] = arr.item() if arr.ndim == 0 else arr.tolist()
    return out


def save_pytree(path: str | os.PathLike, tree: Any,
                meta: dict | None = None) -> None:
    """Atomically write ``tree`` (and JSON-serialisable ``meta``) to
    ``path`` (a ``.npz`` file, with a ``<path>.meta.json`` sidecar)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    named = flatten_with_names(tree)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **named)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if meta is not None:
        mtmp = path.with_suffix(".meta.json.tmp")
        mtmp.write_text(json.dumps(meta))
        os.replace(mtmp, path.with_suffix(".meta.json"))


def restore_pytree(path: str | os.PathLike,
                   template: Any) -> tuple[Any, dict]:
    """Load a checkpoint into the structure of ``template`` (each leaf
    checked, and returned as the template's kind: see
    :func:`~tpudist_torch.utils.trees.unflatten_like`).  Returns
    ``(tree, meta)``."""
    path = Path(path)
    with np.load(path) as archive:
        named = {k: archive[k] for k in archive.files}
    tree = unflatten_like(template, named)
    meta_path = path.with_suffix(".meta.json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return tree, meta


def latest_step(directory: str | os.PathLike) -> int | None:
    """Highest step with a complete (``COMMITTED``) checkpoint in
    ``directory``."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    steps = []
    for child in directory.iterdir():
        m = _STEP_RE.match(child.name)
        if m and (child / "state.npz").exists() and (
                child / "COMMITTED").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class Checkpointer:
    """Checkpoint save-path manager (one instance per save target).

    ``layout="steps"`` (default): ``<dir>/step_<N>/state.npz`` (and its
    meta) with a ``COMMITTED`` marker written last (readers trust only
    marked checkpoints) and keep-N retention.

    ``layout="flat"``: ``directory`` names one ``.npz`` file that every
    save atomically replaces (``step`` goes to the meta sidecar; no
    retention): the trainer's rolling snapshot.

    With ``async_save=True``, :meth:`save` returns once the copies are
    started (see the module docstring); :meth:`wait` joins the in-flight
    write, and every save and restore joins the previous write first.
    """

    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 async_save: bool = False, layout: str = "steps") -> None:
        if layout not in ("steps", "flat"):
            raise ValueError(f"layout must be 'steps' or 'flat', got "
                             f"{layout!r}")
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self.layout = layout
        self.last_blocked_s = 0.0
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        """Join the in-flight write; re-raise (once) the exception a
        failed background write captured.  Returning normally means the
        last save is durable on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, meta: dict | None = None) -> None:
        t0 = time.perf_counter()
        if self.async_save:
            staged, events = _stage({"tree": tree, "meta": meta})
            self.wait()
            self._thread = threading.Thread(
                target=self._finish_async, args=(step, staged, events),
                daemon=True)
            self._thread.start()
        else:
            host_tree = tree_to_numpy(tree)
            self.wait()
            self._write(step, host_tree, _meta_jsonable(meta))
        self.last_blocked_s = time.perf_counter() - t0

    def _finish_async(self, step: int, staged: dict, events: list) -> None:
        try:
            for ev in events:
                ev.synchronize()
            self._write(step, tree_to_numpy(staged["tree"]),
                        _meta_jsonable(staged["meta"]))
        except BaseException as e:  # noqa: BLE001 - re-raised from wait()
            self._error = e

    def _write(self, step: int, host_tree: Any, meta: dict | None) -> None:
        if self.layout == "flat":
            save_pytree(self.directory, host_tree, meta)
            return
        step_dir = self.directory / f"step_{step}"
        save_pytree(step_dir / "state.npz", host_tree, meta)
        (step_dir / "COMMITTED").touch()
        self._retain()

    def _retain(self) -> None:
        steps = sorted(int(m.group(1)) for child in self.directory.iterdir()
                       if (m := _STEP_RE.match(child.name)))
        for old in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"step_{old}", ignore_errors=True)

    def restore_latest(self, template: Any) -> tuple[int, Any, dict] | None:
        """``(step, tree, meta)`` of the newest complete checkpoint, or
        None when the target holds none (a fresh start)."""
        self.wait()
        if self.layout == "flat":
            if not self.directory.exists():
                return None
            tree, meta = restore_pytree(self.directory, template)
            return int(meta.get("step", 0)), tree, meta
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, meta = restore_pytree(
            self.directory / f"step_{step}" / "state.npz", template)
        return step, tree, meta
