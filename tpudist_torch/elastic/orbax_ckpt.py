"""Sharded durable commits on ``torch.distributed.checkpoint`` (counterpart
of :mod:`tpudist.elastic.orbax_ckpt`).

This module keeps tpudist's path and class name, but it writes DCP
(``torch.distributed.checkpoint``), not Orbax: the name says which of
tpudist's checkpointers it stands in for.  The npz
:class:`~tpudist_torch.elastic.checkpoint.Checkpointer` gathers every
leaf into one archive, as the reference's ``torch.save`` snapshot does
(`mnist_ddp_elastic.py:95-104`).  :class:`OrbaxCheckpointer` has the same
interface (``save(step, tree, meta)`` / ``restore_latest(template)`` /
``wait()`` / ``close()``), with ``keep`` and ``async_save``, over DCP's
file-system writer:

* given a ``process_group``, every rank writes its own shards of the step
  (a ``DTensor`` leaf by its holders, a replicated tensor once) into one
  directory, and a restore loads each rank's part into the template's
  tensors in place — on their devices, in their placements;
* without one, each process writes its own checkpoint (an elastic
  worker's per-process directory, as tpudist's test worker gives each
  process its own Orbax manager);
* a step is written into a temporary directory and renamed to its step
  number once complete, so a crash mid-save never leaves a partial step
  that a restore would trust; ``keep`` steps are retained.

Steps never collide, as in tpudist: a repeated or regressing caller step
(elastic commits between optimizer steps; a fresh ``ElasticState`` after
a gang restart counts from 1) is written under ``latest + 1``, with the
caller's step kept as ``__logical_step__`` in the step's metadata, and
returned by :meth:`restore_latest`.  ``latest`` counts the steps this
process issued, so async quick commits never share a directory either.
"""

from __future__ import annotations

import inspect
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tpudist_torch.elastic.checkpoint import _meta_jsonable
from tpudist_torch.utils.trees import _leaves, _like

_LOGICAL_KEY = "__logical_step__"
_META = "meta.json"


def _dcp_kw(fn, no_dist: bool) -> dict:
    """``no_dist=`` where this torch's DCP takes it (older releases infer
    it from an uninitialised process group)."""
    return ({"no_dist": no_dist}
            if "no_dist" in inspect.signature(fn).parameters else {})


def _as_tensor(leaf: Any, copy: bool) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.to("cpu", copy=True) if copy else t
    return torch.from_numpy(np.array(np.asarray(leaf), copy=True))


class OrbaxCheckpointer:
    """Drop-in :class:`tpudist_torch.elastic.checkpoint.Checkpointer`
    alternative on ``torch.distributed.checkpoint`` (see the module
    docstring)."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 async_save: bool = False, process_group: Any = None) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.process_group = process_group
        # highest physical step issued by THIS process: with async saves
        # the directory may not show the one in flight yet
        self._last_physical: int | None = None
        self._thread: threading.Thread | None = None
        self._future: Any = None
        self._finish: Any = None
        self._error: BaseException | None = None

    # -- steps on disk -----------------------------------------------------

    def all_steps(self) -> list[int]:
        """Every complete physical step in the directory, ascending."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _META).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _rank(self) -> int:
        if self.process_group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.process_group)

    def _barrier(self) -> None:
        if self.process_group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.process_group)

    # -- save ----------------------------------------------------------------

    def wait(self) -> None:
        """Join the in-flight save; re-raise (once) what a failed
        background save raised.  Returning means the last save is
        durable."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._future is not None:
            fut, self._future = self._future, None
            try:
                fut.result()
                self._finish()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                self._error = e
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, meta: dict | None = None) -> None:
        issued = [s for s in (self.latest_step(), self._last_physical)
                  if s is not None]
        latest = max(issued) if issued else None
        physical = step if latest is None or step > latest else latest + 1
        self._last_physical = physical
        meta = {**(_meta_jsonable(meta) or {}), _LOGICAL_KEY: int(step)}
        # a copy when the write outlives this call (the caller updates its
        # tensors in place right after, as an optimizer step does)
        state = {name: _as_tensor(leaf, copy=self.async_save)
                 for name, leaf in _leaves(tree)}
        self.wait()
        tmp = self.directory / f".tmp-{physical}"
        if self._rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        self._barrier()

        def finish() -> None:
            self._barrier()
            if self._rank() == 0:
                (tmp / _META).write_text(json.dumps(meta))
                os.replace(tmp, self.directory / str(physical))
                self._retain()
            self._barrier()

        import torch.distributed.checkpoint as dcp

        writer = dcp.FileSystemWriter(str(tmp))
        no_dist = self.process_group is None
        if not self.async_save:
            dcp.save(state, storage_writer=writer,
                     process_group=self.process_group,
                     **_dcp_kw(dcp.save, no_dist))
            finish()
        elif no_dist:
            def run() -> None:
                try:
                    dcp.save(state, storage_writer=writer,
                             **_dcp_kw(dcp.save, True))
                    finish()
                except BaseException as e:  # noqa: BLE001 - from wait()
                    self._error = e

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            # the plan is agreed collectively now; the writes run in
            # DCP's own thread, the rename at the next wait()
            self._future = dcp.async_save(
                state, storage_writer=writer,
                process_group=self.process_group)
            self._finish = finish

    def _retain(self) -> None:
        steps = self.all_steps()
        for old in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def restore_latest(self, template: Any) -> tuple[int, Any, dict] | None:
        """``(step, tree, meta)`` of the newest complete step, or None on a
        fresh start.  Tensor leaves are loaded into fresh tensors like the
        template's (device, dtype, placement); other leaves come back as
        the template's kind."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        import torch.distributed.checkpoint as dcp

        leaves = list(_leaves(template))
        target = {name: (torch.empty_like(leaf.detach())
                         if isinstance(leaf, torch.Tensor)
                         else torch.from_numpy(
                             np.array(np.asarray(leaf), copy=True)))
                  for name, leaf in leaves}
        path = self.directory / str(step)
        dcp.load(target, storage_reader=dcp.FileSystemReader(str(path)),
                 process_group=self.process_group,
                 **_dcp_kw(dcp.load, self.process_group is None))
        meta = json.loads((path / _META).read_text())
        logical = int(meta.pop(_LOGICAL_KEY, step))

        def rebuild(node: Any, prefix: str) -> Any:
            if isinstance(node, dict):
                return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(rebuild(v, f"{prefix}/{i}" if prefix
                                          else str(i))
                                  for i, v in enumerate(node))
            got = target[prefix or "."]
            return got if isinstance(node, torch.Tensor) \
                else _like(node, got.numpy())

        return logical, rebuild(template, ""), meta

    def close(self) -> None:
        self.wait()
