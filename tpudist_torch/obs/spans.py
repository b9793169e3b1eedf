"""Span tracer — Chrome-trace-format timelines for host-side phases
(counterpart of :mod:`tpudist.obs.spans`).

``with tracer.span("train_step"): ...`` records a complete event per exit
into an in-memory buffer; :meth:`SpanTracer.dump` / :meth:`write` render
the catapult JSON that chrome://tracing and Perfetto load directly:

    {"traceEvents": [{"name", "ph": "X", "ts", "dur", "pid", "tid",
                      "args"}, ...], "displayTimeUnit": "ms"}

with ``ts``/``dur`` in microseconds.  Nesting falls out of the format —
the viewer stacks events on the same tid by containment, and we record a
``depth`` arg from a per-thread stack for programmatic consumers.

Two accelerator-facing hooks:

* ``fence=True`` (or ``TPUDIST_OBS_FENCE=1``) calls
  ``torch.cuda.synchronize()`` on span exit once CUDA is initialised, so
  asynchronously launched kernels are attributed to the span that
  launched them instead of whichever span happens to be open when the
  stream drains.  Off by default: fencing serializes dispatch and is a
  measurement tool, not a production default.
* every span is also wrapped in ``torch.profiler.record_function``, so
  spans appear as named regions inside a ``torch.profiler`` trace.

A fence never initialises CUDA: in a process that has not touched the
card it is a no-op.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time

from tpudist_torch.utils.config import env_flag

__all__ = ["SpanTracer", "atomic_write_json"]


def atomic_write_json(path: str | os.PathLike, doc,
                      indent: int | None = None) -> str:
    """Write ``doc`` as JSON via temp file + atomic rename, so a crash
    mid-dump (the exact moment traces and post-mortems get written)
    can never leave a truncated/unparseable file at ``path``."""
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(
        prefix=".tmp-" + os.path.basename(path) + "-",
        dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=indent)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _trace_annotation(name: str):
    try:
        import torch.profiler

        return torch.profiler.record_function(name)
    except Exception:
        return contextlib.nullcontext()


def _effects_barrier() -> None:
    try:
        import torch

        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    except Exception:
        pass


class SpanTracer:
    """Per-process span recorder.

    ``max_events`` bounds the buffer as a RING (long serving jobs would
    otherwise grow without limit): overflow evicts the OLDEST span and
    increments :attr:`dropped`, keeping the newest spans — the tail a
    post-mortem (:mod:`tpudist_torch.obs.recorder`) actually wants.
    Thread-safe: each thread keeps its own nesting stack, the event
    buffer is lock-guarded.
    """

    def __init__(self, max_events: int = 100_000,
                 fence: bool | None = None) -> None:
        self.max_events = max_events
        # None -> env-controlled so tests/benches can fence without code
        self.fence = env_flag("TPUDIST_OBS_FENCE") if fence is None else fence
        self.dropped = 0
        self._events: collections.deque[dict] = collections.deque(
            maxlen=max_events)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pid = os.getpid()

    def _depth(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a complete ("ph": "X") event for the enclosed block.
        ``args`` must be JSON-serializable; they land in the event's
        ``args`` field next to the nesting ``depth``."""
        stack = self._depth()
        stack.append(name)
        start = time.perf_counter()
        try:
            with _trace_annotation(name):
                yield self
        finally:
            if self.fence:
                _effects_barrier()
            dur_us = (time.perf_counter() - start) * 1e6
            depth = len(stack) - 1
            stack.pop()
            event = {
                "name": name,
                "ph": "X",
                # perf_counter origin is arbitrary but shared across the
                # process, which is all the viewer needs
                "ts": start * 1e6,
                "dur": dur_us,
                "pid": self._pid,
                "tid": threading.get_ident(),
                "args": {"depth": depth, **args},
            }
            with self._lock:
                if len(self._events) == self.max_events:
                    self.dropped += 1  # deque maxlen evicts the oldest
                self._events.append(event)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def dump(self) -> dict:
        """The Chrome-trace JSON document (catapult "JSON object format")."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        return atomic_write_json(path, self.dump())

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
