"""Crash flight recorder — the post-mortem that survives the process
(counterpart of :mod:`tpudist.obs.recorder`).

torch.distributed ships a "flight recorder" that dumps recent collective
state when a job wedges; the reference suite has nothing (a crash's
cause evaporates with the process).  :class:`FlightRecorder` is the
tpudist counterpart: a bounded per-process ring of recent events (step
metric deltas, elastic round changes, serve admissions, health
transitions, compile events) plus a one-call post-mortem dump that
bundles, as ONE JSON document:

* the last-N event ring (and how many older events the ring dropped);
* the exception (type, message, traceback text) when there is one;
* the final registry snapshot (every counter/gauge/histogram as of the
  crash — the one batched device sync is attempted but a dead backend
  must not block the dump, so it degrades to the host-only view);
* the span tail (the last ``span_tail`` completed spans from the
  tracer, crash-adjacent timeline context);
* the request-event tail (the last entries of the per-request tracing
  ring, :mod:`tpudist_torch.obs.events` — which requests this process was
  serving, and what lifecycle decisions it had just made);
* environment and topology: the ``TPUDIST_*``/``CUDA_*``/``NCCL_*``/
  ``TORCH_*`` env surface, pid/host, and the CUDA device and process
  group layout when either has been initialised;
* :attr:`last_hlo`, a text slot for the last compiled program (kept for
  the schema; the port's kernels are built ahead, so it stays ``None``
  unless a caller fills it).

``guard()`` is the wiring surface: the trainer, the elastic worker and
the serve loop wrap their run loops in ``with obs.recorder.guard(...)``
so any unhandled exception dumps the bundle before propagating.  Dump
location: ``TPUDIST_POSTMORTEM_DIR`` (default: the current directory).

Schema: ``{"schema": "tpudist.postmortem/1", ...}`` — see
docs/OBSERVABILITY.md for the field-by-field contract.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
import traceback
from collections import deque
from typing import Any

from tpudist_torch.obs.spans import atomic_write_json
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["FlightRecorder", "POSTMORTEM_SCHEMA"]

POSTMORTEM_SCHEMA = "tpudist.postmortem/1"

# the env surface worth preserving in a post-mortem: selection by prefix
# keeps secrets (tokens, credentials) out of the bundle by default
_ENV_PREFIXES = ("TPUDIST_", "CUDA_", "NCCL_", "TORCH_")


def _topology() -> dict:
    """CUDA device and process-group layout, degrading to {} when
    neither CUDA nor ``torch.distributed`` has been initialised (a
    post-crash dump must never initialise CUDA)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    out: dict = {}
    try:
        if torch.cuda.is_initialized():
            out["device_count"] = torch.cuda.device_count()
            out["device_kind"] = torch.cuda.get_device_name(
                torch.cuda.current_device())
            out["backend"] = "cuda"
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            out["process_index"] = dist.get_rank()
            out["process_count"] = dist.get_world_size()
            out["dist_backend"] = str(dist.get_backend())
    except Exception:  # noqa: BLE001 - topology is best-effort context
        return {}
    return out


class FlightRecorder:
    """Bounded ring of recent events + post-mortem bundling.

    ``capacity`` bounds the ring; overflow evicts the OLDEST event (the
    crash-adjacent tail is the valuable part) and counts into
    :attr:`dropped`.  Recording is a lock-guarded host-only append —
    never a device sync — so it is safe on hot paths at coarse
    granularity (per log-interval, per round, per admission; not per
    step)."""

    def __init__(self, capacity: int = 512, directory: str | None = None,
                 registry: Any = None, tracer: Any = None,
                 request_events: Any = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.directory = directory
        self.dropped = 0
        self.last_hlo: str | None = None
        self.last_dump_path: str | None = None
        self._registry = registry
        self._tracer = tracer
        # the per-request tracing ring (tpudist_torch.obs.events): its tail
        # joins the bundle so a crash dump carries the fleet's recent
        # request-lifecycle decisions next to the metric/span state
        self._request_events = request_events
        self._events: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one event: ``{"t": now, "kind": kind, **fields}``.
        Fields must be JSON-ready (host ints/floats/strings)."""
        event = {"t": time.time(), "kind": kind, **fields}
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(event)

    def note_hlo(self, text: str | None) -> None:
        """Stash the most recently compiled program's HLO text (called at
        compile sites; cheap — the text was already rendered)."""
        if text:
            self.last_hlo = text

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- post-mortem -------------------------------------------------------

    def bundle(self, exc: BaseException | None = None,
               context: dict | None = None, span_tail: int = 50) -> dict:
        """Assemble the post-mortem document (no file I/O)."""
        snapshot = None
        if self._registry is not None:
            try:
                snapshot = self._registry.snapshot()
            except Exception as e:  # noqa: BLE001 - dead backend
                # fall back to the host-only view: fold nothing, just
                # read what already folded (a crash dump must not block
                # on a device sync against a torn-down backend)
                try:
                    snapshot = {
                        "degraded": str(e)[:200],
                        "counters": {n: m._snap() for n, m in
                                     self._registry.metrics().items()
                                     if type(m).__name__ == "Counter"},
                    }
                except Exception:  # noqa: BLE001
                    snapshot = {"degraded": str(e)[:200]}
        spans = None
        if self._tracer is not None:
            try:
                spans = self._tracer.events()[-span_tail:]
            except Exception:  # noqa: BLE001
                spans = None
        request_events = request_events_dropped = None
        if self._request_events is not None:
            try:
                request_events = self._request_events.tail(span_tail * 4)
                request_events_dropped = self._request_events.dropped
            except Exception:  # noqa: BLE001
                request_events = None
        exc_doc = None
        if exc is not None:
            exc_doc = {
                "type": type(exc).__name__,
                "message": str(exc)[:2000],
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))[-8000:],
            }
        return {
            "schema": POSTMORTEM_SCHEMA,
            "time": time.time(),
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "context": context or {},
            "exception": exc_doc,
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(_ENV_PREFIXES)},
            "topology": _topology(),
            "events": self.events(),
            "events_dropped": self.dropped,
            "snapshot": snapshot,
            "spans": spans,
            "request_events": request_events,
            "request_events_dropped": request_events_dropped,
            "last_hlo": self.last_hlo,
        }

    def dump(self, exc: BaseException | None = None, path: str | None = None,
             context: dict | None = None, span_tail: int = 50) -> str:
        """Write the post-mortem bundle and return its path.

        Default location: ``TPUDIST_POSTMORTEM_DIR`` > the recorder's
        ``directory`` > the current directory; the filename carries pid +
        timestamp so concurrent workers never clobber each other."""
        doc = self.bundle(exc=exc, context=context, span_tail=span_tail)
        if path is None:
            directory = (os.environ.get("TPUDIST_POSTMORTEM_DIR")
                         or self.directory or ".")
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory,
                f"postmortem-{os.getpid()}-{int(doc['time'] * 1000)}.json")
        atomic_write_json(path, doc, indent=1)
        self.last_dump_path = path
        return path

    @contextlib.contextmanager
    def guard(self, component: str, **context):
        """Dump a post-mortem on any unhandled exception, then re-raise.

        The wiring surface for run loops::

            with obs.recorder.guard("trainer", epochs=cfg.total_epochs):
                ...

        Never masks the original exception: a failing dump is logged and
        swallowed; the exception always propagates unchanged."""
        try:
            yield self
        except BaseException as e:  # noqa: BLE001 - re-raised below
            # KeyboardInterrupt/SystemExit also deserve a bundle (a
            # supervisor SIGTERM mid-hang is exactly the wedged case)
            try:
                path = self.dump(
                    exc=e, context={"component": component, **context})
                log.error("%s crashed (%s: %s); post-mortem bundle: %s",
                          component, type(e).__name__, str(e)[:200], path)
            except Exception as dump_err:  # noqa: BLE001 - never mask
                log.warning("post-mortem dump failed: %s", dump_err)
            raise
