"""Device-input pipelining: batches copied to the card ahead of the step
(counterpart of :mod:`tpudist.data.device_prefetch`).

A worker thread pulls ``depth`` items of the source ahead of the
consumer.  With a CUDA ``device``, the worker copies each item's host
arrays into pinned host tensors and issues ``non_blocking`` host-to-device
copies on a side stream, then records an event; the consumer makes its
current stream wait on that event and calls ``record_stream`` on each
tensor before handing it out.  Both matter: without the wait the step
could read a batch whose copy is still in flight, and without
``record_stream`` the caching allocator, which allotted the batch's
memory on the side stream, could hand it to the next copy once the
consumer drops it, while the consumer's kernels still read it.  The
pinned staging buffers are safe the same way: the copy records its
stream's use of them, so the host allocator does not reuse one before the
copy is done.

On the CPU (``device="cpu"``) each array becomes a tensor that shares its
memory, and the worker simply runs ahead.  ``device=None`` hands items
over as they come.  ``depth=0`` pulls synchronously on the consumer's
thread (the same copies, no thread).

The contract is tpudist's: items in order; an exception raised by the
source reaches the consumer at the matching ``next``; abandoning the
iterator (``break``, an exception, :meth:`DevicePrefetch.close`) stops
the worker and closes the source, so a loader's in-flight gather jobs are
reaped.  ``stall_s`` is the consumer's cumulative wait for input; the
same waits tick tpudist's ``data/input_stall`` counter and
``data/input_stall_s`` histogram, and ``data/prefetch_depth`` gauges the
depth.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from tpudist_torch import obs
from tpudist_torch.utils.trees import tree_map

__all__ = ["DevicePrefetch", "device_prefetch"]

_ITEM, _ERR, _END = 0, 1, 2


def _tensor_leaves(item: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor)
             else None, item)
    return out


class DevicePrefetch:
    """Iterator that lands ``depth`` items of ``iterable`` on ``device``
    ahead of the consumer, on a background thread.

    Args:
      iterable: source of items (tuples, lists or dicts of numpy arrays
        or tensors, or single arrays).
      depth: items to keep ready (0: synchronous, no thread).
      put: optional transform applied to every item on the worker thread,
        before the copy.
      device: where the items' arrays land (see the module docstring);
        None leaves them as they are.
    """

    def __init__(self, iterable: Iterable, depth: int = 2,
                 put: Callable[[Any], Any] | None = None,
                 device: str | torch.device | None = None) -> None:
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self.depth = depth
        self.device = None if device is None else torch.device(device)
        self.stall_s = 0.0
        self._stall = obs.counter("data/input_stall", unit="s")
        self._stall_hist = obs.histogram("data/input_stall_s", unit="s")
        obs.gauge("data/prefetch_depth").set(depth)
        self._it = iter(iterable)
        self._put = put
        self._done = False
        self._stream = None
        if self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        self._thread: threading.Thread | None = None
        if depth > 0:
            self._stop = threading.Event()
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(
                target=self._worker, name="tpudist-torch-device-prefetch",
                daemon=True)
            self._thread.start()

    # -- the copy ------------------------------------------------------------

    def _land(self, item: Any) -> tuple[Any, Any]:
        """``(item on the device, the copies' event or None)``."""
        if self._put is not None:
            item = self._put(item)
        if self.device is None:
            return item, None

        def as_tensor(x):
            return torch.from_numpy(x) if isinstance(x, np.ndarray) else x

        if self._stream is None:
            return tree_map(lambda x: as_tensor(x).to(self.device)
                            if isinstance(x, (np.ndarray, torch.Tensor))
                            else x, item), None
        with torch.cuda.stream(self._stream):
            def copy(x):
                if not isinstance(x, (np.ndarray, torch.Tensor)):
                    return x
                x = as_tensor(x)
                if x.device.type == "cuda":
                    return x
                return x.pin_memory().to(self.device, non_blocking=True)

            landed = tree_map(copy, item)
            event = torch.cuda.Event()
            event.record(self._stream)
        return landed, event

    def _hand_over(self, landed: Any, event: Any) -> Any:
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in _tensor_leaves(landed):
                if t.device.type == "cuda":
                    t.record_stream(cur)
        return landed

    # -- worker side -----------------------------------------------------------

    def _push(self, msg: tuple) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self) -> None:
        try:
            for item in self._it:
                if self._stop.is_set():
                    break
                self._push((_ITEM, self._land(item)))
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            self._push((_ERR, e))
        finally:
            # close the source in the thread that iterated it, so an
            # abandoned loader epoch reaps its in-flight gather jobs
            close = getattr(self._it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
            self._push((_END, None))

    # -- consumer side ---------------------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._thread is None:  # depth == 0: synchronous
            return self._hand_over(*self._land(next(self._it)))
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        kind, val = self._q.get()
        stall = time.perf_counter() - t0
        self.stall_s += stall
        self._stall.inc(stall)
        self._stall_hist.record(stall)
        if kind == _END:
            self._done = True
            self._thread.join()
            raise StopIteration
        if kind == _ERR:
            self._done = True
            self._thread.join()
            raise val
        return self._hand_over(*val)

    def close(self) -> None:
        """Stop the worker and release the source (idempotent)."""
        if self._thread is None or self._done:
            self._done = True
            if self._thread is None:
                close = getattr(self._it, "close", None)
                if close is not None:
                    close()
            return
        self._done = True
        self._stop.set()
        # unblock a worker stuck on a full queue, then reap it
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.1)
        self._thread.join()

    def __del__(self) -> None:  # best-effort; device_prefetch() is preferred
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def device_prefetch(iterable: Iterable, depth: int = 2,
                    put: Callable[[Any], Any] | None = None,
                    device: str | torch.device | None = None) -> Iterator:
    """Generator around :class:`DevicePrefetch` whose ``finally`` stops
    the worker when the consumer stops early."""
    pf = DevicePrefetch(iterable, depth=depth, put=put, device=device)
    try:
        yield from pf
    finally:
        pf.close()
