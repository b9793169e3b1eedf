"""Step-time and throughput metrics (counterpart of
:mod:`tpudist.utils.metrics`): per-step wall clock with warm-up
exclusion, images/s, epoch means of device scalars, and an optional
``torch.profiler`` trace.

PyTorch returns from a CUDA call before the card has done the work, so a
host clock read without a synchronise measures the dispatch rate.
``block=True`` (:class:`Stopwatch`, :meth:`ThroughputMeter.step`) waits
for the card first.  As in tpudist, :class:`ThroughputMeter` also
reports into the process-global obs registry (the
``throughput/items_per_sec`` and ``throughput/steps`` gauges); its
readings stay plain attributes too (``items_per_sec``,
``mean_step_time``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
import torch.distributed as dist

from tpudist_torch import obs


def sync_device() -> None:
    """Wait for the card's outstanding work (nothing to wait for when
    this process has not started CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Stopwatch:
    """Wall-clock timer; ``block=True`` waits for the card's outstanding
    work first."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def reset(self, block: bool = False) -> None:
        if block:
            sync_device()
        self._t0 = time.perf_counter()

    def elapsed(self, block: bool = False) -> float:
        if block:
            sync_device()
        return time.perf_counter() - self._t0


class ThroughputMeter:
    """Images/s (or items/s) with warm-up steps excluded.  Each
    :meth:`step` reads the host clock; pass ``block=True`` at the end of
    a measured stretch (the trainer does at an epoch's last step) so the
    rate counts the card's work and not only its dispatch.

    Post-warmup steps also refresh the obs gauges
    ``throughput/items_per_sec`` and ``throughput/steps``."""

    def __init__(self, warmup_steps: int = 1) -> None:
        self.warmup_steps = warmup_steps
        self._steps = 0
        self._items = 0
        self._elapsed = 0.0
        self._last: float | None = None
        self._rate_gauge = None
        self._steps_gauge = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def step(self, n_items: int, block: bool = False) -> None:
        if block:
            sync_device()
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return
        self._steps += 1
        if self._steps > self.warmup_steps:
            self._items += n_items
            self._elapsed += now - self._last
            if self._rate_gauge is None:
                self._rate_gauge = obs.registry.gauge(
                    "throughput/items_per_sec", unit="items/s")
                self._steps_gauge = obs.registry.gauge(
                    "throughput/steps", unit="steps")
            self._rate_gauge.set(self.items_per_sec)
            self._steps_gauge.set(float(self._steps))
        self._last = now

    @property
    def items_per_sec(self) -> float:
        return self._items / self._elapsed if self._elapsed else 0.0

    @property
    def mean_step_time(self) -> float:
        counted = self._steps - self.warmup_steps
        return self._elapsed / counted if counted > 0 else 0.0


class MetricLogger:
    """Running means of scalar metrics, flushed per epoch.

    Values may be device tensors: they are kept as they come (no
    ``.item()`` per step, which would stall the host on every step of an
    eager CUDA loop) and copied to the host together in :meth:`means`,
    one copy (one sync) per device.  Entries may be scalars or stacked
    ``[n]``-step tensors (the fused train loop); every step weighs
    equally."""

    def __init__(self) -> None:
        self._values: dict[str, list] = defaultdict(list)

    def update(self, **metrics) -> None:
        for k, v in metrics.items():
            self._values[k].append(v)

    def means(self) -> dict[str, float]:
        entries = [(k, torch.as_tensor(v).detach().reshape(-1))
                   for k, vs in self._values.items() for v in vs]
        by_device: dict[torch.device, list[int]] = defaultdict(list)
        for i, (_, t) in enumerate(entries):
            by_device[t.device].append(i)
        host: list = [None] * len(entries)
        for idx in by_device.values():
            flat = torch.cat([entries[i][1].to(torch.float64)
                              for i in idx]).cpu()
            for i, part in zip(idx, flat.split(
                    [entries[i][1].numel() for i in idx])):
                host[i] = part
        out: dict[str, float] = {}
        for k in self._values:
            parts = [h for (key, _), h in zip(entries, host) if key == k]
            out[k] = float(torch.cat(parts).mean())
        return out

    def reset(self) -> dict[str, float]:
        out = self.means()
        self._values.clear()
        return out


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """``with maybe_profile("/tmp/trace"):`` records the region with
    ``torch.profiler`` (the host, and the card when CUDA is up) and
    writes a Chrome trace, ``trace_p<rank>.json``, into ``trace_dir``; a
    no-op when ``trace_dir`` is empty or None."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_p{rank}.json"))
