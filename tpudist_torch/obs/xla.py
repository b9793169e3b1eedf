"""Kernel-build / memory / cost telemetry on CUDA (counterpart of
:mod:`tpudist.obs.xla`; the module and its ``xla/*`` metric names keep
tpudist's, but everything it reads is CUDA's).

Three signals feed the obs registry:

* **Build telemetry** — ``xla/compiles`` counter and
  ``xla/compile_seconds`` histogram.  The port has no jit: its
  "compiles" are the kernel-library builds, ``nvcc`` of each
  ``csrc/*.cu`` in :mod:`tpudist_torch.ops._cuda` and ``g++`` of each
  ``native/*.cpp`` in :mod:`tpudist_torch._native`.  Both report every
  build they run through :func:`note_compile` (``source="nvcc"`` or
  ``"g++"``); a library already built in ``_build/`` counts nothing.
  Every build also lands in the flight-recorder ring.
* **Memory telemetry** — per-device caching-allocator gauges
  (``xla/mem/bytes_in_use/d{i}``, ``.../peak_bytes_in_use/d{i}``,
  ``.../bytes_limit/d{i}``) from ``torch.cuda.memory_stats`` and
  ``torch.cuda.mem_get_info``; nothing without a card.
* **Cost/MFU telemetry** — :func:`cost_flops` counts one eager step's
  FLOPs under ``torch.utils.flop_counter.FlopCounterMode``, feeding the
  live ``xla/step_tflops`` and ``xla/mfu`` gauges against the card's
  dense bf16 peak (:data:`PEAK_TFLOPS`, keyed by
  ``torch.cuda.get_device_name``).

Everything degrades to a no-op without a card: the obs layer stays
importable everywhere.
"""

from __future__ import annotations

import time
from typing import Any, Callable

__all__ = [
    "PEAK_TFLOPS",
    "compile_watch",
    "cost_flops",
    "install_compile_telemetry",
    "mfu",
    "note_compile",
    "note_step",
    "peak_tflops",
    "update_memory_gauges",
]

# dense bf16 peak TFLOP/s per card, by torch.cuda.get_device_name (the
# figure PERF.md's bounds use for the H100 SXM)
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}

# (gauge key, torch.cuda.memory_stats key); bytes_limit comes from
# mem_get_info's total
_MEM_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
             ("peak_bytes_in_use", "allocated_bytes.all.peak"))


def _registry(registry: Any = None):
    if registry is not None:
        return registry
    from tpudist_torch import obs

    return obs.registry


def _device_name(device: Any) -> str | None:
    """The card's name for ``device`` (a ``torch.device``, an index, a
    device string or None = the current card); None for the CPU or
    without CUDA."""
    import torch

    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device                       # already a card name
    if not torch.cuda.is_available():
        return None
    if device is None:
        return torch.cuda.get_device_name(torch.cuda.current_device())
    if isinstance(device, int):
        return torch.cuda.get_device_name(device)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def peak_tflops(device: Any = None) -> float | None:
    """The card's dense bf16 peak TFLOP/s, or None on the CPU / for
    cards the table does not know."""
    try:
        name = _device_name(device)
    except Exception:  # noqa: BLE001 - no CUDA runtime
        return None
    return None if name is None else PEAK_TFLOPS.get(name)


def mfu(tflops: float | None, device: Any = None) -> float | None:
    """Achieved / peak, or None when either side is unknown."""
    peak = peak_tflops(device)
    if peak is None or tflops is None:
        return None
    return round(tflops / peak, 4)


# -- build telemetry ---------------------------------------------------------

def note_compile(seconds: float, registry: Any = None,
                 source: str = "nvcc") -> None:
    """Record one kernel-library build: count, duration histogram, and a
    flight-recorder event."""
    reg = _registry(registry)
    reg.counter("xla/compiles", unit="compiles").inc()
    reg.histogram("xla/compile_seconds", unit="s").record(float(seconds))
    try:
        from tpudist_torch import obs

        obs.recorder.record("xla_compile", seconds=round(float(seconds), 4),
                            source=source)
    except Exception:  # noqa: BLE001 - recorder is optional context
        pass


def install_compile_telemetry(registry: Any = None) -> bool:
    """tpudist's hook into ``jax.monitoring``.  The port's builds are
    few and explicit (``_cuda.build``, ``_native``'s ``g++``) and report
    themselves through :func:`note_compile`, so there is no listener to
    register: idempotent, always True."""
    return True


class compile_watch:
    """``with compile_watch("name"):`` — explicit timing of a build site
    under per-site names (``xla/compiles_{name}``,
    ``xla/compile_seconds_{name}``), so the ``xla/compiles`` totals never
    double-count a build that was also timed at its call site."""

    def __init__(self, name: str, registry: Any = None) -> None:
        self.name = name
        self._registry = _registry(registry)
        self.seconds = 0.0

    def __enter__(self) -> "compile_watch":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if exc[0] is None:
            reg = self._registry
            reg.counter(f"xla/compiles_{self.name}", unit="compiles").inc()
            reg.histogram(f"xla/compile_seconds_{self.name}",
                          unit="s").record(self.seconds)


# -- memory telemetry --------------------------------------------------------

def update_memory_gauges(registry: Any = None) -> dict[str, float]:
    """Refresh per-card allocator gauges; returns the values set (empty
    without a card).  Cards this process never allocated on are
    skipped, so no CUDA context is made for them.  Host-side calls —
    once per epoch/interval, not per step."""
    import torch

    if not torch.cuda.is_available():
        return {}
    reg = _registry(registry)
    out: dict[str, float] = {}
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:  # noqa: BLE001 - allocator not set up
            stats = None
        if not stats or not stats.get("allocated_bytes.all.peak"):
            continue
        vals = {key: float(stats[src]) for key, src in _MEM_KEYS
                if src in stats}
        try:
            vals["bytes_limit"] = float(torch.cuda.mem_get_info(i)[1])
        except Exception:  # noqa: BLE001 - a runtime without the query
            pass
        for key, v in vals.items():
            name = f"xla/mem/{key}/d{i}"
            reg.gauge(name, unit="bytes").set(v)
            out[name] = v
    return out


# -- cost / MFU telemetry ----------------------------------------------------

def cost_flops(step: Callable, *args, **kwargs) -> float | None:
    """FLOPs of one eager call ``step(*args, **kwargs)`` (forward and
    backward alike), counted by ``FlopCounterMode``; None when it counts
    nothing.  The call RUNS: pass the step the caller meant to take.

    The counter sees aten's matmuls and convolutions only.  A kernel
    launched through ctypes (K1-K10) is invisible to it, so a model
    that runs one is under-counted; the Trainer's MLP and ConvNet run
    none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        step(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops and flops > 0 else None


def note_step(seconds: float, flops: float | None,
              registry: Any = None) -> float | None:
    """Feed one measured step (wall seconds + step FLOPs) into the live
    gauges: ``xla/step_tflops`` always, ``xla/mfu`` when the card's peak
    is known.  Returns the achieved TFLOP/s."""
    if not flops or seconds <= 0:
        return None
    reg = _registry(registry)
    tflops = flops / seconds / 1e12
    reg.gauge("xla/step_tflops", unit="TFLOP/s").set(tflops)
    frac = mfu(tflops)
    if frac is not None:
        reg.gauge("xla/mfu").set(frac)
    return tflops
