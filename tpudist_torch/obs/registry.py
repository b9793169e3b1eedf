"""Process-local metric registry: counters, gauges, log-bucketed histograms
(counterpart of :mod:`tpudist.obs.registry`; the snapshot dict is its
snapshot key for key).

The reference suite's only perf signal is an end-to-end ``time.time()``
delta (`mnist_ddp_elastic.py:210-213`, `model_parallel_ResNet50.py:258-262`);
production accelerator stacks treat per-step latency histograms and per-host
counters as core infrastructure (Horovod's timeline, torch.distributed's
flight recorder).  This module is the recording half of that layer:

* :class:`Counter` — monotonically increasing sum (steps, tokens, bytes).
* :class:`Gauge` — last-written value (queue depth, world size, loss).
* :class:`Histogram` — log-bucketed distribution with p50/p90/p99
  summaries, mergeable across hosts bucket-by-bucket
  (:mod:`tpudist_torch.obs.aggregate`).

The load-bearing property is LAZY accumulation, the same contract as
:class:`tpudist_torch.utils.metrics.MetricLogger`: recorded values may be
device tensors and are appended un-synced, so recording on the step hot
path never blocks the CUDA stream (no ``float()`` / ``.item()`` per
record).  The one
batched host sync happens at :meth:`MetricRegistry.snapshot`, which folds
every metric's pending CUDA values in a single stacked ``.cpu()`` — and
never touches torch when only plain Python numbers were recorded.

Snapshots are plain JSON-ready dicts (string bucket keys), the wire format
the aggregator publishes through the coordination store and the exporters
render to JSONL / Prometheus text.
"""

from __future__ import annotations

import math
import threading
import time

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "hist_quantile",
    "split_labels",
    "summarize",
    "validate_metric_name",
    "values_to_hist",
]

_QUANTILES = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))

# characters a label key/value may not contain: "~" would re-split on
# the wire, "=" in a value would mis-parse the pair, and quote/backslash
# /newline would need escaping in the Prometheus exposition format.
_LABEL_BANNED = ("~", "=", '"', "\\", "\n")


def split_labels(name: str) -> tuple[str, dict[str, str]]:
    """Split ``base~key=value~k2=v2`` into (base, labels).

    Lenient by design — this is the READ path used by exporters and the
    TSDB on names that may predate validation: a ``~`` part without
    ``=`` is folded back into the base name instead of being dropped.
    The WRITE path (:func:`validate_metric_name`, enforced by
    :class:`MetricRegistry`) rejects such names outright, so new
    metrics round-trip exactly."""
    if "~" not in name:
        return name, {}
    base, *parts = name.split("~")
    labels: dict[str, str] = {}
    for part in parts:
        key, sep, value = part.partition("=")
        if sep and key:
            labels[key] = value
        else:
            base = f"{base}~{part}"     # not a k=v tag; keep it literal
    return base, labels


def validate_metric_name(name: str) -> None:
    """Reject metric names whose ``~key=value`` suffixes would not
    round-trip through the snapshot wire format and the Prometheus
    exporter: every ``~`` part must be ``key=value``, keys must be
    identifier-ish, and values may not contain ``~ = " \\`` or
    newlines (a value like ``a=b`` or ``x~y`` would silently mis-split
    on read — reject at registration instead)."""
    if not name:
        raise ValueError("metric name must be non-empty")
    if "~" not in name:
        return
    base, *parts = name.split("~")
    if not base:
        raise ValueError(f"metric {name!r}: empty base name before '~'")
    for part in parts:
        key, sep, value = part.partition("=")
        if not sep or not key:
            raise ValueError(
                f"metric {name!r}: label part {part!r} is not key=value "
                f"(a '~' in a metric name starts a label tag)")
        if not key.replace("_", "").isalnum():
            raise ValueError(
                f"metric {name!r}: label key {key!r} must be "
                f"alphanumeric/underscore")
        bad = [c for c in _LABEL_BANNED if c in value]
        if bad:
            raise ValueError(
                f"metric {name!r}: label value {value!r} contains "
                f"{bad!r} which cannot round-trip the wire format "
                f"(escape or drop these characters at the call site)")


def _is_plain(v) -> bool:
    return isinstance(v, (int, float))


def _sync_pending(pending: dict[str, list]) -> dict[str, list]:
    """ONE device->host transfer for every metric's pending list (the
    MetricLogger discipline): all pending CUDA tensors are flattened to
    f64, concatenated and copied with one ``.cpu()``, then split back;
    CPU tensors become numpy arrays; pure-host recordings skip torch."""
    if all(_is_plain(v) for vs in pending.values() for v in vs):
        return pending
    import torch

    out = {name: list(vs) for name, vs in pending.items()}
    on_card = [(name, i, v) for name, vs in out.items()
               for i, v in enumerate(vs)
               if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
    if on_card:
        flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                          for _, _, v in on_card]).cpu()
        sizes = [v.numel() for _, _, v in on_card]
        for (name, i, v), part in zip(on_card, torch.split(flat, sizes)):
            out[name][i] = part.reshape(v.shape).numpy()
    for vs in out.values():
        for i, v in enumerate(vs):
            if isinstance(v, torch.Tensor):
                vs[i] = v.detach().to(torch.float64).numpy()
    return out


class Counter:
    """Monotonic sum.  ``inc`` accepts CUDA scalars (or small tensors,
    summed elementwise at fold time) and never syncs."""

    def __init__(self, name: str, unit: str = "", help: str = "") -> None:  # noqa: A002
        self.name = name
        self.unit = unit
        self.help = help
        self._total = 0.0
        self._pending: list = []

    def inc(self, n=1) -> None:
        self._pending.append(n)

    def _take_pending(self) -> list:
        out, self._pending = self._pending, []
        return out

    def _fold(self, host_values: list) -> None:
        import numpy as np

        for v in host_values:
            self._total += float(np.sum(np.asarray(v, dtype=np.float64)))

    def value(self) -> float:
        """Current total (syncs this counter's own pending only)."""
        self._fold(_sync_pending({"v": self._take_pending()})["v"])
        return self._total

    def _snap(self) -> dict:
        snap = {"value": self._total, "unit": self.unit}
        if self.help:
            snap["help"] = self.help
        return snap


class Gauge:
    """Last-written value.  ``set`` keeps the raw (possibly device) value;
    a stacked tensor (a fused train loop's [n]-step metrics) folds to its
    last element."""

    def __init__(self, name: str, unit: str = "", help: str = "") -> None:  # noqa: A002
        self.name = name
        self.unit = unit
        self.help = help
        self._value: float | None = None
        self._pending: list = []

    def set(self, v) -> None:
        # keep only the latest raw value; older unsynced writes are dead
        self._pending = [v]

    def _take_pending(self) -> list:
        out, self._pending = self._pending, []
        return out

    def _fold(self, host_values: list) -> None:
        import numpy as np

        for v in host_values:
            flat = np.asarray(v, dtype=np.float64).reshape(-1)
            if flat.size:
                self._value = float(flat[-1])

    def value(self) -> float | None:
        self._fold(_sync_pending({"v": self._take_pending()})["v"])
        return self._value

    def clear(self) -> None:
        """Back to absent: the next snapshot reports ``value: null``
        (aggregation skips it, the TSDB records nothing).  Lets a
        conditional signal — e.g. an SLO burn rate with zero traffic in
        its window — read as "no data" instead of a literal 0.0."""
        self._pending = []
        self._value = None

    def _snap(self) -> dict:
        snap = {"value": self._value, "unit": self.unit}
        if self.help:
            snap["help"] = self.help
        return snap


class Histogram:
    """Log-bucketed distribution: value ``v > 0`` lands in bucket
    ``floor(log(v)/log(growth))`` whose lower bound is ``growth**index``
    (so recorded values that are exact powers of ``growth`` report EXACT
    quantiles); ``v <= 0`` lands in a dedicated zero bucket.  Buckets are
    a sparse ``{index: count}`` map, mergeable across hosts by summing
    counts (:func:`tpudist_torch.obs.aggregate.merge_snapshots`).

    ``record`` accepts scalars, arrays or tensors (host or CUDA) and never
    syncs; arrays count one observation per element (a fused train loop's
    stacked [n]-step metrics weigh every step).

    With ``window_s`` set the histogram is SLIDING-WINDOW: observations
    expire so control loops (SLO admission, the autoscaler) react to the
    last ``window_s`` seconds instead of the process lifetime — hours-old
    queue-wait samples can neither mask a fresh spike nor pin the fleet
    scaled-up after it passes.  Implementation is two rotating half-window
    generations: folds land in the newest, snapshots merge the live ones,
    and a generation older than the window is dropped wholesale — so a
    snapshot always covers between ``window_s/2`` and ``window_s`` of
    history with O(1) rotation cost and no per-observation timestamps.
    Expiry happens at fold/snapshot time (lazy, like accumulation)."""

    def __init__(self, name: str, unit: str = "", help: str = "",  # noqa: A002
                 growth: float = 2.0, window_s: float | None = None,
                 clock=time.monotonic) -> None:
        if growth <= 1.0:
            raise ValueError(f"histogram growth must be > 1, got {growth}")
        if window_s is not None and window_s <= 0:
            raise ValueError(f"histogram window_s must be > 0, got {window_s}")
        self.name = name
        self.unit = unit
        self.help = help
        self.growth = growth
        self.window_s = window_s
        self._clock = clock
        self._gens: list[dict] = [self._new_gen()]
        self._pending: list = []

    def _new_gen(self) -> dict:
        return {"start": self._clock(), "buckets": {}, "zero": 0,
                "count": 0, "sum": 0.0, "min": None, "max": None}

    def _rotate(self) -> None:
        if self.window_s is None:
            return
        now = self._clock()
        if now - self._gens[-1]["start"] >= self.window_s / 2.0:
            self._gens.append(self._new_gen())
            del self._gens[:-2]
        # after a long quiet gap even the previous generation has expired
        if len(self._gens) == 2 and \
                now - self._gens[0]["start"] >= self.window_s:
            del self._gens[0]

    def record(self, v) -> None:
        self._pending.append(v)

    def _take_pending(self) -> list:
        out, self._pending = self._pending, []
        return out

    def _fold(self, host_values: list) -> None:
        import numpy as np

        self._rotate()
        g = self._gens[-1]
        for v in host_values:
            flat = np.asarray(v, dtype=np.float64).reshape(-1)
            if not flat.size:
                continue
            g["count"] += int(flat.size)
            g["sum"] += float(flat.sum())
            lo, hi = float(flat.min()), float(flat.max())
            g["min"] = lo if g["min"] is None else min(g["min"], lo)
            g["max"] = hi if g["max"] is None else max(g["max"], hi)
            pos = flat[flat > 0]
            g["zero"] += int(flat.size - pos.size)
            if pos.size:
                # +1e-9 absorbs the float error of log-ratio at exact
                # bucket boundaries (log(8)/log(2) may be 2.999...96)
                idx = np.floor(
                    np.log(pos) / math.log(self.growth) + 1e-9).astype(int)
                for i, n in zip(*np.unique(idx, return_counts=True)):
                    g["buckets"][int(i)] = (
                        g["buckets"].get(int(i), 0) + int(n))

    def summary(self) -> dict:
        """p50/p90/p99 + count/sum/mean/min/max (syncs this histogram's
        own pending only)."""
        self._fold(_sync_pending({"v": self._take_pending()})["v"])
        return summarize(self._snap())

    def _snap(self) -> dict:
        self._rotate()
        buckets: dict[int, int] = {}
        zero = count = 0
        total = 0.0
        mn = mx = None
        for g in self._gens:
            count += g["count"]
            total += g["sum"]
            zero += g["zero"]
            if g["min"] is not None:
                mn = g["min"] if mn is None else min(mn, g["min"])
            if g["max"] is not None:
                mx = g["max"] if mx is None else max(mx, g["max"])
            for i, n in g["buckets"].items():
                buckets[i] = buckets.get(i, 0) + n
        snap = {
            "unit": self.unit,
            "growth": self.growth,
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "zero": zero,
            # string keys: the snapshot is the JSON wire format
            "buckets": {str(i): c for i, c in sorted(buckets.items())},
        }
        if self.window_s is not None:
            snap["window_s"] = self.window_s
        if self.help:
            snap["help"] = self.help
        return snap


def hist_quantile(hist: dict, q: float) -> float:
    """Nearest-rank quantile from a histogram SNAPSHOT dict: the lower
    bound of the bucket holding the ceil(q*count)-th smallest observation
    (0.0 for the zero bucket).  Exact when every recorded value sits on a
    bucket lower bound — e.g. powers of ``growth``."""
    count = hist["count"]
    if count == 0:
        return float("nan")
    k = max(1, math.ceil(q * count))
    cum = hist.get("zero", 0)
    if k <= cum:
        return 0.0
    for idx in sorted(int(i) for i in hist["buckets"]):
        cum += hist["buckets"][str(idx)]
        if k <= cum:
            return float(hist["growth"] ** idx)
    return float(hist["max"]) if hist["max"] is not None else float("nan")


def values_to_hist(values, *, growth: float = 2.0,
                   unit: str = "") -> dict:
    """A histogram SNAPSHOT dict built directly from host values — the
    same wire shape :class:`Histogram` produces, without a registry.
    The offline fleet simulator's fake replicas publish these so the
    REAL router/autoscaler percentile code reads simulated queue waits
    through the same format live ``MetricsPublisher`` snapshots use."""
    if growth <= 1.0:
        raise ValueError(f"histogram growth must be > 1, got {growth}")
    vals = [float(v) for v in values]
    buckets: dict[int, int] = {}
    zero = 0
    for v in vals:
        if v <= 0.0:
            zero += 1
        else:
            idx = int(math.floor(math.log(v) / math.log(growth) + 1e-9))
            buckets[idx] = buckets.get(idx, 0) + 1
    return {
        "unit": unit,
        "growth": growth,
        "count": len(vals),
        "sum": float(sum(vals)),
        "min": min(vals) if vals else None,
        "max": max(vals) if vals else None,
        "zero": zero,
        "buckets": {str(i): c for i, c in sorted(buckets.items())},
    }


def summarize(hist: dict) -> dict:
    """Quantile/mean summary of a histogram snapshot dict (works on both
    per-process and cross-host merged histograms)."""
    count = hist["count"]
    out = {
        "count": count,
        "sum": hist["sum"],
        "mean": hist["sum"] / count if count else float("nan"),
        "min": hist["min"],
        "max": hist["max"],
    }
    for name, q in _QUANTILES:
        out[name] = hist_quantile(hist, q)
    return out


class MetricRegistry:
    """Create-once, look-up-forever registry of named metrics.

    ``counter`` / ``gauge`` / ``histogram`` return the existing metric on
    repeat calls (so instrumentation sites can call them unconditionally);
    re-registering a name as a DIFFERENT kind raises.  :meth:`snapshot`
    folds every metric's pending device values in one batched sync and
    returns the JSON-ready wire dict."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                validate_metric_name(name)
                m = self._metrics[name] = cls(name, **kwargs)
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, unit: str = "", help: str = "") -> Counter:  # noqa: A002
        return self._get(name, Counter, unit=unit, help=help)

    def gauge(self, name: str, unit: str = "", help: str = "") -> Gauge:  # noqa: A002
        return self._get(name, Gauge, unit=unit, help=help)

    def histogram(self, name: str, unit: str = "", help: str = "",  # noqa: A002
                  growth: float = 2.0,
                  window_s: float | None = None) -> Histogram:
        return self._get(name, Histogram, unit=unit, help=help, growth=growth,
                         window_s=window_s)

    def metrics(self) -> dict:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> dict:
        """Fold all pending values (ONE batched device->host sync across
        every metric) and return the JSON-ready snapshot."""
        metrics = self.metrics()
        pending = {name: m._take_pending() for name, m in metrics.items()}
        host = _sync_pending(pending)
        snap: dict = {"time": time.time(), "counters": {}, "gauges": {},
                      "histograms": {}}
        for name, m in metrics.items():
            m._fold(host[name])
            kind = {Counter: "counters", Gauge: "gauges",
                    Histogram: "histograms"}[type(m)]
            snap[kind][name] = m._snap()
        return snap

    def clear(self) -> None:
        """Drop every metric (tests; a long-lived process keeps its
        registry for the life of the job)."""
        with self._lock:
            self._metrics.clear()
