"""Health plane — rank classification from the snapshots already flowing
(counterpart of :mod:`tpudist.obs.health`).

The reference suite's entire failure-detection story is "a process dies
and torchrun/Horovod restarts it"; tpudist's TTL heartbeats
(:class:`tpudist_torch.runtime.coord.ElasticMonitor`) already see *death*, but
nothing sees the failures that matter most on multi-card jobs: a straggling
host dragging every synchronous collective, or a rank whose publisher
went quiet while its heartbeat thread stays alive (main thread wedged).

:class:`HealthMonitor` is the rank-0 (or sidecar) consumer of the
per-rank snapshots :class:`~tpudist_torch.obs.aggregate.MetricsPublisher`
already publishes through the coord KV store.  Per observation round it

* derives each rank's recent mean step time from the DELTA of its
  ``train/step_time`` histogram (sum/count since the previous snapshot —
  the live signal, not the job-lifetime average);
* computes cross-host skew as ``rank_mean / median(rank_means)``;
* reads publish staleness from the ``published_at`` stamp
  (:func:`tpudist_torch.obs.aggregate.collect` attaches ``age_s``);
* classifies every rank ``healthy | straggler | stale | lost`` with
  HYSTERESIS — ``confirm_n`` consecutive over-threshold rounds to enter
  ``straggler``, ``recover_n`` consecutive clean rounds to leave — so
  one GC pause or one fast round never flaps the verdict;
* emits the classification as obs gauges/counters (``health/ranks_*``,
  ``health/transitions``) and records every transition into the flight
  recorder ring (:mod:`tpudist_torch.obs.recorder`).

The machine-readable verdict (:meth:`HealthMonitor.verdict`) is what
``/healthz`` (:class:`tpudist_torch.obs.export.MetricsServer`) serves as a
liveness probe and what the elastic launcher
(:mod:`tpudist_torch.runtime.launch`) logs next to its blacklist decisions.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from tpudist_torch.obs.aggregate import DEFAULT_NAMESPACE, collect
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["HealthMonitor", "HealthWatcher", "STATES"]

# state encoding for the per-rank gauge (machine-readable ordering:
# higher is worse)
STATES = ("healthy", "straggler", "stale", "lost")
_STATE_CODE = {s: i for i, s in enumerate(STATES)}


def _median(values: list[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    return (ordered[mid] if n % 2
            else (ordered[mid - 1] + ordered[mid]) / 2.0)


class _RankTrack:
    """Per-rank bookkeeping: last histogram cumulatives + hysteresis
    streaks."""

    __slots__ = ("state", "prev_count", "prev_sum", "bad_streak",
                 "good_streak", "skew", "step_time", "age_s")

    def __init__(self) -> None:
        self.state = "healthy"
        self.prev_count = 0.0
        self.prev_sum = 0.0
        self.bad_streak = 0
        self.good_streak = 0
        self.skew: float | None = None
        self.step_time: float | None = None
        self.age_s: float | None = None


class HealthMonitor:
    """Classify ranks from published snapshots.

    Args:
      client: optional :class:`~tpudist_torch.runtime.coord.CoordClient`; when
        given, :meth:`update` collects the published snapshots itself.
        :meth:`observe` works without any client (tests, replay).
      namespace: the publisher namespace in the KV store.
      signal: histogram name carrying the per-step latency signal.
      skew_threshold: a rank whose recent mean step time exceeds
        ``skew_threshold × median`` is a straggler candidate.
      stale_after_s / lost_after_s: publish-age bounds for the
        ``stale`` / ``lost`` states (``lost`` also covers a rank whose
        key vanished from the store).
      confirm_n / recover_n: hysteresis — consecutive candidate rounds
        required to ENTER ``straggler``, consecutive clean rounds to
        LEAVE a non-healthy state.
      registry: obs registry the classification gauges/counters are
        emitted into (default: the process-global one).
      recorder: flight recorder that receives transition events
        (default: the process-global one).
    """

    def __init__(
        self,
        client: Any = None,
        namespace: str = DEFAULT_NAMESPACE,
        signal: str = "train/step_time",
        skew_threshold: float = 2.0,
        stale_after_s: float = 15.0,
        lost_after_s: float = 60.0,
        confirm_n: int = 2,
        recover_n: int = 2,
        registry: Any = None,
        recorder: Any = None,
    ) -> None:
        if skew_threshold <= 1.0:
            raise ValueError(
                f"skew_threshold must be > 1, got {skew_threshold}")
        if confirm_n < 1 or recover_n < 1:
            raise ValueError("confirm_n and recover_n must be >= 1")
        self.client = client
        self.namespace = namespace
        self.signal = signal
        self.skew_threshold = skew_threshold
        self.stale_after_s = stale_after_s
        self.lost_after_s = lost_after_s
        self.confirm_n = confirm_n
        self.recover_n = recover_n
        if registry is None:
            from tpudist_torch import obs

            registry = obs.registry
        self._registry = registry
        if recorder is None:
            from tpudist_torch import obs

            recorder = obs.recorder
        self._recorder = recorder
        self._tracks: dict[int, _RankTrack] = {}
        self._verdict: dict = {"status": "unknown", "time": None,
                               "rounds": 0, "ranks": {}}
        self._lock = threading.Lock()

    # -- observation -------------------------------------------------------

    def update(self) -> dict:
        """Collect the currently published snapshots and classify.  The
        rank-0 / sidecar entry point; needs ``client``."""
        if self.client is None:
            raise ValueError("HealthMonitor.update() needs a coord client; "
                             "use observe(snapshots) without one")
        return self.observe(collect(self.client, self.namespace))

    def observe(self, snapshots: dict[int, dict],
                now: float | None = None) -> dict:
        """One classification round over ``{rank: snapshot}`` (the
        :func:`~tpudist_torch.obs.aggregate.collect` shape).  Returns the new
        verdict."""
        now = time.time() if now is None else now
        with self._lock:
            return self._observe_locked(snapshots, now)

    def _observe_locked(self, snapshots: dict[int, dict],
                        now: float) -> dict:
        # recent per-rank mean step time from histogram deltas
        deltas: dict[int, float | None] = {}
        for rank, snap in snapshots.items():
            track = self._tracks.setdefault(rank, _RankTrack())
            published = snap.get("published_at", snap.get("time"))
            track.age_s = (snap["age_s"] if snap.get("age_s") is not None
                           else (now - published
                                 if published is not None else None))
            hist = snap.get("histograms", {}).get(self.signal)
            if hist is None:
                deltas[rank] = None
                continue
            dc = hist["count"] - track.prev_count
            ds = hist["sum"] - track.prev_sum
            if dc < 0:  # restarted rank: its registry began again at zero
                dc, ds = hist["count"], hist["sum"]
            track.prev_count, track.prev_sum = hist["count"], hist["sum"]
            deltas[rank] = (ds / dc) if dc > 0 else None
        known = [d for d in deltas.values() if d is not None and d > 0]
        median = _median(known) if known else None

        transitions: list[dict] = []
        candidates: dict[int, str] = {}
        for rank, track in self._tracks.items():
            snap_present = rank in snapshots
            if snap_present:
                track.step_time = deltas.get(rank)
                track.skew = (track.step_time / median
                              if track.step_time is not None
                              and median else None)
            age = track.age_s
            # staleness dominates skew: a rank that stopped publishing has
            # no fresh step-time signal to judge
            if (not snap_present
                    or (age is not None and age > self.lost_after_s)):
                candidate = "lost"
            elif age is not None and age > self.stale_after_s:
                candidate = "stale"
            elif (track.skew is not None
                    and track.skew >= self.skew_threshold):
                candidate = "straggler"
            else:
                candidate = "healthy"
            candidates[rank] = candidate
        # stale-not-lost, fleet-wide: when EVERY tracked rank went bad
        # in the same round, the common cause is the path to the obs
        # plane (a coord brownout), not a simultaneous mass death —
        # demote "lost" to "stale" so consumers steer around the blind
        # spot without triggering a redispatch storm.  One genuinely
        # dead rank among healthy peers is unaffected.
        if (len(candidates) >= 2
                and all(c in ("stale", "lost")
                        for c in candidates.values())):
            candidates = {rank: ("stale" if c == "lost" else c)
                          for rank, c in candidates.items()}
        for rank, candidate in candidates.items():
            self._apply_hysteresis(rank, self._tracks[rank], candidate,
                                   transitions)

        verdict = self._render_verdict(now, transitions)
        self._emit(verdict, transitions)
        self._verdict = verdict
        return verdict

    def _apply_hysteresis(self, rank: int, track: _RankTrack,
                          candidate: str,
                          transitions: list[dict]) -> None:
        """``confirm_n`` consecutive bad rounds to degrade, ``recover_n``
        consecutive clean rounds to return to healthy.  Worsening within
        the degraded states (straggler -> stale -> lost) switches
        immediately — staleness is measured, not inferred."""
        if candidate == "healthy":
            track.bad_streak = 0
            if track.state != "healthy":
                track.good_streak += 1
                if track.good_streak >= self.recover_n:
                    transitions.append(
                        {"rank": rank, "from": track.state, "to": "healthy"})
                    track.state = "healthy"
                    track.good_streak = 0
            return
        track.good_streak = 0
        if candidate == track.state:
            return
        if _STATE_CODE[candidate] > _STATE_CODE.get(track.state, 0) \
                and candidate in ("stale", "lost"):
            # measured staleness: no confirmation rounds needed
            transitions.append(
                {"rank": rank, "from": track.state, "to": candidate})
            track.state = candidate
            track.bad_streak = 0
            return
        track.bad_streak += 1
        if track.bad_streak >= self.confirm_n:
            transitions.append(
                {"rank": rank, "from": track.state, "to": candidate})
            track.state = candidate
            track.bad_streak = 0

    # -- verdict + emission ------------------------------------------------

    def _render_verdict(self, now: float,
                        transitions: list[dict]) -> dict:
        ranks = {
            str(rank): {
                "state": t.state,
                "skew": (round(t.skew, 3)
                         if t.skew is not None else None),
                "step_time": t.step_time,
                "age_s": (round(t.age_s, 3)
                          if t.age_s is not None else None),
            }
            for rank, t in sorted(self._tracks.items())
        }
        degraded = sorted(r for r, v in ranks.items()
                          if v["state"] != "healthy")
        return {
            "status": ("degraded" if degraded
                       else ("healthy" if ranks else "unknown")),
            "time": now,
            "rounds": self._verdict["rounds"] + 1,
            "ranks": ranks,
            "stragglers": [r for r, v in ranks.items()
                           if v["state"] == "straggler"],
            "stale": [r for r, v in ranks.items()
                      if v["state"] == "stale"],
            "lost": [r for r, v in ranks.items()
                     if v["state"] == "lost"],
            "transitions": transitions,
        }

    def _emit(self, verdict: dict, transitions: list[dict]) -> None:
        reg = self._registry
        counts = {s: 0 for s in STATES}
        for v in verdict["ranks"].values():
            counts[v["state"]] += 1
        for s in STATES:
            reg.gauge(f"health/ranks_{s}", unit="ranks").set(counts[s])
        reg.gauge("health/degraded").set(
            1 if verdict["status"] == "degraded" else 0)
        if transitions:
            reg.counter("health/transitions").inc(len(transitions))
        for tr in transitions:
            log.warning("health: rank %s %s -> %s", tr["rank"],
                        tr["from"], tr["to"])
            if self._recorder is not None:
                self._recorder.record("health_transition", **tr)

    def verdict(self) -> dict:
        """The most recent verdict (machine-readable; the `/healthz`
        payload)."""
        with self._lock:
            return dict(self._verdict)

    def describe(self) -> str:
        """One-line human summary for launcher/supervisor logs."""
        v = self.verdict()
        if v["status"] == "unknown":
            return "health: no observations yet"
        if v["status"] == "healthy":
            return f"health: {len(v['ranks'])} ranks healthy"
        parts = [f"{k}={v[k]}" for k in ("stragglers", "stale", "lost")
                 if v.get(k)]
        return f"health: degraded ({', '.join(parts)})"


class HealthWatcher:
    """Background health observer — the launcher/sidecar subscription.

    Owns its own :class:`~tpudist_torch.runtime.coord.CoordClient` (coord
    sockets are not shared across threads) and drives
    ``monitor.update()`` every ``interval_s`` on a daemon thread.
    Observation failures are swallowed: health is advisory and must
    never take the supervisor down."""

    def __init__(self, addr: str, interval_s: float = 2.0,
                 **monitor_kwargs) -> None:
        from tpudist_torch.runtime.coord import CoordClient

        host, port = addr.rsplit(":", 1)
        self._client = CoordClient(host, int(port))
        self.monitor = HealthMonitor(client=self._client, **monitor_kwargs)
        self._interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="obs-health-watch", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.monitor.update()
            except Exception:  # noqa: BLE001 - advisory plane
                pass

    def verdict(self) -> dict:
        return self.monitor.verdict()

    def describe(self) -> str:
        return self.monitor.describe()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._client.close()
