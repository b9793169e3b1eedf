"""tpudist_torch.obs.health against the JAX package's ``tpudist.obs.health``:
over the same seeded sequence of published snapshots, on an injected
clock, both monitors give the same verdicts round by round (states,
skews, ages, transitions), emit the same ``health/*`` metrics and record
the same flight-recorder transitions."""

import importlib

import numpy as np
import pytest

from tpudist_torch import obs as tobs

thealth = importlib.import_module("tpudist_torch.obs.health")
treg = importlib.import_module("tpudist_torch.obs.registry")


@pytest.fixture(scope="module")
def ref():
    return {m: importlib.import_module(f"tpudist.obs.{m}")
            for m in ("health", "registry", "recorder")}


def _rounds(seed: int, n_ranks: int = 4, n_rounds: int = 12):
    """Per round: {rank: snapshot}, ``now``.  Rank 1 turns into a
    straggler and recovers, rank 2 stops publishing for a stretch (stale,
    then lost), rank 3 restarts (its counts fall back to zero)."""
    rng = np.random.default_rng(seed)
    counts = [0] * n_ranks
    sums = [0.0] * n_ranks
    published = [100.0] * n_ranks
    out = []
    for rnd in range(n_rounds):
        now = 100.0 + 5.0 * rnd
        snaps = {}
        for r in range(n_ranks):
            if r == 2 and 3 <= rnd <= 8:
                pass        # silent: its last snapshot ages
            else:
                published[r] = now - float(rng.uniform(0, 1))
                step = 0.01 * (1 + 0.1 * float(rng.random()))
                if r == 1 and 2 <= rnd <= 6:
                    step *= 5.0
                if r == 3 and rnd == 7:
                    counts[r], sums[r] = 0, 0.0
                k = int(rng.integers(3, 8))
                counts[r] += k
                sums[r] += k * step
            if r == 2 and rnd == 8:
                continue    # the key vanished from the store
            snaps[r] = {"rank": r, "published_at": published[r],
                        "histograms": {"train/step_time": {
                            "count": counts[r], "sum": sums[r]}}}
        out.append((snaps, now))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("confirm_n,recover_n", [(1, 1), (2, 2), (2, 3)])
def test_same_verdicts_over_the_same_snapshots(ref, seed, confirm_n,
                                               recover_n):
    kw = dict(skew_threshold=2.0, stale_after_s=7.0, lost_after_s=16.0,
              confirm_n=confirm_n, recover_n=recover_n)
    regs = [ref["registry"].MetricRegistry(), treg.MetricRegistry()]
    recs = [ref["recorder"].FlightRecorder(), tobs.FlightRecorder()]
    mons = [ref["health"].HealthMonitor(registry=regs[0], recorder=recs[0],
                                        **kw),
            thealth.HealthMonitor(registry=regs[1], recorder=recs[1], **kw)]
    states = set()
    for snaps, now in _rounds(seed):
        want = mons[0].observe(snaps, now=now)
        got = mons[1].observe(snaps, now=now)
        assert got == want
        assert mons[1].describe() == mons[0].describe()
        states |= {v["state"] for v in got["ranks"].values()}
    assert {"healthy", "straggler", "stale"} <= states
    snaps = [r.snapshot() for r in regs]
    snaps[1]["time"] = snaps[0]["time"]
    assert snaps[1] == snaps[0]
    strip = [[{k: v for k, v in e.items() if k != "t"} for e in r.events()]
             for r in recs]
    assert strip[1] == strip[0]


def test_fleet_wide_blackout_reads_stale_not_lost(ref):
    """Every rank silent in the same round: a path problem (a coord
    brownout), so lost is demoted to stale in both."""
    kw = dict(stale_after_s=2.0, lost_after_s=4.0, confirm_n=1,
              recover_n=1)
    mons = [ref["health"].HealthMonitor(
                registry=ref["registry"].MetricRegistry(),
                recorder=ref["recorder"].FlightRecorder(), **kw),
            thealth.HealthMonitor(registry=treg.MetricRegistry(),
                                  recorder=tobs.FlightRecorder(), **kw)]
    snaps = {r: {"published_at": 0.0, "histograms": {}} for r in range(3)}
    for now in (1.0, 10.0):
        got = mons[1].observe(snaps, now=now)
        assert got == mons[0].observe(snaps, now=now)
    assert got["stale"] == ["0", "1", "2"] and got["lost"] == []


def test_argument_checks_and_watcher_surface():
    with pytest.raises(ValueError):
        tobs.HealthMonitor(skew_threshold=1.0)
    with pytest.raises(ValueError):
        tobs.HealthMonitor(confirm_n=0)
    with pytest.raises(ValueError):
        tobs.HealthMonitor().update()
    assert thealth.STATES == ("healthy", "straggler", "stale", "lost")
    assert tobs.HealthMonitor().describe() == "health: no observations yet"
    assert callable(getattr(tobs.HealthWatcher, "stop"))
