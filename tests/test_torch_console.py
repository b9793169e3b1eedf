"""tpudist_torch.obs.console against the JAX package's
``tpudist.obs.console``: both are pure functions of a
``tpudist.console/1`` doc, so the checked-in fixture renders to the same
bytes, ``main --once --snapshot`` prints the same frame (also through
``python -m``), ``sparkline`` agrees on seeded values, and ``gather``
over equal fake coordinators builds the same doc (exact), but for the
events tpudist's live ``gather`` drops (ROADMAP Queue C 12)."""

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

tconsole = importlib.import_module("tpudist_torch.obs.console")

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "console_snapshot.json"


@pytest.fixture(scope="module")
def ref():
    return importlib.import_module("tpudist.obs.console")


@pytest.mark.parametrize("width", [96, 60])
def test_render_fixture_byte_identical(ref, width):
    doc = json.loads(FIXTURE.read_text())
    assert doc["schema"] == tconsole.CONSOLE_SCHEMA == ref.CONSOLE_SCHEMA
    frame = tconsole.render(doc, width=width)
    assert frame.encode() == ref.render(doc, width=width).encode()
    for section in ("REPLICAS", "ALERTS", "SERIES", "RECENT TERMINALS",
                    "fired this session"):
        assert section in frame


def test_main_once_snapshot_same_output(ref, capsys, tmp_path):
    assert tconsole.main(["--once", "--snapshot", str(FIXTURE)]) == 0
    got = capsys.readouterr().out
    assert ref.main(["--once", "--snapshot", str(FIXTURE)]) == 0
    assert got == capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "nope/1"}))
    assert tconsole.main(["--once", "--snapshot", str(bad)]) == 2
    assert tconsole.main(["--once"]) == 2        # no --coord, no snapshot
    # the module entry point prints the same frame
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.obs.console", "--once",
         "--snapshot", str(FIXTURE)], capture_output=True, text=True,
        env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparkline_equal(ref, seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 5, 40):
        vals = rng.normal(size=n).tolist()
        if n > 3:
            vals[2] = float("nan")
        for width in (8, 32):
            assert tconsole.sparkline(vals, width) == ref.sparkline(vals,
                                                                    width)
    assert tconsole.sparkline([2.0] * 4) == ref.sparkline([2.0] * 4)


class FakeCoord:
    def __init__(self):
        self.kv: dict[str, bytes] = {}
        self.live_set: set[str] = set()

    def keys(self, prefix=""):
        return sorted(k for k in self.kv if k.startswith(prefix))

    def get(self, key):
        return self.kv.get(key)

    def live(self):
        return set(self.live_set)


def _fill(fc, now):
    rng = np.random.default_rng(5)
    for i, role in enumerate(("prefill", "decode", "both")):
        rid = f"r{i}"
        fc.kv[f"ns/replica/{rid}"] = json.dumps(
            {"replica_id": rid, "rank": i, "role": role}).encode()
        if i != 2:
            fc.live_set.add(f"ns:{rid}")
        fc.kv[f"ns/metrics/{i}"] = json.dumps(
            {"rank": i, "published_at": now - i,
             "counters": {"serve/requests": {"value": float(10 + i)}},
             "gauges": {"serve/queue_depth": {
                 "value": float(rng.integers(0, 5))}},
             "histograms": {}}).encode()
    fc.kv["ns/draining/r1"] = b"1"
    fc.kv["ns/quarantined/r2"] = b"1"
    events = [{"t": now - 3 + 0.1 * j, "i": j, "kind": k, "trace": "t0",
               "src": "router", "rid": "q0"}
              for j, k in enumerate(("enqueue", "dispatch", "done"))]
    fc.kv["ns/events/0"] = json.dumps(
        {"schema": "tpudist.events/1", "rank": 0, "published_at": now,
         "dropped": 0, "events": events}).encode()


def test_gather_same_doc(ref, monkeypatch):
    now = 7000.0
    monkeypatch.setattr(time, "time", lambda: now)
    docs, frames = [], []
    for mod, tsdb_mod, alerts_mod in (
            (ref, importlib.import_module("tpudist.obs.tsdb"),
             importlib.import_module("tpudist.obs.alerts")),
            (tconsole, importlib.import_module("tpudist_torch.obs.tsdb"),
             importlib.import_module("tpudist_torch.obs.alerts"))):
        fc = FakeCoord()
        _fill(fc, now)
        db = tsdb_mod.TSDB(clock=lambda: 10.0)
        db.record("fleet/coord_up", 1.0, t=9.0)
        db.record("serve/queue_depth", 3.0, t=10.0)
        mgr = alerts_mod.AlertManager(db, clock=lambda: 10.0)
        mgr.evaluate()
        doc = mod.gather(fc, "ns", tsdb=db, alerts=mgr)
        docs.append(json.loads(json.dumps(doc)))
        frames.append(mod.render(doc))
    # tpudist's gather slices merge_events' doc, which raises, so its
    # live doc has no events (ROADMAP Queue C 12); the port's has them
    assert docs[0]["events"] == []
    assert [e["kind"] for e in docs[1]["events"]] == ["enqueue",
                                                       "dispatch", "done"]
    ref_events = importlib.import_module("tpudist.obs.events")
    fc = FakeCoord()
    _fill(fc, now)
    assert docs[1]["events"] == json.loads(json.dumps(
        ref_events.merge_events(ref_events.collect_events(
            fc, "ns/events"))["events"]))
    docs[1]["events"] = []
    assert docs[0] == docs[1]
    assert frames[0] == ref.render(docs[1])
    reps = docs[1]["replicas"]
    assert sorted(reps) == ["r0", "r1", "r2"]
    assert reps["r1"]["draining"] and reps["r2"]["quarantined"]
    assert not reps["r2"]["live"]
    assert "RECENT TERMINALS  (last 1 of 1)" in frames[1]
