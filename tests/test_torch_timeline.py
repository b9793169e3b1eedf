"""tpudist_torch.obs.timeline against the JAX package's
``tpudist.obs.timeline``: a seeded merged events doc (complete,
redispatched, rerouted, shed and gapped traces, plus trace-less fleet
events) gives equal ``load_events``, ``render_timeline``,
``summarize_timelines``, ``render_summary`` and ``to_chrome`` output,
and ``main`` prints and writes the same for every mode (exact)."""

import importlib
import json

import numpy as np
import pytest

ttl = importlib.import_module("tpudist_torch.obs.timeline")
tev = importlib.import_module("tpudist_torch.obs.events")


@pytest.fixture(scope="module")
def ref():
    return importlib.import_module("tpudist.obs.timeline")


def _events(seed: int) -> list[dict]:
    """Router and replica events of 12 traces, time-ordered per source
    with per-source sequence numbers (the merged shape)."""
    rng = np.random.default_rng(seed)
    out: list[dict] = []
    seq = {"router": 0, "r0": 0, "r1": 0}

    def ev(src, t, kind, trace, **kw):
        out.append({"t": round(float(t), 6), "i": seq[src], "kind": kind,
                    "trace": trace, "src": src, **kw})
        seq[src] += 1

    for n in range(12):
        tid = f"{seed:02d}{n:04x}"
        t = 100.0 + float(rng.exponential(0.5)) * n
        shape = n % 6
        ev("router", t, "enqueue", tid, rid=f"q{n}", priority=n % 2)
        if shape == 4:
            ev("router", t + 0.01, "shed", tid, reason="queue")
            continue
        t += float(rng.exponential(0.05))
        rep = "r0" if n % 2 else "r1"
        ev("router", t, "dispatch", tid, replica=rep)
        t += float(rng.exponential(0.1))
        ev(rep, t, "admit", tid, slot=int(rng.integers(0, 4)))
        for s in range(int(rng.integers(1, 5))):
            t += float(rng.exponential(0.08))
            ev(rep, t, "segment", tid, steps=int(rng.integers(1, 16)))
        if shape == 2:                       # the replica died
            t += 0.5
            ev("router", t, "redispatch", tid, dead=rep)
            ev("router", t + 0.01, "dispatch", tid, replica="r0")
            t += 0.2
            ev("r0", t, "admit", tid, slot=0)
            ev("r0", t + 0.1, "segment", tid, steps=8)
        if shape == 3:                       # rerouted, no fresh dispatch
            ev("router", t + 0.05, "reroute", tid, reason="rejected")
        if shape == 5:                       # still in flight
            continue
        ev(rep, t + 0.02, "done_commit", tid)
        ev("router", t + 0.03, "done", tid, tokens=int(rng.integers(1, 64)))
    ev("r1", 101.0, "swap_pause", None, version=2)
    ev("router", 103.5, "degrade_clamp", None, max_new=8)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_pure_functions_equal(ref, seed):
    events = _events(seed)
    timelines = tev.group_timelines(events)
    assert None in timelines
    for tid, tl in timelines.items():
        assert ttl.render_timeline(tid, tl) == ref.render_timeline(tid, tl)
    assert ttl.render_timeline("x", []) == ref.render_timeline("x", [])
    sa = ref.summarize_timelines(timelines)
    sb = ttl.summarize_timelines(timelines)
    assert json.dumps(sa, sort_keys=True) == json.dumps(sb, sort_keys=True)
    assert sb["traces"] == 12 and sb["redispatches"] == {0: 10, 1: 2}
    assert ttl.render_summary(sb) == ref.render_summary(sa)
    assert ttl.to_chrome(events) == ref.to_chrome(events)


def test_load_events_shapes(ref, tmp_path):
    events = _events(2)
    docs = {"merged.json": {"schema": "tpudist.events/1",
                            "sources": {}, "events": events},
            "postmortem.json": {"schema": "tpudist.postmortem/1",
                                "request_events": events[:5]},
            "raw.json": events[:3]}
    for name, doc in docs.items():
        path = tmp_path / name
        path.write_text(json.dumps(doc))
        assert ttl.load_events(str(path)) == ref.load_events(str(path))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "tpudist.tsdb/1"}))
    for mod in (ttl, ref):
        with pytest.raises(ValueError, match="not an event log"):
            mod.load_events(str(bad))


@pytest.mark.parametrize("flags", [
    [], ["--summary"], ["--trace", "000003"], ["--rid", "q7"],
    ["--trace", "nope"], ["--rid", "nope"], ["--require-complete"],
    ["--chrome", "{tmp}/chrome.json"]],
    ids=["all", "summary", "trace", "rid", "bad_trace", "bad_rid",
         "require_complete", "chrome"])
def test_main_same_output(ref, flags, tmp_path, capsys):
    path = tmp_path / "events.json"
    path.write_text(json.dumps({"schema": "tpudist.events/1",
                                "events": _events(0)}))
    outs = []
    for mod in (ref, ttl):
        argv = [str(path)] + [f.format(tmp=tmp_path) for f in flags]
        rc = mod.main(argv)
        cap = capsys.readouterr()
        chrome = None
        if "--chrome" in flags:
            chrome = json.loads((tmp_path / "chrome.json").read_text())
            (tmp_path / "chrome.json").unlink()
        outs.append((rc, cap.out, cap.err, chrome))
    assert outs[0] == outs[1]
    # unknown trace/rid: 2; a resolved trace with a gap (the reroute
    # without a fresh dispatch) fails --require-complete: 1
    want = 2 if "nope" in flags else 1 if "--require-complete" in flags \
        else 0
    assert outs[1][0] == want
