"""tpudist_torch.runtime.quarantine against the JAX package's
``tpudist.runtime.quarantine``: both managers, each over its own in-memory
store and on one injected clock, are driven by the same seeded script of
strikes, ticks and probe answers (exact, wrong, corrupted in transit, or
missing).  The stores hold the same keys and bytes after every step, the
managers the same states, and the counters moved alike."""

import importlib

import numpy as np
import pytest

from tpudist_torch import obs as tobs
from tpudist_torch.runtime import quarantine as tq
from tpudist_torch.runtime import wire as twire

COUNTERS = ("quarantine/strikes", "router/quarantines", "router/reinstated",
            "router/retired", "probe/sent", "probe/pass", "probe/fail")


@pytest.fixture(scope="module")
def ref():
    return (importlib.import_module("tpudist.runtime.quarantine"),
            importlib.import_module("tpudist.obs"))


class Store:
    def __init__(self):
        self.kv: dict[str, bytes] = {}

    def set(self, k, v):
        self.kv[k] = v if isinstance(v, bytes) else v.encode()

    def get(self, k):
        return self.kv.get(k)

    def delete(self, k):
        self.kv.pop(k, None)

    def keys(self, prefix=""):
        return [k for k in self.kv if k.startswith(prefix)]


def _counts(obs_mod) -> dict:
    snap = obs_mod.snapshot()["counters"]
    return {n: snap.get(n, {}).get("value", 0.0) for n in COUNTERS}


def _answer(store: Store, rng, expect) -> None:
    """Answer every outstanding probe the same seeded way."""
    for key in sorted(store.keys("q/inbox/")):
        pkey = key.rsplit("/", 1)[1]
        what = rng.choice(["exact", "exact", "wrong", "corrupt", "none"])
        if what == "none":
            continue
        store.delete(key)
        tokens = list(expect) if what != "wrong" else [0] * len(expect)
        frame = twire.encode_record("completion", {
            "key": pkey, "tokens": tokens, "reason": "length",
            "replica": key.split("/")[2]})
        if what == "corrupt":
            frame = frame[:-1] + bytes([frame[-1] ^ 1])
        store.set(f"q/done/{pkey}", frame)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_script_same_stores_and_states(ref, seed):
    jq, jobs = ref
    cfg_kw = dict(strike_threshold=2, strike_window_s=10.0,
                  probe_interval_s=1.0, probe_timeout_s=4.0,
                  reinstate_after=2, retire_after_fails=3)
    golden = ((1, 2, 3), (7, 8, 9))
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    stores = [Store(), Store()]
    mgrs = [jq.QuarantineManager(stores[0], namespace="q",
                                 golden=jq.GoldenProbe(*golden),
                                 config=jq.QuarantineConfig(**cfg_kw),
                                 clock=clock),
            tq.QuarantineManager(stores[1], namespace="q",
                                 golden=tq.GoldenProbe(*golden),
                                 config=tq.QuarantineConfig(**cfg_kw),
                                 clock=clock)]
    c0 = [_counts(jobs), _counts(tobs)]
    rng = np.random.default_rng(seed)
    rids = ["r0", "r1", "r2"]
    for step in range(80):
        t[0] += float(rng.uniform(0.2, 2.5))
        op = rng.choice(["strike", "tick", "tick", "answer", "drop"],
                        p=[0.3, 0.3, 0.15, 0.2, 0.05])
        if op == "strike":
            rid, kind = str(rng.choice(rids)), str(rng.choice(
                ["checksum", "corrupt_segment", "wire_error"]))
            assert mgrs[1].strike(rid, kind) == mgrs[0].strike(rid, kind)
        elif op == "tick":
            live = set(rng.choice(rids, size=2, replace=False).tolist())
            for m in mgrs:
                m.tick(live)
        elif op == "answer":
            state = rng.bit_generator.state
            for s in stores:
                rng.bit_generator.state = state
                _answer(s, rng, golden[1])
        else:
            rid = str(rng.choice(rids))
            for m in mgrs:
                m.drop(rid)
        assert stores[1].kv == stores[0].kv, step
        assert mgrs[1].quarantined() == mgrs[0].quarantined()
        for rid in rids:
            assert mgrs[1].state(rid) == mgrs[0].state(rid)
            assert mgrs[1].strikes(rid) == mgrs[0].strikes(rid)
    c1 = [_counts(jobs), _counts(tobs)]
    deltas = [{n: c1[i][n] - c0[i][n] for n in COUNTERS} for i in (0, 1)]
    assert deltas[1] == deltas[0]
    assert deltas[1]["router/quarantines"] >= 1


def test_config_validation_matches(ref):
    jq, _ = ref
    for bad in ({"strike_threshold": 0}, {"probe_timeout_s": 0.0},
                {"retire_after_fails": 0}, {"strike_window_s": -1.0}):
        with pytest.raises(ValueError):
            jq.QuarantineConfig(**bad)
        with pytest.raises(ValueError):
            tq.QuarantineConfig(**bad)
    assert tq.GoldenProbe((1,), (2, 3)).budget() == 2
    assert tq.GoldenProbe((1,), (2, 3), max_new_tokens=5).budget() == 5
