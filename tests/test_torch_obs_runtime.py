"""The runtime's counters on obs (tpudist_torch against the JAX package):
each port module publishes at tpudist's sites under tpudist's names.

* Host collectives: the same broadcasts, allreduces (flat, ring, a hier
  plan that falls back, four codecs), async allreduces and barriers on a
  3-rank gang over one store give equal ``coll/*`` counters, gauges and
  histogram counts in tpudist's and the port's worker snapshots — each
  rank dumps its own registry to a file, since the metrics live in the
  worker processes.
* The coord client: under the same injected faults ``coord/retries``,
  the backoff and outage histograms and the ``coord/unavailable`` gauge
  move alike.
* A ``Trainer`` epoch publishes tpudist's ``train/*`` names, its spans,
  recorder events and ``xla/step_tflops``; the FLOP-counted first step
  leaves the parameters bit for bit where an uncounted one does.
* ``mesh/axis_size~axis=*`` and ``train/bubble_fraction`` are equal for
  the same ``MeshSpec``; ``throughput/*`` are equal for the same meter
  steps on the same clock.
* A crashing elastic worker writes a post-mortem bundle and counts its
  round."""

import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudist_torch import obs as tobs

REPO = Path(__file__).resolve().parents[1]
PLANS = [("auto", {}),
         ("ring_none", {"algorithm": "ring", "compress": "none"}),
         ("hier_fallback", {"algorithm": "hier", "hosts": 2}),
         ("flat_fp16", {"algorithm": "flat", "compress": "fp16"}),
         ("ring_topk", {"algorithm": "ring", "compress": "topk",
                        "bucket_bytes": 64 << 10})]


def _coll_metrics(snap: dict, prefix: str) -> dict:
    return {"counters": {k: v["value"] for k, v in snap["counters"].items()
                         if k.startswith(prefix)},
            "gauges": {k: v["value"] for k, v in snap["gauges"].items()
                       if k.startswith(prefix)},
            "histograms": {k: v["count"]
                           for k, v in snap["histograms"].items()
                           if k.startswith(prefix)}}


def coll_rank_main(pkg: str, addr: str, rank: int, world: int, ns: str,
                   out: str) -> None:
    """One rank of the gang: every plan's ops, then this process's
    ``coll/*`` metrics to ``out``."""
    if pkg == "tpudist":
        coll = importlib.import_module("tpudist.runtime.collectives")
        coord = importlib.import_module("tpudist.runtime.coord")
        obs = importlib.import_module("tpudist.obs")
    else:
        coll = importlib.import_module("tpudist_torch.runtime.collectives")
        coord = importlib.import_module("tpudist_torch.runtime.coord")
        obs = tobs
    host, port = addr.rsplit(":", 1)
    client = coord.CoordClient(host, int(port))
    rng = np.random.default_rng(rank)
    big = {"a": rng.normal(size=40_000).astype(np.float32),
           "b": {"c": rng.normal(size=(3, 5)).astype(np.float32),
                 "d": np.arange(6, dtype=np.int32) * rank}}
    small = {"x": np.arange(4, dtype=np.float32) + rank}
    for r, (_, kw) in enumerate(PLANS):
        hc = coll.HostCollectives(client, rank, world, round_id=r,
                                  namespace=ns,
                                  config=coll.CollectiveConfig(**kw))
        # the broadcast opens the round: after a later op, its root's
        # closing barrier could delete posts a slow peer still fetches
        # in tpudist (ROADMAP Queue C 9)
        hc.broadcast(small, root=r % world)
        hc.allreduce_sum(big)
        hc.allreduce_mean(small)
        hc.allreduce_sum_async(big).wait()
        hc.barrier()
        hc.close()
    with open(out, "w") as fh:
        json.dump(_coll_metrics(obs.snapshot(), "coll/"), fh)


@pytest.fixture(scope="module")
def server():
    from tpudist_torch.runtime.coord import CoordServer

    try:
        s = CoordServer(0)
    except Exception as e:   # NativeUnavailable or build failure
        pytest.skip(f"native coord store unavailable: {e}")
    yield s
    s.stop()


def test_collectives_worker_snapshots_equal(server, tmp_path):
    world = 3
    addr = f"127.0.0.1:{server.port}"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    procs, outs = [], {}
    for pkg in ("tpudist", "port"):
        for rank in range(world):
            out = str(tmp_path / f"{pkg}_{rank}.json")
            outs[pkg, rank] = out
            log = open(tmp_path / f"{pkg}_{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, test_torch_obs_runtime as m; "
                 "m.coll_rank_main(*sys.argv[1:3], int(sys.argv[3]), "
                 "int(sys.argv[4]), *sys.argv[5:])",
                 pkg, addr, str(rank), str(world), f"obsrt-{pkg}", out],
                env=env, cwd=str(REPO), stdout=log,
                stderr=subprocess.STDOUT), log))
    for p, log in procs:
        rc = p.wait(timeout=240)
        log.close()
        assert rc == 0, Path(log.name).read_text()[-3000:]
    for rank in range(world):
        ref = json.loads(Path(outs["tpudist", rank]).read_text())
        got = json.loads(Path(outs["port", rank]).read_text())
        assert got == ref, rank
        c = got["counters"]
        assert c["coll/hier_fallback"] == 3          # sum, mean, async
        assert c["coll/broadcast"] == len(PLANS)
        assert c["coll/allreduce_async"] == len(PLANS)
        assert c["coll/barrier"] == 2 * len(PLANS)   # broadcast's own too
        assert c["coll/bytes_posted"] > 0 and c["coll/bytes_fetched"] > 0
        assert got["histograms"]["coll/ring_chunk_s"] > 0
        assert "coll/compress_ratio~algo=ring~compress=topk" \
            in got["gauges"]


def _fault_plan(faults_mod, failing: set[int]):
    """Raise on the coord ops whose ordinal is in ``failing``."""

    class Scripted(faults_mod.FaultPlan):
        def __init__(self):
            super().__init__()
            self.active = True
            self.calls = 0

        def coord_op(self, op):
            self.calls += 1
            if self.calls in failing:
                raise faults_mod.FaultInjected(f"injected: {op}")

    return Scripted()


def _coord_run(pkg: str, port: int) -> dict:
    if pkg == "tpudist":
        coord = importlib.import_module("tpudist.runtime.coord")
        faults = importlib.import_module("tpudist.runtime.faults")
        obs = importlib.import_module("tpudist.obs")
    else:
        coord = importlib.import_module("tpudist_torch.runtime.coord")
        faults = importlib.import_module("tpudist_torch.runtime.faults")
        obs = tobs
    names = ("coord/retries", "coord/retry_backoff_s", "coord/outage_s")

    def read():
        s = obs.snapshot()
        return ({n: s["counters"].get(n, {}).get("value", 0.0)
                 for n in names[:1]}
                | {n: s["histograms"].get(n, {}).get("count", 0)
                   for n in names[1:]})

    outcomes = []
    with coord.CoordClient("127.0.0.1", port, retries=3,
                           retry_base_s=0.0005, retry_cap_s=0.001) as c:
        # the outage tracker is process-wide: a success first closes any
        # outage an earlier test of this process left open (one that ended
        # on a refused non-idempotent verb), so that the baseline counts
        # only this run's stretches
        c.set("obsrt/k", b"v")
        before = read()
        faults.install(_fault_plan(
            faults, {1, 2, 4, 7, 8, 9, 10, 14, 15, 20}))
        try:
            for verb in ("get", "keys", "live", "get", "keys", "get",
                         "live", "get", "heartbeat", "get"):
                try:
                    {"get": lambda: c.get("obsrt/k"),
                     "keys": lambda: c.keys("obsrt/"),
                     "live": lambda: c.live(),
                     "heartbeat": lambda: c.heartbeat("obsrt/hb", 5.0),
                     }[verb]()
                    outcomes.append(True)
                except faults.FaultInjected:
                    outcomes.append(False)
        finally:
            faults.reset()
        c.get("obsrt/k")                 # closes the outage
    after = read()
    gauge = obs.snapshot()["gauges"]["coord/unavailable"]["value"]
    return {"outcomes": outcomes, "gauge": gauge,
            **{n: after[n] - before[n] for n in names}}


def test_coord_retries_equal_under_faults(server):
    ref = _coord_run("tpudist", server.port)
    got = _coord_run("port", server.port)
    assert got == ref
    assert got["coord/retries"] >= 6 and False in got["outcomes"]
    assert got["coord/retry_backoff_s"] == got["coord/retries"]
    assert got["coord/outage_s"] >= 1 and got["gauge"] == 0.0


def _trainer(tmp_path, name, seed=0):
    from tpudist_torch.data import ShardedLoader
    from tpudist_torch.models import MLP
    from tpudist_torch.train import Trainer, TrainerConfig, adam

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    model = MLP(1, 32, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    cfg = TrainerConfig(total_epochs=1, batch_size=16, log_every=2,
                        snapshot_path=str(tmp_path / f"{name}.npz"),
                        eval_every_epoch=False)
    return Trainer(cfg, model, adam(1e-3), None,
                   ShardedLoader([x, y], 16, shuffle=True, seed=seed,
                                 device="cpu"), seed=seed)


def test_trainer_epoch_publishes_tpudist_names(tmp_path):
    src = (REPO / "tpudist" / "train" / "trainer.py").read_text()
    want = set(re.findall(
        r'obs\.(?:counter|gauge|histogram)\("(train/[^"]+)"', src))
    spans = set(re.findall(r'obs\.span\("(\w+)"', src))
    assert len(want) == 6 and "cost_probe" in spans

    def snap():
        s = tobs.snapshot()
        return {n: (s["counters"].get(n) or s["gauges"].get(n)
                    or s["histograms"].get(n)) for n in want}

    before = snap()
    tobs.tracer.clear()
    t = _trainer(tmp_path, "a")
    t.train()
    after = snap()
    s = tobs.snapshot()
    got = {n for kind in ("counters", "gauges", "histograms")
           for n in s[kind] if n.startswith("train/")}
    assert want <= got
    delta = {n: after[n]["value"] - (before[n] or {}).get("value", 0.0)
             for n in ("train/steps", "train/examples", "train/epochs")}
    assert delta == {"train/steps": 4, "train/examples": 64,
                     "train/epochs": 1}
    assert after["train/step_time"]["count"] \
        - (before["train/step_time"] or {}).get("count", 0) == 4
    seen = {e["name"] for e in tobs.tracer.events()}
    assert spans - {"train_dispatch"} <= seen   # no stacked loop here
    kinds = {e["kind"] for e in tobs.recorder.events()}
    assert {"epoch_end", "train_log"} <= kinds
    # the first step's counted FLOPs: MLP(1, 32) on 16 images
    layers = [(784, 32), (32, 32), (32, 10)]
    assert t._step_flops == float(sum(
        2 * 16 * a * b * (2 if i == 0 else 3)
        for i, (a, b) in enumerate(layers)))
    assert s["gauges"]["xla/step_tflops"]["value"] > 0
    # an uncounted first step ends in the same parameters, bit for bit
    u = _trainer(tmp_path, "b")
    u._cost_probed = True
    u.train()
    assert u._step_flops is None
    for k, v in t.state.model.state_dict().items():
        assert torch.equal(v, u.state.model.state_dict()[k]), k


def test_throughput_meter_gauges_equal(monkeypatch):
    """The same step sequence on the same clock gives equal
    ``throughput/*`` gauges (exact: the same float arithmetic)."""
    ref_metrics = importlib.import_module("tpudist.utils.metrics")
    ref_obs = importlib.import_module("tpudist.obs")
    from tpudist_torch.utils.metrics import ThroughputMeter

    names = ("throughput/items_per_sec", "throughput/steps")
    ticks = [0.0, 0.5, 1.25, 1.5, 2.75, 3.0, 3.125]
    got = {}
    for pkg, meter in (("tpudist", ref_metrics.ThroughputMeter(2)),
                       ("tpudist_torch", ThroughputMeter(2))):
        clock = iter(ticks)
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        meter.start()
        for n in (16, 16, 32, 32, 8, 8):
            meter.step(n)
        snap = (ref_obs if pkg == "tpudist" else tobs).snapshot()["gauges"]
        got[pkg] = ({n: snap[n]["value"] for n in names},
                    meter.items_per_sec, meter.mean_step_time)
    assert got["tpudist"] == got["tpudist_torch"]
    assert got["tpudist_torch"][0] == {
        "throughput/items_per_sec": 80 / 1.875, "throughput/steps": 6.0}


@pytest.mark.parametrize("axes,bubble", [
    ({"dp": 2, "fsdp": 2, "tp": 2}, 0.0),
    ({"dp": 2, "pp": 2, "num_microbatches": 4}, 0.2),
    ({"ep": 4, "tp": 2}, 0.0)], ids=["dp_fsdp_tp", "dp_pp", "ep_tp"])
def test_mesh_gauges_equal(axes, bubble):
    ref_mesh = importlib.import_module("tpudist.parallel.mesh")
    ref_obs = importlib.import_module("tpudist.obs")
    from tpudist_torch.parallel.mesh import MeshSpec, mesh_gauges

    ref_mesh._publish_mesh_gauges(ref_mesh.MeshSpec(**axes), bubble)
    got = mesh_gauges(MeshSpec(**axes), bubble)
    names = [f"mesh/axis_size~axis={a}"
             for a in ("dp", "fsdp", "tp", "pp", "ep")]
    names.append("train/bubble_fraction")
    ref_g, port_g = ref_obs.snapshot()["gauges"], tobs.snapshot()["gauges"]
    assert {n: port_g[n]["value"] for n in names} \
        == {n: ref_g[n]["value"] for n in names} == got


def test_crashing_elastic_worker_writes_a_postmortem(server, tmp_path,
                                                      monkeypatch):
    from tpudist_torch.elastic.state import ElasticState
    from tpudist_torch.elastic.worker import run_elastic_worker
    from tpudist_torch.train.state import TrainState, sgd

    monkeypatch.setenv("TPUDIST_POSTMORTEM_DIR", str(tmp_path))
    model = torch.nn.Linear(2, 2)
    es = ElasticState(TrainState.create(model, sgd(0.1)))
    rounds0 = tobs.snapshot()["counters"].get(
        "elastic/rounds", {}).get("value", 0)

    def train_fn(state, ctx):
        raise KeyError("a real bug in the training step")

    with pytest.raises(KeyError):
        run_elastic_worker(train_fn, es,
                           coord_addr=f"127.0.0.1:{server.port}",
                           worker_id="crasher", ttl_s=1.0,
                           heartbeat_interval_s=0.2,
                           rendezvous_timeout_s=30.0)
    files = [f for f in os.listdir(tmp_path) if f.startswith("postmortem-")]
    assert len(files) == 1
    doc = json.loads((tmp_path / files[0]).read_text())
    assert doc["schema"] == "tpudist.postmortem/1"
    assert doc["context"]["component"] == "elastic_worker"
    assert doc["context"]["worker"] == "crasher"
    assert "KeyError" in json.dumps(doc["exception"])
    kinds = [e["kind"] for e in doc["events"]]
    assert "elastic_round" in kinds
    s = tobs.snapshot()
    assert s["counters"]["elastic/rounds"]["value"] - rounds0 == 1
    assert s["gauges"]["elastic/world_size"]["value"] == 1.0
