"""The slice as a whole: TTL-heartbeat elastic recovery of the port over
real process boundaries, held against tpudist's.

``test_kill9_gang_matches_tpudist`` launches tpudist's unchanged
``workers/ttl_elastic_worker.py`` gang and the port's twin
(``workers/torch_ttl_elastic_worker.py``) from the same initial weights
(flax's ``MLP(hidden_layers=1, features=32)`` init at ``jax.random.key(0)``,
converted), each on its own launcher and CPU.  Spawn 2 SIGKILLs itself
after step 13; the survivors must detect the loss through the
coordination store's TTL leases, roll back to the commit at batch 10,
re-rendezvous at world 2, rescale the lr once and finish.  The two gangs'
events must be equal, the port's final parameters (its last durable
commit) within 1e-4 of each tensor's largest magnitude of tpudist's (its
last orbax commit), and the survivors of each gang bitwise equal.

The remaining twins of ``tests/test_elastic_ttl.py`` run the port's gang
alone.  Every gang is bounded: the port's launcher by its ``timeout_s``,
tpudist's (which has no bound) by running its CLI in its own session and
killing the session past the same limit.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tpudist_torch.runtime.launch import launch

ROOT = Path(__file__).resolve().parent.parent
REF_WORKER = str(ROOT / "tests" / "workers" / "ttl_elastic_worker.py")
WORKER = str(ROOT / "tests" / "workers" / "torch_ttl_elastic_worker.py")
GANG_TIMEOUT_S = 300
# one intra-op thread a worker: a gang of CPU workers beside other tests
# must not starve its heartbeat threads past their TTL
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
PARAM_TOL = 1e-4     # of each tensor's largest magnitude, port vs tpudist
VALUE_RTOL = 1e-4    # the all-reduced loss, the checksum (sum of |params|), lr
# the events both workers emit (the twin adds ``first_step`` and stamps
# every event with its wall time ``t``)
REF_EVENTS = ("round", "commit", "reset", "suicide", "done", "restored")


def _events(out, spawn_id):
    p = Path(out) / f"events_{spawn_id}.jsonl"
    return ([json.loads(line) for line in p.read_text().splitlines()]
            if p.exists() else [])


def _ref_view(events):
    """Events as tpudist's worker writes them: its kinds only, no ``t``."""
    return [{k: v for k, v in e.items() if k != "t"}
            for e in events if e["event"] in REF_EVENTS]


def _structure(events):
    """Events without the values two implementations compute in their own
    arithmetic (loss, checksum, lr)."""
    return [{k: v for k, v in e.items()
             if k not in ("loss", "checksum", "lr")} for e in events]


def _done(out, sid):
    return [e for e in _events(out, sid) if e["event"] == "done"][-1]


def _logged(worker):
    """``worker`` run with its stdout and stderr appended to
    ``$WORKER_OUT_DIR/log_<spawn id>.txt`` (``exec`` keeps its pid, so a
    launcher's signals still reach it)."""
    return ["sh", "-c", 'exec "$0" "$1" >>"$WORKER_OUT_DIR/log_'
            '${TPUDIST_PROCESS_ID:-x}.txt" 2>&1', sys.executable, worker]


def _tail(path, lines=25):
    p = Path(path)
    return ("\n".join(p.read_text(errors="replace").splitlines()[-lines:])
            if p.exists() else "(no log)")


def _diagnosis(gangs, sids=(0, 1, 2)):
    """Every gang's events without their values and the tail of each
    worker's log: the message of an assertion that compares gangs."""
    parts = []
    for name, out in gangs.items():
        for sid in sids:
            parts.append(f"--- {name} gang, spawn {sid}: events\n"
                         + "\n".join(json.dumps(e) for e in
                                     _structure(_ref_view(_events(out, sid))))
                         + f"\n--- {name} gang, spawn {sid}: log tail\n"
                         + _tail(Path(out) / f"log_{sid}.txt"))
    return "\n".join(parts)


def _gang(tmp_path, nprocs, env, name="port", logged=False, **kw):
    out = tmp_path / name
    out.mkdir()
    cmd = _logged(WORKER) if logged else [sys.executable, WORKER]
    rc = launch(cmd, nprocs=nprocs, device="cpu",
                elastic_inprocess=True, timeout_s=GANG_TIMEOUT_S,
                env={"WORKER_OUT_DIR": str(out), **ONE_THREAD, **env}, **kw)
    return rc, out


def _ref_gang(tmp_path, env):
    """tpudist's launcher CLI in its own session, killed past the limit."""
    out = tmp_path / "ref"
    out.mkdir()
    cmd = [sys.executable, "-m", "tpudist.runtime.launch", "-n", "3",
           "--min-nprocs", "2", "--elastic-inprocess", "--",
           *_logged(REF_WORKER)]
    penv = dict(os.environ, WORKER_OUT_DIR=str(out), PYTHONPATH=str(ROOT),
                JAX_PLATFORMS="cpu", **ONE_THREAD, **env)
    proc = subprocess.Popen(cmd, env=penv, cwd=str(ROOT),
                            start_new_session=True)
    try:
        rc = proc.wait(timeout=GANG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError("tpudist's gang did not finish in time")
    return rc, out


def _flax_init_npz(path):
    """flax's MLP(1, 32) init at key 0 as the port's state_dict."""
    import jax

    from tpudist.models import MLP
    from tpudist_torch.models import from_flax_mlp_params

    params = MLP(hidden_layers=1, features=32).init(
        jax.random.key(0), np.zeros((1, 28 * 28), np.float32))["params"]
    sd = from_flax_mlp_params(jax.tree.map(np.asarray, params))
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return params


def _port_params(ckpt_dir, sid):
    from tpudist_torch.elastic.checkpoint import latest_step

    d = Path(ckpt_dir) / f"w{sid}"
    with np.load(d / f"step_{latest_step(d)}" / "state.npz") as z:
        return {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}


def _ref_params(ckpt_dir, sid, init_params):
    """tpudist's last orbax commit of spawn ``sid``, as the port's names."""
    import jax
    import optax

    from tpudist.elastic.orbax_ckpt import OrbaxCheckpointer
    from tpudist.models import MLP
    from tpudist.train.state import TrainState
    from tpudist_torch.models import from_flax_mlp_params

    template = TrainState.create(
        MLP(hidden_layers=1, features=32).apply, init_params,
        optax.inject_hyperparams(optax.sgd)(learning_rate=0.1), rng=0)
    ckpt = OrbaxCheckpointer(Path(ckpt_dir) / f"w{sid}")
    try:
        _, tree, _ = ckpt.restore_latest(template)
    finally:
        ckpt.close()
    return {k: v.numpy() for k, v in from_flax_mlp_params(
        jax.tree.map(np.asarray, tree.params)).items()}


def _assert_shrunk_3_to_2(out, survivors=(0, 1), victim=2, gang="port",
                          why=""):
    """The shrink's invariants; each failure names ``gang`` and the event
    it is about, followed by ``why`` (the gangs' events and log tails)."""
    def at(event, sid):
        return f"{gang} gang, spawn {sid}, {event}\n{why}"

    ev = _events(out, victim)
    assert _ref_view(ev)[-1:] == [{"event": "suicide", "step": 13}], \
        at("suicide", victim)
    for sid in survivors:
        ev = _events(out, sid)
        rounds = [e for e in ev if e["event"] == "round"]
        assert rounds[0]["world"] == 3 and rounds[0]["resume_batch"] == 0, \
            at("first round", sid)
        assert rounds[-1]["world"] == 2, at("last round", sid)
        # commit every 5, killed @13
        assert rounds[-1]["resume_batch"] == 10, at("last round", sid)
        resets = [e for e in ev if e["event"] == "reset"]
        assert [(r["old_world"], r["new_world"]) for r in resets] == [(3, 2)], \
            at("reset", sid)
        done = [e for e in ev if e["event"] == "done"]
        assert done and done[-1]["steps"] == 30 and done[-1]["world"] == 2, \
            at("done", sid)
        assert done[-1]["lr"] == pytest.approx(0.1 * 2 / 3), at("done", sid)
    a, b = (_done(out, sid) for sid in survivors)
    assert a["checksum"] == b["checksum"] and a["loss"] == b["loss"], \
        at("done (survivors differ)", survivors)


def test_kill9_gang_matches_tpudist(tmp_path):
    init = _flax_init_npz(tmp_path / "init.npz")
    # an uncompressed wire: the default bf16 one turns the two packages'
    # f32 rounding differences (~1e-7) into whole bf16 steps (2**-8) that
    # compound over 30 steps; the bf16 codec is held byte for byte against
    # tpudist's in test_torch_collectives.py
    kill = {"WORKER_KILL_SPAWN_ID": "2", "WORKER_KILL_AT_STEP": "13",
            "TPUDIST_COLL_COMPRESS": "none"}
    rc, ref = _ref_gang(tmp_path, {**kill,
                                   "WORKER_CKPT_DIR": str(tmp_path / "rc")})
    assert rc == 0, "ref gang exit code\n" + _diagnosis({"ref": ref})
    rc, out = _gang(tmp_path, 3, {**kill,
                                  "WORKER_INIT_NPZ": str(tmp_path / "init.npz"),
                                  "WORKER_CKPT_DIR": str(tmp_path / "pc")},
                    min_nprocs=2, logged=True)
    why = _diagnosis({"ref": ref, "out": out})
    assert rc == 0, "out gang exit code\n" + why
    _assert_shrunk_3_to_2(ref, gang="ref", why=why)
    _assert_shrunk_3_to_2(out, gang="out", why=why)
    # the same lifecycle, event for event
    for sid in (0, 1, 2):
        got, want = _ref_view(_events(out, sid)), _events(ref, sid)
        assert _structure(got) == _structure(want), \
            f"out and ref gangs differ in spawn {sid}'s events\n{why}"
        for g, w in zip(got, want):
            for key in ("loss", "checksum", "lr"):
                if key in w:
                    assert g[key] == pytest.approx(w[key], rel=VALUE_RTOL), \
                        (f"out vs ref, spawn {sid}, {w['event']} {key}", why)
    # the port's survivors hold bitwise-equal parameters...
    p0, p1 = _port_params(tmp_path / "pc", 0), _port_params(tmp_path / "pc", 1)
    assert all(np.array_equal(p0[k], p1[k]) for k in p0), \
        "out gang's survivors' last commits differ\n" + why
    # ...within PARAM_TOL of each tensor's largest magnitude of tpudist's
    want = _ref_params(tmp_path / "rc", 0, init)
    assert sorted(want) == sorted(p0)
    for k, w in want.items():
        err = np.max(np.abs(p0[k] - w)) / np.max(np.abs(w))
        assert err <= PARAM_TOL, (k, err)


def _loop_records(out, sid):
    p = Path(out) / f"loop_{sid}.jsonl"
    return [json.loads(line) for line in p.read_text().splitlines()]


def test_kill9_ici_gang_matches_host_plane(tmp_path):
    """The kill-9 gang with gradients on each round's gloo process group
    (``data_plane="ici"``) against the same gang on the store (an
    uncompressed wire, as above): the same events, values within
    VALUE_RTOL, survivors bitwise equal.  Each round's first step shows
    the group carried the sync (``hlo``: gloo, calls counted), and the
    last round's store carried one allreduce (the root election's score)
    where the host plane's carried every step's."""
    env = {"WORKER_KILL_SPAWN_ID": "2", "WORKER_KILL_AT_STEP": "13",
           "TPUDIST_COLL_COMPRESS": "none"}
    rc_host, host = _gang(tmp_path, 3, env, name="host", min_nprocs=2,
                          logged=True)
    rc_ici, ici = _gang(tmp_path, 3, {**env, "WORKER_DATA_PLANE": "ici"},
                        name="ici", min_nprocs=2, logged=True)
    why = _diagnosis({"host": host, "ici": ici})
    assert rc_host == 0 and rc_ici == 0, why
    _assert_shrunk_3_to_2(host, gang="host", why=why)
    _assert_shrunk_3_to_2(ici, gang="ici", why=why)
    for sid in (0, 1, 2):
        got, want = _ref_view(_events(ici, sid)), _ref_view(_events(host, sid))
        assert _structure(got) == _structure(want), \
            f"ici and host gangs differ in spawn {sid}'s events\n{why}"
        for g, w in zip(got, want):
            for key in ("loss", "checksum", "lr"):
                if key in w:
                    assert g[key] == pytest.approx(w[key], rel=VALUE_RTOL), \
                        (f"ici vs host, spawn {sid}, {w['event']} {key}", why)
    for sid in (0, 1):
        rounds = [e["round"] for e in _events(ici, sid)
                  if e["event"] == "round"]
        hlo = [e for e in _events(ici, sid) if e["event"] == "hlo"]
        assert [e["round"] for e in hlo] == rounds, why
        assert all(e["backend"] == "gloo" and e["calls"] >= 1 for e in hlo)
        ici_ctl = [r for r in _loop_records(ici, sid)
                   if r["event"] == "control_plane"][-1]
        host_ctl = [r for r in _loop_records(host, sid)
                    if r["event"] == "control_plane"][-1]
        assert ici_ctl["calls"].get("allreduce") == 1, ici_ctl
        assert ici_ctl["data_calls"]["allreduce"] == 30 - 10
        assert host_ctl["calls"]["allreduce"] == 1 + 30 - 10, host_ctl


def test_kill9_ring_path_with_overlap(tmp_path):
    """The shrink on the ring (small buckets, several a step), bf16 on the
    wire and async-overlap sync: the same resume point, lr rescale and
    bitwise-equal survivors."""
    rc, out = _gang(tmp_path, 3, {
        "WORKER_KILL_SPAWN_ID": "2", "WORKER_KILL_AT_STEP": "13",
        "WORKER_OVERLAP": "1", "TPUDIST_COLL_ALGO": "ring",
        "TPUDIST_COLL_BUCKET_BYTES": "1024"}, min_nprocs=2)
    assert rc == 0
    _assert_shrunk_3_to_2(out)


def test_kill9_bucketed_backward_order_topk(tmp_path):
    """The shrink with gradients streamed from the backward hooks into
    OverlappedGradSync buckets over the ring with top-k error feedback:
    the same invariants, survivors bitwise equal."""
    rc, out = _gang(tmp_path, 3, {
        "WORKER_KILL_SPAWN_ID": "2", "WORKER_KILL_AT_STEP": "13",
        "WORKER_BUCKETED": "4096", "TPUDIST_COLL_ALGO": "ring",
        "TPUDIST_COLL_COMPRESS": "topk", "TPUDIST_COLL_TOPK_FRAC": "0.25",
        "TPUDIST_COLL_BUCKET_BYTES": "1024"}, min_nprocs=2)
    assert rc == 0
    _assert_shrunk_3_to_2(out)


@pytest.mark.slow
def test_kill9_rank0_reelects_and_resumes(tmp_path):
    """The round's rank 0 (round publisher, first broadcast root) dies:
    the survivors elect w1 as rank 0, re-publish the round and resume
    bitwise-identically within one commit interval."""
    rc, out = _gang(tmp_path, 3, {"WORKER_KILL_SPAWN_ID": "0",
                                  "WORKER_KILL_AT_STEP": "13"},
                    min_nprocs=2)
    assert rc == 0
    victim = _ref_view(_events(out, 0))
    assert victim[-1] == {"event": "suicide", "step": 13}
    assert [e for e in victim if e["event"] == "round"][0]["rank"] == 0
    for sid in (1, 2):
        ev = _events(out, sid)
        rounds = [e for e in ev if e["event"] == "round"]
        assert rounds[0]["world"] == 3 and rounds[-1]["world"] == 2
        assert rounds[-1]["resume_batch"] == 10
        assert rounds[-1]["round"] > rounds[0]["round"]
        resets = [e for e in ev if e["event"] == "reset"]
        assert resets[-1]["old_world"] == 3 and resets[-1]["new_world"] == 2
    r1 = [e for e in _events(out, 1) if e["event"] == "round"][-1]
    r2 = [e for e in _events(out, 2) if e["event"] == "round"][-1]
    assert r1["rank"] == 0 and r2["rank"] == 1 and r1["round"] == r2["round"]
    a, b = _done(out, 1), _done(out, 2)
    assert a["checksum"] == b["checksum"] and a["loss"] == b["loss"]


@pytest.mark.slow
def test_double_kill_shrinks_to_one(tmp_path):
    """3 -> 2 at step 13, then 2 -> 1 at step 22: the last survivor rolls
    back twice, rescales twice and finishes alone."""
    rc, out = _gang(tmp_path, 3, {"WORKER_KILL_PLAN": "2:13,1:22"},
                    min_nprocs=1)
    assert rc == 0
    ev = _events(out, 0)
    rounds = [e for e in ev if e["event"] == "round"]
    assert [r["world"] for r in rounds] == [3, 2, 1]
    assert rounds[1]["resume_batch"] == 10
    assert rounds[2]["resume_batch"] == 20
    resets = [(e["old_world"], e["new_world"])
              for e in ev if e["event"] == "reset"]
    assert resets == [(3, 2), (2, 1)]
    done = _done(out, 0)
    assert done["steps"] == 30 and done["world"] == 1
    assert done["lr"] == pytest.approx(0.1 * (2 / 3) * (1 / 2))


@pytest.mark.slow
def test_full_gang_loss_resumes_from_durable_commit(tmp_path):
    """Every worker dies: the launcher restarts the gang and each worker
    restores its last durable (npz Checkpointer) commit, batch 10."""
    rc, out = _gang(tmp_path, 3, {
        "WORKER_CKPT_DIR": str(tmp_path / "ckpt"),
        "WORKER_KILL_PLAN": "0:13,1:13,2:13"}, min_nprocs=3, max_restarts=1)
    assert rc == 0
    checksums = set()
    for sid in (0, 1, 2):
        ev = _ref_view(_events(out, sid))
        assert {"event": "suicide", "step": 13} in ev
        restored = [e for e in ev if e["event"] == "restored"]
        assert restored and restored[-1]["batch"] == 10
        rounds = [e for e in ev if e["event"] == "round"]
        assert rounds[0]["resume_batch"] == 0
        assert rounds[-1]["world"] == 3 and rounds[-1]["resume_batch"] == 10
        done = _done(out, sid)
        assert done["steps"] == 30 and done["world"] == 3
        checksums.add(done["checksum"])
    assert len(checksums) == 1


def _grow(tmp_path, incumbents, joiner, wait_after_round_s=0.0):
    """Start ``incumbents`` as a 2-gang, then ``joiner`` once round 0 has
    formed; every process bounded by GANG_TIMEOUT_S."""
    from tpudist_torch.runtime.coord import CoordServer

    out = tmp_path / "port"
    out.mkdir()
    server = CoordServer(0)
    base = dict(os.environ, WORKER_OUT_DIR=str(out), WORKER_STEP_DELAY="0.4",
                TPUDIST_DEVICE="cpu", PYTHONPATH=str(ROOT), **ONE_THREAD,
                TPUDIST_COORD_ADDR=f"127.0.0.1:{server.port}")
    procs = []
    try:
        for i in incumbents:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER],
                env={**base, "TPUDIST_PROCESS_ID": str(i),
                     "TPUDIST_NUM_PROCESSES": "2"}))
        deadline = time.monotonic() + 120
        while not any(e["event"] == "round"
                      for e in _events(out, incumbents[0])):
            assert time.monotonic() < deadline, "round 0 never formed"
            time.sleep(0.2)
        time.sleep(wait_after_round_s)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER],
            env={**base, "TPUDIST_PROCESS_ID": str(joiner),
                 "TPUDIST_NUM_PROCESSES": "1"}))
        for p in procs:
            assert p.wait(timeout=GANG_TIMEOUT_S) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    return out


@pytest.mark.slow
def test_late_joiner_grows_world(tmp_path):
    """The GROW path: a third worker appears beside a training 2-gang;
    everyone re-rendezvouses at world 3, the joiner adopts the committed
    state and position, and all three finish identically."""
    out = _grow(tmp_path, (0, 1), 2)
    checksums = set()
    for sid in (0, 1, 2):
        done = _done(out, sid)
        assert done["steps"] == 30 and done["world"] == 3
        checksums.add(done["checksum"])
        rounds = [e for e in _events(out, sid) if e["event"] == "round"]
        assert rounds[-1]["world"] == 3
        assert rounds[-1]["resume_batch"] % 5 == 0
    assert len(checksums) == 1
    for sid in (0, 1):
        resets = [e for e in _events(out, sid) if e["event"] == "reset"]
        assert resets and (resets[-1]["old_world"],
                           resets[-1]["new_world"]) == (2, 3)


@pytest.mark.slow
def test_fresh_joiner_sorting_first_does_not_wipe_progress(tmp_path):
    """A from-scratch joiner whose id sorts first becomes rank 0, but the
    broadcast root is elected by progress: it adopts the incumbents'
    state instead of wiping it."""
    out = _grow(tmp_path, (1, 2), 0, wait_after_round_s=2.5)
    checksums = {_done(out, sid)["checksum"] for sid in (0, 1, 2)}
    assert len(checksums) == 1
    joiner = [e for e in _events(out, 0) if e["event"] == "round"]
    assert joiner and joiner[-1]["resume_batch"] > 0
    assert joiner[-1]["resume_batch"] % 5 == 0


@pytest.mark.slow
def test_steady_gang_completes_without_resize(tmp_path):
    """No failures: one round at world 2, no resets, identical results."""
    rc, out = _gang(tmp_path, 2, {})
    assert rc == 0
    for sid in (0, 1):
        ev = _events(out, sid)
        assert [e["event"] for e in ev if e["event"] == "round"] == ["round"]
        assert not [e for e in ev if e["event"] == "reset"]
        assert ev[-1]["event"] == "done" and ev[-1]["world"] == 2
    assert _done(out, 0)["checksum"] == _done(out, 1)["checksum"]


EXAMPLE = str(ROOT / "examples" / "horovod_mnist_elastic_gpu.py")


def _run_bounded(cmd, env, cwd):
    """Run ``cmd`` in its own session; kill the session past the limit."""
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out, _ = proc.communicate(timeout=GANG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{cmd} did not finish in time")
    return proc.returncode, out


def test_horovod_example_sim_resize_on_cpu(tmp_path):
    """``--elastic sim`` with an injected resize: the reset line, the
    rollback, and the held-out accuracy line."""
    rc, out = _run_bounded(
        [sys.executable, EXAMPLE, "--epochs", "1", "--limit", "512",
         "--batch-size", "64", "--resize-at", "0:3:2"],
        dict(os.environ, TPUDIST_DEVICE="cpu", **ONE_THREAD), tmp_path)
    assert rc == 0, out
    assert "reset: world 1 -> 2, lr -> 0.00707" in out
    assert "accuracy: " in out


def test_horovod_example_ttl_gang_on_cpu(tmp_path):
    """``--elastic ttl`` through the launcher CLI, three CPU workers: every
    worker finishes both epochs at world 3 and reports the same
    accuracy (bitwise-equal replicas)."""
    rc, out = _run_bounded(
        [sys.executable, "-m", "tpudist_torch.runtime.launch", "-n", "3",
         "--min-nprocs", "2", "--elastic-inprocess", "--device", "cpu", "--",
         EXAMPLE, "--elastic", "ttl", "--epochs", "2", "--limit", "1536",
         "--batch-size", "64", "--commit-every", "4"],
        dict(os.environ, PYTHONPATH=str(ROOT), **ONE_THREAD), tmp_path)
    assert rc == 0, out
    lines = out.splitlines()
    assert sum(line.startswith("[rank ") and "epoch 1 loss" in line
               for line in lines) == 3, out
    accuracies = {line for line in lines if line.startswith("accuracy: ")}
    assert len(accuracies) == 1, accuracies
    assert "reset:" not in out
