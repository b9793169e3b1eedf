"""The port's launcher (``tpudist_torch.runtime.launch``): gang restarts,
``min_nprocs`` shrink, host discovery, the per-worker blacklist, the
in-process elastic success rule, the environment a worker gets and the
deadline, driven with tpudist's framework-free
``tests/workers/flaky_worker.py`` (unchanged) and small inline workers.
The blacklist cases are the twins of ``tests/test_launch_blacklist.py``.
Every launch is bounded by ``timeout_s``."""

import json
import sys
from pathlib import Path

import pytest

from tpudist_torch.runtime import launch as launch_mod
from tpudist_torch.runtime.launch import launch as _launch

FLAKY = str(Path(__file__).parent / "workers" / "flaky_worker.py")
TIMEOUT_S = 120


def launch(*args, **kwargs):
    kwargs.setdefault("timeout_s", TIMEOUT_S)
    kwargs.setdefault("device", "cpu")
    return _launch(*args, **kwargs)


def _events(tmp_path):
    p = tmp_path / "events.jsonl"
    return [json.loads(line) for line in p.read_text().splitlines()]


def _scheduled():
    """{attempt: spawn ids} as the last launch scheduled them.  A failed
    attempt tears its healthy workers down at once, sometimes before
    they record themselves (the flake of ROADMAP Queue C 4), so which
    spawn ids ran is read from the supervisor; the successful attempt's
    workers also record themselves."""
    return {h["attempt"]: {str(s) for s in h["spawn_ids"]}
            for h in launch_mod.history}


def _worlds():
    return sorted({(h["attempt"], h["world"]) for h in launch_mod.history})


class TestPerWorkerBlacklist:
    """Per-host blacklist semantics (round-4 verdict #6,
    `horovod_mnist_elastic.py:108`): the SPECIFIC repeatedly-failing spawn
    slot is excluded — healthy workers keep their place — and the world
    re-grows with a fresh slot.  The flaky worker is jax-free, so these
    run in the default (not-slow) lane."""

    def _events(self, tmp_path):
        return _events(tmp_path)

    def test_repeat_offender_excluded_world_regrows(self, tmp_path):
        rc = launch(
            [sys.executable, FLAKY], nprocs=3, max_restarts=3,
            blacklist_after=2, coord_server=False,
            env={"PYTHONPATH": "", "WORKER_OUT_DIR": str(tmp_path),
                 "WORKER_FAIL_SPAWN_IDS": "1"},
        )
        assert rc == 0
        ev = self._events(tmp_path)
        by_attempt = _scheduled()
        last = max(by_attempt)
        assert {e["sid"] for e in ev if e["attempt"] == last} \
            == by_attempt[last]
        # sid 1 gets blacklist_after=2 chances, then is excluded while a
        # FRESH slot (3) fills the world back to 3 — healthy 0/2 stay
        assert by_attempt[0] == {"0", "1", "2"}
        assert by_attempt[1] == {"0", "1", "2"}
        assert by_attempt[2] == {"0", "2", "3"}
        assert all(e["world"] == 3 for e in ev)

    def test_healthy_workers_never_dropped_vs_shrink(self, tmp_path):
        """blacklist_after=1: one failure excludes the slot immediately;
        the success attempt still runs at FULL world (contrast with the
        min_nprocs shrink path, which drops a healthy worker)."""
        rc = launch(
            [sys.executable, FLAKY], nprocs=2, max_restarts=1,
            blacklist_after=1, coord_server=False,
            env={"PYTHONPATH": "", "WORKER_OUT_DIR": str(tmp_path),
                 "WORKER_FAIL_SPAWN_IDS": "1"},
        )
        assert rc == 0
        ev = self._events(tmp_path)
        last = {e["sid"] for e in ev if e["attempt"] == 1}
        assert last == {"0", "2"} == _scheduled()[1]  # 1 out, fresh 2 in
        assert all(e["world"] == 2 for e in ev)
        # sid 1 ran exactly once (no second chance at blacklist_after=1)
        assert sum(e["sid"] == "1" for e in ev) == 1
        assert _scheduled()[0] == {"0", "1"}

    def test_cooldown_readmits_slot_with_reset_count(self, tmp_path):
        """A cooled-down slot rejoins the roster (failure count reset)
        when capacity needs it — horovod's cooldown-range behavior.
        Healthy/fresh slots take precedence, so readmission is forced by
        making the fresh replacement fail too."""
        rc = launch(
            [sys.executable, FLAKY], nprocs=2, max_restarts=2,
            blacklist_after=1, blacklist_cooldown=0.0, coord_server=False,
            env={"PYTHONPATH": "", "WORKER_OUT_DIR": str(tmp_path),
                 "WORKER_FAIL_SPAWN_IDS": "1,2"},   # fresh sid 2 bad too
        )
        assert rc != 0
        a1, a2 = _scheduled()[1], _scheduled()[2]
        assert a1 == {"0", "2"}            # 1 excluded while cooling
        assert "1" in a2                   # readmitted: 2 blacklisted and
        assert "2" not in a2               # 1's cooldown had elapsed

    def test_recovered_slot_rescheduled_ahead_of_fresh_sids(self, tmp_path):
        """A slot whose cooldown expires with the roster FULL must rejoin
        ahead of the synthetic replacement sids, not behind them: the
        scheduled set is roster[:world], so a tail append would leave the
        recovered slot parked forever.  Here sid 1 fails attempts 0-1 and
        is blacklisted with an instant cooldown; fresh sid 2 replaces it
        at attempt 2, where sid 0 fails (once — not enough to blacklist).
        At attempt 3 the roster holds [0, 1, 2]: recovered 1 must outrank
        replacement 2 (the buggy tail append scheduled {0, 2})."""
        rc = launch(
            [sys.executable, FLAKY], nprocs=2, max_restarts=3,
            blacklist_after=2, blacklist_cooldown=0.0, coord_server=False,
            env={"PYTHONPATH": "", "WORKER_OUT_DIR": str(tmp_path),
                 "WORKER_FAIL_SPAWN_IDS": "1@0,1@1,0@2"},
        )
        assert rc == 0
        ev = self._events(tmp_path)
        by_attempt = _scheduled()
        last = max(by_attempt)
        assert {e["sid"] for e in ev if e["attempt"] == last} \
            == by_attempt[last]
        assert by_attempt[0] == {"0", "1"}
        assert by_attempt[1] == {"0", "1"}
        assert by_attempt[2] == {"0", "2"}   # 1 cooling; fresh 2 fills in
        assert by_attempt[3] == {"0", "1"}   # recovered 1 ahead of fresh 2
        assert all(e["world"] == 2 for e in ev)

    def test_blacklist_after_validation(self):
        with pytest.raises(ValueError, match="blacklist_after"):
            launch([sys.executable, FLAKY], nprocs=2, blacklist_after=0)


def test_gang_restart_on_worker_failure(tmp_path):
    """Attempt 0: spawn 1 exits 3 -> the gang is torn down and restarted
    whole (torchrun semantics); attempt 1 succeeds."""
    before = launch_mod.counters["restarts"]
    rc = launch([sys.executable, FLAKY], nprocs=2, max_restarts=1,
                coord_server=False,
                env={"WORKER_OUT_DIR": str(tmp_path),
                     "WORKER_FAIL_SPAWN_IDS": "1@0"})
    assert rc == 0
    assert _scheduled() == {0: {"0", "1"}, 1: {"0", "1"}}
    assert {e["sid"] for e in _events(tmp_path) if e["attempt"] == 1} \
        == {"0", "1"}
    assert [h["codes"][1] for h in launch_mod.history] == [3, 0]
    assert launch_mod.counters["restarts"] == before + 1


def test_gang_failure_propagates_exit_code(tmp_path):
    rc = launch([sys.executable, FLAKY], nprocs=2, max_restarts=0,
                coord_server=False,
                env={"WORKER_OUT_DIR": str(tmp_path),
                     "WORKER_FAIL_SPAWN_IDS": "0"})
    assert rc == 3


def test_shrink_to_min_nprocs(tmp_path):
    """horovodrun --min-np: each failed attempt restarts one worker
    smaller, never below the floor."""
    rc = launch([sys.executable, FLAKY], nprocs=3, max_restarts=3,
                min_nprocs=2, coord_server=False, restart_cooldown=0.01,
                env={"WORKER_OUT_DIR": str(tmp_path),
                     "WORKER_FAIL_SPAWN_IDS": "2@0,1@1"})
    assert rc == 0
    assert _worlds() == [(0, 3), (1, 2), (2, 2)]
    assert {(e["sid"], e["world"]) for e in _events(tmp_path)
            if e["attempt"] == 2} == {("0", 2), ("1", 2)}


def test_discovery_sets_world_size(tmp_path):
    """--host-discovery-script: the command's stdout is the next world
    (4 -> 2 in one restart), clamped to [min_nprocs, nprocs]."""
    rc = launch([sys.executable, FLAKY], nprocs=4, max_restarts=1,
                min_nprocs=2, coord_server=False,
                discover_cmd=f'"{sys.executable}" -c "print(2)"',
                env={"WORKER_OUT_DIR": str(tmp_path),
                     "WORKER_FAIL_SPAWN_IDS": "3"})
    assert rc == 0
    assert _worlds() == [(0, 4), (1, 2)]
    assert {(e["sid"], e["world"]) for e in _events(tmp_path)
            if e["attempt"] == 1} == {("0", 2), ("1", 2)}


def test_elastic_inprocess_succeeds_with_min_nprocs_survivors(tmp_path):
    """In-process elastic: a dying worker does not tear the gang down; the
    attempt succeeds when at least min_nprocs workers exit 0."""
    rc = launch([sys.executable, FLAKY], nprocs=3, min_nprocs=2,
                elastic_inprocess=True, coord_server=False,
                env={"WORKER_OUT_DIR": str(tmp_path),
                     "WORKER_FAIL_SPAWN_IDS": "1"})
    assert rc == 0
    rc = launch([sys.executable, FLAKY], nprocs=3, min_nprocs=2,
                elastic_inprocess=True, coord_server=False,
                env={"WORKER_OUT_DIR": str(tmp_path),
                     "WORKER_FAIL_SPAWN_IDS": "1,2"})
    assert rc == 3


_ENV_DUMP = (
    "import json, os, sys\n"
    "keys = [k for k in os.environ if k.startswith('TPUDIST_') or k in "
    "('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')]\n"
    "with open(os.path.join(os.environ['OUT'], "
    "os.environ['TPUDIST_PROCESS_ID'] + '.json'), 'w') as fh:\n"
    "    json.dump({k: os.environ[k] for k in keys}, fh)\n")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_worker_environment(tmp_path, monkeypatch, device):
    """tpudist's TPUDIST_* names, TPUDIST_DEVICE, the store's address;
    torchrun's process-group variables neither exported nor inherited."""
    for k, v in (("RANK", "5"), ("WORLD_SIZE", "8"), ("MASTER_ADDR", "x"),
                 ("MASTER_PORT", "1"), ("LOCAL_RANK", "5")):
        monkeypatch.setenv(k, v)
    rc = launch([sys.executable, "-c", _ENV_DUMP], nprocs=2, device=device,
                env={"OUT": str(tmp_path)})
    assert rc == 0
    for rank in (0, 1):
        env = json.loads((tmp_path / f"{rank}.json").read_text())
        assert not {"RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"} & set(env)
        assert env["TPUDIST_DEVICE"] == device
        assert env["TPUDIST_NUM_PROCESSES"] == "2"
        assert env["TPUDIST_PROCESS_ID"] == env["TPUDIST_LOCAL_RANK"] \
            == env["TPUDIST_SPAWN_ID"] == str(rank)
        assert env["TPUDIST_RESTART_ATTEMPT"] == "0"
        assert env["TPUDIST_COORD_ADDR"].startswith("127.0.0.1:")
        assert env["TPUDIST_COORDINATOR"].startswith("127.0.0.1:")


def test_deadline_kills_the_gang():
    with pytest.raises(TimeoutError, match="deadline"):
        launch([sys.executable, "-c", "import time; time.sleep(60)"],
               nprocs=2, coord_server=False, timeout_s=1.0)


def test_min_nprocs_above_nprocs_rejected():
    with pytest.raises(ValueError, match="must not exceed"):
        launch([sys.executable, FLAKY], nprocs=2, min_nprocs=4)


def test_unknown_device_rejected():
    with pytest.raises(ValueError, match="device"):
        launch([sys.executable, FLAKY], nprocs=1, device="tpu")


@pytest.mark.parametrize("value", ["1:2:3", "abc", "-1", "5:-2"])
def test_malformed_restart_cooldown_rejected(value, capsys):
    with pytest.raises(SystemExit):
        launch_mod.main(["-n", "1", "--restart-cooldown", value, "--",
                         FLAKY])
    assert "--restart-cooldown" in capsys.readouterr().err


def test_cli_runs_a_gang(tmp_path, monkeypatch):
    """``python -m tpudist_torch.runtime.launch -n 2 --device cpu --
    worker.py``: the script runs under this interpreter, the gang's code
    is returned."""
    monkeypatch.setenv("WORKER_OUT_DIR", str(tmp_path))
    monkeypatch.setenv("WORKER_FAIL_SPAWN_IDS", "")
    assert launch_mod.main(["-n", "2", "--device", "cpu", "--no-coord",
                            "--", FLAKY]) == 0
    assert {e["sid"] for e in _events(tmp_path)} == {"0", "1"}
