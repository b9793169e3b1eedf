"""The port's fault-injection harness (``tpudist_torch.runtime.faults``)
against tpudist's: ``FaultPlan.from_env`` gives the same fields and raises
the same errors over a table of environments, the probabilistic
injections replay the same schedule from a seed, the hooks of both
behave alike, and the kill hooks SIGKILL a subprocess as tpudist's do."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from tpudist_torch.runtime import faults
from tpudist_torch.runtime.faults import FaultInjected, FaultPlan

ROOT = Path(__file__).resolve().parent.parent
P = "TPUDIST_FAULT_"

# every knob at least once, the defaults, and each kind of bad value
ENVS = {
    "empty": {},
    "coord": {P + "COORD_ERROR_P": "0.25", P + "COORD_DELAY_P": "0.5",
              P + "COORD_DELAY_S": "0.01", P + "SEED": "42"},
    "heartbeat": {P + "HEARTBEAT_STOP_AFTER_S": "3.5",
                  P + "HEARTBEAT_DELAY_S": "1.5"},
    "serve": {P + "KILL_AFTER_SEGMENTS": "7", P + "PUBLISH_DROP": "2.5",
              P + "KILL_AT_WARMUP": "1", P + "CANARY_CORRUPT": "1",
              P + "AUTOSCALE_POLL_DELAY_S": "0.25"},
    "router": {P + "ROUTER_KILL_AFTER_POLLS": "25",
               P + "COORD_OUTAGE_AT_S": "3.0", P + "COORD_OUTAGE_S": "2.5"},
    "outage_default_length": {P + "COORD_OUTAGE_AT_S": "1.0"},
    "integrity": {P + "FLIP_WIRE_BITS": "3:2", P + "NAN_AFTER_TOKENS": "0",
                  P + "PROBE_FAIL": "2"},
    "flip_forever": {P + "FLIP_WIRE_BITS": "5"},
    "handoff": {P + "HANDOFF_DROP": "1", P + "KILL_AT_HANDOFF": "2",
                P + "MIGRATE_DROP": "3", P + "KILL_AT_MIGRATE": "4"},
    "collective": {P + "COLL_KILL_PHASE": "hier_cross",
                   P + "COLL_KILL_RANK": "3"},
    "blank_values_are_unset": {P + "COORD_ERROR_P": " ",
                               P + "KILL_AFTER_SEGMENTS": ""},
    "bad_probability": {P + "COORD_ERROR_P": "1.5"},
    "bad_delay_probability": {P + "COORD_DELAY_P": "-0.1"},
    "bad_router_polls": {P + "ROUTER_KILL_AFTER_POLLS": "0"},
    "bad_outage_length": {P + "COORD_OUTAGE_AT_S": "1.0",
                          P + "COORD_OUTAGE_S": "0"},
    "bad_flip_spec": {P + "FLIP_WIRE_BITS": "1:x"},
    "bad_flip_count": {P + "FLIP_WIRE_BITS": "2:0"},
    "bad_nan_after": {P + "NAN_AFTER_TOKENS": "-1"},
    "bad_probe_fail": {P + "PROBE_FAIL": "0"},
    "bad_handoff_drop": {P + "HANDOFF_DROP": "0"},
    "bad_kill_at_handoff": {P + "KILL_AT_HANDOFF": "0"},
    "bad_migrate_drop": {P + "MIGRATE_DROP": "0"},
    "bad_kill_at_migrate": {P + "KILL_AT_MIGRATE": "0"},
    "bad_coll_phase": {P + "COLL_KILL_PHASE": "hier_middle"},
    "not_a_number": {P + "COORD_DELAY_S": "abc"},
}


@pytest.fixture(autouse=True)
def _clean_plan():
    faults.reset()
    yield
    faults.reset()


def _ref():
    from tpudist.runtime import faults as ref_faults

    return ref_faults


def _fields(plan) -> dict:
    """A plan's parsed state (its RNG, lock and birth time aside)."""
    return {k: v for k, v in vars(plan).items()
            if k not in ("_rng", "_lock", "_born")}


def _parse(mod, env):
    try:
        return "ok", _fields(mod.FaultPlan.from_env(env))
    except Exception as e:  # noqa: BLE001 - the error is the result
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_from_env_matches_tpudist(name):
    got = _parse(faults, ENVS[name])
    assert got == _parse(_ref(), ENVS[name])
    assert (got[0] == "ok") == (not name.startswith(("bad_", "not_")))


def test_injection_schedule_replays_tpudist_from_a_seed():
    """The probabilistic knobs draw from one seeded ``random.Random``: the
    port's error/delay schedule is tpudist's for the same seed."""
    ref = _ref()

    def schedule(mod, seed):
        plan = mod.FaultPlan(coord_error_p=0.3, coord_delay_p=0.2,
                             coord_delay_s=0.0, seed=seed)
        out = []
        for _ in range(64):
            try:
                plan.coord_op("get")
                out.append(0)
            except mod.FaultInjected:
                out.append(1)
        return out, dict(plan.injected)

    for seed in (0, 7):
        assert schedule(faults, seed) == schedule(ref, seed)
    assert schedule(faults, 7) != schedule(faults, 8)


def test_hooks_behave_as_tpudist():
    """One plan with every non-fatal knob armed, driven through the same
    call sequence in both packages: the same returns, the same tallies."""
    ref = _ref()

    def drive(mod):
        plan = mod.FaultPlan(flip_wire_bits="2:2", nan_after_tokens=3,
                             probe_fail=1, handoff_drop=1, migrate_drop=2,
                             heartbeat_delay_s=1e6, canary_corrupt=True)
        out = [plan.flip_wire_bits(bytes(16)) for _ in range(6)]
        out += [plan.poison_logits(n) for n in range(5)]
        out += [plan.corrupt_probe("probe-a") for _ in range(2)]
        out += [plan.drop_handoff() for _ in range(2)]
        out += [plan.drop_migrate() for _ in range(3)]
        out += [plan.drop_heartbeat(), plan.corrupt_canary("canary-1"),
                plan.corrupt_canary("req-1"), plan.drop_publish()]
        return out, dict(plan.injected), plan.active

    assert drive(faults) == drive(ref)


def test_module_plan_reads_env_once(monkeypatch):
    monkeypatch.setenv(P + "COORD_ERROR_P", "1.0")
    faults.reset()
    assert faults.plan().coord_error_p == 1.0
    with pytest.raises(FaultInjected):
        faults.coord_op("get")
    monkeypatch.delenv(P + "COORD_ERROR_P")
    assert faults.plan().coord_error_p == 1.0   # cached until reset
    faults.reset()
    assert faults.plan().coord_error_p == 0.0


def test_module_hooks_inert_by_default():
    faults.reset()
    faults.coord_op("get")
    assert not faults.drop_heartbeat()
    assert not faults.drop_publish()
    faults.on_segment()
    faults.on_warmup()
    faults.on_coll_phase("hier_intra", 0)
    assert not faults.corrupt_canary("canary-9")
    assert faults.flip_wire_bits(b"abc") == b"abc"
    assert all(n == 0 for n in faults.plan().injected.values())


def test_coll_kill_raise_fires_on_its_rank_only():
    plan = FaultPlan(coll_kill_phase="hier_cross", coll_kill_rank=3,
                     coll_kill_raise=True)
    plan.on_coll_phase("hier_cross", 2)
    plan.on_coll_phase("hier_intra", 3)
    with pytest.raises(FaultInjected):
        plan.on_coll_phase("hier_cross", 3)
    assert plan.injected["coll_kill"] == 1


@pytest.mark.parametrize("knob,hook", [
    ("KILL_AFTER_SEGMENTS", "on_segment"),
    ("ROUTER_KILL_AFTER_POLLS", "on_router_poll"),
])
def test_kill_hooks_sigkill_a_subprocess(knob, hook):
    """The Kth call SIGKILLs the process: no cleanup, nothing after it."""
    script = (
        "from tpudist_torch.runtime import faults\n"
        "for i in range(6):\n"
        "    print(f'call{i}', flush=True)\n"
        f"    faults.{hook}()\n"
        "print('survived', flush=True)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), **{P + knob: "3"})
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == -signal.SIGKILL
    assert "call2" in res.stdout and "call3" not in res.stdout
    assert "survived" not in res.stdout
