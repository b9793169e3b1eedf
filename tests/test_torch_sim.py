"""tpudist_torch.sim against tpudist.sim: the offline fleet simulator,
its scenarios, workloads, fabric, envelope checker and CLI.

* Parity, one case per builtin scenario: the same spec through both
  packages' ``FleetSim`` gives rows equal in every field but the two
  real-clock ones (``sim_wall_s``, ``speedup``), equal autoscaler
  decision logs and action sequences, the same counters moved (by name)
  and the same fired alerts (a row field of the rows); ``synthesize``
  draws the same items.  ``diurnal_ramp`` and ``replica_death_storm``
  (25 of the matrix's 45 s on one core) run with ``duration_s`` cut by
  one ``dataclasses.replace`` applied to both sides (``CUT``); their
  full-length runs are chip_smoke's ``sim`` phase.
* Replay: the port's ``FleetSim.from_trace`` of the recorded live run
  (``tests/data/sim_replay_fixture.json``) reproduces the fixture's
  decisions and tpudist's replay of it; a ``tpudist.events/1`` document
  recorded by the port's router and ServeLoop on the CPU reads as the
  same workload and service rates in both packages.
* The port's own behaviour that the parity does not reach: spec, fault
  and envelope validation, envelope bounds, the checker, fabric outages,
  the CLIs' exit codes, a torch-free ``import tpudist_torch.sim``, and
  tenant prefixes that do not depend on Python's per-process string
  hashing (tpudist's do: ROADMAP Queue C).
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from tpudist_torch.sim import envelope as tenv
from tpudist_torch.sim.scenario import (
    BUILTIN,
    Envelope,
    ScenarioSpec,
    builtin,
    names,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "sim_replay_fixture.json")
REAL_CLOCK = ("sim_wall_s", "speedup")
# virtual seconds of the two long builtins in the parity cases (90 and 45
# at full length): diurnal_ramp still climbs to its peak (scale-ups),
# replica_death_storm still loses both replicas and buys one back
CUT = {"diurnal_ramp": 30.0, "replica_death_storm": 15.0}
# the parity runs in two processes: these builtins in the first, the rest
# in the second, so that the two take about as long
FIRST_HALF = {"cold_prefix_tenants", "deadline_storm", "disagg_mixed_prompts",
              "long_tail_prompts", "steady_state"}


@pytest.fixture(autouse=True)
def _quiet_fleet_logs():
    # the routers and autoscalers log every decision at INFO
    logging.disable(logging.INFO)
    yield
    logging.disable(logging.NOTSET)


def _specs(name):
    from tpudist.sim.scenario import builtin as jax_builtin

    port, ref = builtin(name), jax_builtin(name)
    if name in CUT:
        port = dataclasses.replace(port, duration_s=CUT[name])
        ref = dataclasses.replace(ref, duration_s=CUT[name])
    return port, ref


def _run(simulator, sim):
    """One run: what the parity compares, including the counters it
    moved (by name)."""
    before = simulator._counters_now(sim.ns)
    row = sim.run()
    after = simulator._counters_now(sim.ns)
    return {"row": row,
            "moved": sorted(k for k in after
                            if after[k] != before.get(k, 0.0)),
            "decision_logs": [s.decision_log for s in sim.scalers],
            "action_seqs": [s.action_seq() for s in sim.scalers],
            "fired": sorted(sim.alerts.fired_names)}


def _parity_main(out_path: str, half: int) -> None:
    """Both packages' FleetSim over one half of the builtins
    (``FIRST_HALF`` or the rest; the first also over the recorded live
    run), in this (fresh) process; the results pickled to
    ``out_path``."""
    import pickle

    from tpudist.sim import simulator as jsim
    from tpudist.sim.workload import synthesize as jax_synthesize
    from tpudist_torch.sim import simulator as tsim
    from tpudist_torch.sim.workload import synthesize

    logging.disable(logging.INFO)
    out = {}
    for name in names():
        if (name in FIRST_HALF) != (half == 0):
            continue
        port_spec, ref_spec = _specs(name)
        out[name] = {
            "items": [[dataclasses.astuple(w) for w in fn(spec).items]
                      for fn, spec in ((synthesize, port_spec),
                                       (jax_synthesize, ref_spec))],
            "ref": _run(jsim, jsim.FleetSim(ref_spec)),
            "port": _run(tsim, tsim.FleetSim(port_spec))}
    if half == 0:
        with open(FIXTURE) as f:
            fx = json.load(f)
        kw = dict(autoscale=fx["autoscale"], replicas=1)
        out["fixture"] = {
            "ref": _run(jsim, jsim.FleetSim.from_trace(fx["events"], **kw)),
            "port": _run(tsim, tsim.FleetSim.from_trace(fx["events"],
                                                        **kw))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """:func:`_parity_main` in two processes of their own, one a half,
    started together: the default alert rules also read the process's
    registry (queue-wait histograms, ``serve/degraded``), which other
    test files on this worker may have left populated."""
    import pickle

    tmp = tmp_path_factory.mktemp("parity")
    code = ("import sys; from tests import test_torch_sim as t; "
            "t._parity_main(sys.argv[1], int(sys.argv[2]))")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / f"{half}.pkl"), str(half)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env) for half in (0, 1)]
    out = {}
    for half, p in enumerate(procs):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
        with open(tmp / f"{half}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


def _hold(port, ref):
    row, ref_row = port["row"], ref["row"]
    assert set(row) == set(ref_row)
    diff = {k: (row[k], ref_row[k]) for k in row
            if k not in REAL_CLOCK and row[k] != ref_row[k]}
    assert not diff
    # a counter the port names otherwise would read 0 in the row: the
    # same counters must move, by name
    assert port["moved"] == ref["moved"]
    assert port["decision_logs"] == ref["decision_logs"]
    assert port["action_seqs"] == ref["action_seqs"]
    assert row["alerts_fired"] == port["fired"]


@pytest.mark.parametrize("name", names())
def test_builtin_matches_tpudist(name, parity):
    got = parity[name]
    assert got["items"][0] == got["items"][1]
    _hold(got["port"], got["ref"])
    if name not in CUT:
        assert got["port"]["row"]["envelope_ok"], \
            got["port"]["row"]["violations"]


def test_fixture_replay_matches_live_and_tpudist(parity):
    """The replay of the recorded live run scales up as the live run did
    (the same count, the first scale-up within one poll of the breach),
    and as tpudist's replay does."""
    from tpudist_torch.sim import service_rates_from_trace
    from tpudist_torch.sim.simulator import decision_match

    with open(FIXTURE) as f:
        fx = json.load(f)
    assert fx["schema"] == "tpudist.sim_replay_fixture/1"
    port = parity["fixture"]["port"]
    assert port["row"]["lost_requests"] == 0
    (log,), (acts,) = port["decision_logs"], port["action_seqs"]
    match = decision_match(fx["decision_log"], fx["action_seq"], log, acts,
                           fx["autoscale"]["target_wait_s"])
    assert match["decision_match"] and match["live_ups"] >= 1, match
    _hold(port, parity["fixture"]["ref"])
    rates = service_rates_from_trace(fx["events"])
    assert "r0" in rates and 0.0 < rates["r0"] < 1.0


def test_port_recorded_trace_reads_alike():
    """A document the port records (the router's enqueue events, the
    ServeLoop's segment events with their spt stamps) is one workload and
    one set of service rates to both packages."""
    import torch

    from tpudist.sim.workload import (
        service_rates_from_trace as jax_rates,
        workload_from_trace as jax_workload,
    )
    from tpudist_torch import obs
    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.runtime.router import Router, build_tiny_lm
    from tpudist_torch.sim.workload import (
        service_rates_from_trace,
        workload_from_trace,
    )

    cfg, sd = build_tiny_lm(64, 1, 2, 1, 32, 64, 0)
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(1, 64, 3 + i).astype(np.int32), 6,
                    rid=f"q{i}") for i in range(4)]
    obs.events.clear()
    router = Router(None, use_health=False, quarantine=False)
    entries = {f"k{i}": {"req": r, "arrived": False, "at": 0.0}
               for i, r in enumerate(reqs)}
    assert router._arrive(entries, router._clock()) == len(reqs)
    for e in entries.values():
        e["req"].trace = e["trace"]
    loop = ServeLoop(cfg, sd, num_slots=2, steps_per_sync=2,
                     prefill_chunk=8, device="cpu")
    with torch.no_grad():
        loop.run(reqs)
    doc = obs.events.snapshot()
    obs.events.clear()
    assert sum(e["kind"] == "segment" and e.get("spt") is not None
               for e in doc["events"]) > 0
    got, want = workload_from_trace(doc), jax_workload(doc)
    assert [dataclasses.astuple(w) for w in got.items] \
        == [dataclasses.astuple(w) for w in want.items]
    assert len(got) == len(reqs)
    assert service_rates_from_trace(doc) == jax_rates(doc)


# ---- the port's own behaviour ----------------------------------------------

def _spec(**over) -> ScenarioSpec:
    base = {"name": "t", "duration_s": 5.0,
            "arrival": {"kind": "constant", "rate": 10.0}}
    base.update(over)
    return ScenarioSpec.from_dict(base)


BAD_SPECS = {
    "top_level_key": ({"rate_limit": 5}, "unknown keys.*'rate_limit'"),
    "fleet_key": ({"fleet": {"replica": 2}}, "unknown keys.*'replica'"),
    "arrival_kind": ({"arrival": {"kind": "bursty", "rate": 1.0}},
                     "not in"),
    "arrival_rate": ({"arrival": {"kind": "constant", "rate": 0.0}},
                     "rate > 0"),
    "diurnal": ({"arrival": {"kind": "diurnal", "base_rate": 9.0,
                             "peak_rate": 3.0, "period_s": 60.0}},
                "base_rate <= peak_rate"),
    "flash_crowd": ({"arrival": {"kind": "flash_crowd", "base_rate": 5.0,
                                 "spike_rate": 5.0, "spike_width_s": 2.0}},
                    "spike_rate > base_rate"),
    "longtail": ({"prompt": {"kind": "longtail", "lo": 4, "typical": 512,
                             "tail": 16}}, "lo <= typical < tail"),
    "deadline": ({"deadline": {"kind": "adversarial", "tight_frac": 0.2,
                               "tight_s": 10.0, "loose_s": 1.0}},
                 "tight_s < loose_s"),
    "tenant_keys": ({"tenants": [{"name": "a"}]}, "missing required keys"),
    "tenant_weight": ({"tenants": [{"name": "a", "weight": 0.0}]},
                      "weight > 0"),
    "preempt": ({"fleet": {"preempt": "pause"}}, "fleet.preempt"),
    "disagg": ({"fleet": {"decode_replicas": 1}}, "prefill_replicas"),
    "fault_kind": ({"faults": [{"kind": "meteor"}]}, "not in"),
    "fault_keys": ({"faults": [{"kind": "kill_replica", "at_s": 1.0}]},
                   "missing required keys"),
    "fault_extra": ({"faults": [{"kind": "kill_replica", "at_s": 1.0,
                                 "rid": "r0", "for_s": 2.0}]},
                    "unknown keys"),
    "brownout": ({"faults": [{"kind": "coord_brownout", "at_s": 1.0,
                              "for_s": 0.0}]}, "for_s > 0"),
    "kill_router": ({"faults": [{"kind": "kill_router", "at_poll": 0}]},
                    "at_poll >= 1"),
    "two_router_kills": ({"faults": [{"kind": "kill_router", "at_poll": 5},
                                     {"kind": "kill_router", "at_poll": 9}]},
                         "at most one kill_router"),
    "corrupt_every": ({"faults": [{"kind": "corrupt_replica", "at_s": 1.0,
                                   "rid": "r1", "every": 0}]},
                      "every >= 1"),
    "corrupt_count": ({"faults": [{"kind": "corrupt_replica", "at_s": 1.0,
                                   "rid": "r1", "count": 0}]},
                      "count must be >= 1"),
    "envelope_key": ({"envelope": {"max_p99": 1.0}}, "unknown keys"),
    "envelope_bound": ({"envelope": {"decisions": {"shed": {"atmost": 3}}}},
                       "unknown keys"),
    "envelope_alerts": ({"envelope": {"alerts": {"must_not_fire": "x"}}},
                        "wildcard"),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_bad_spec_rejected(case):
    over, match = BAD_SPECS[case]
    with pytest.raises(ValueError, match=match):
        _spec(**over)


@pytest.mark.parametrize("case", ["required_keys", "unknown_builtin",
                                  "round_trip", "from_json", "defaults"])
def test_spec_surface(case, tmp_path):
    if case == "required_keys":
        with pytest.raises(ValueError, match="missing required keys"):
            ScenarioSpec.from_dict({"name": "t", "duration_s": 1.0})
    elif case == "unknown_builtin":
        with pytest.raises(KeyError, match="unknown scenario"):
            builtin("nope")
    elif case == "round_trip":
        for name in names():
            assert ScenarioSpec.from_dict(builtin(name).to_dict()) \
                == builtin(name)
    elif case == "from_json":
        path = tmp_path / "s.json"
        path.write_text(json.dumps({"name": "file-spec", "duration_s": 2.0,
                                    "arrival": {"kind": "constant",
                                                "rate": 3.0}}))
        assert ScenarioSpec.from_json(str(path)).name == "file-spec"
    else:
        spec = _spec(fleet={"replicas": 3})
        assert spec.fleet["replicas"] == 3
        assert spec.fleet["warmup_s"] == pytest.approx(2.0)
        assert spec.deadline == {"kind": "none"}


ENVELOPE_CASES = {
    "clean": ({"max_lost": 0, "max_p99_queue_wait_s": 1.0,
               "min_scale_ups": 1,
               "decisions": {"failed": {"max": 0},
                             "completed": {"min": 10}}},
              {"lost_requests": 0, "p99_queue_wait_s": 0.2, "scale_ups": 2,
               "decisions_failed": 0, "decisions_completed": 50}, []),
    "every_bound": ({"max_lost": 0, "max_p99_queue_wait_s": 0.5,
                     "max_recovery_s": 10.0, "min_scale_ups": 1,
                     "max_priority_bad": 0,
                     "decisions": {"completed": {"min": 100},
                                   "failed": {"max": 0}}},
                    {"lost_requests": 2, "p99_queue_wait_s": 3.0,
                     "recovery_s": 60.0, "scale_ups": 0, "priority_bad": 4,
                     "decisions_completed": 10, "decisions_failed": 1},
                    ["lost_requests", "p99_queue_wait_s", "recovery_s",
                     "scale_ups", "priority_bad", "decisions_completed",
                     "decisions_failed"]),
    "missing_fields": ({"min_scale_ups": 1, "max_p99_queue_wait_s": 1.0},
                       {}, ["scale_ups"]),
    "chaos": ({"max_burn_rate_300s": 2.0, "max_replica_deaths": 1,
               "min_router_recoveries": 1, "min_quarantines": 1,
               "max_corrupted_terminals": 0},
              {"burn_rate_300s": 9.0, "replica_deaths": 3,
               "router_recoveries": 0, "quarantines": 0,
               "corrupted_terminals": 1},
              ["burn_rate_300s", "replica_deaths", "router_recoveries",
               "quarantines", "corrupted_terminals"]),
    "hit_rates_unreported": ({"min_prefix_hit_rate": 0.5,
                              "min_global_hit_rate": 0.8},
                             {"prefix_hit_rate": None}, []),
    "pools_and_preemption": ({"min_scale_ups_prefill": 1,
                              "max_p99_ttft_s": 1.0, "min_preemptions": 2,
                              "max_p99_priority_wait_s": 0.5},
                             {"p99_ttft_s": 2.0, "preemptions": 1,
                              "p99_priority_wait_s": 0.7},
                             ["p99_ttft_s", "p99_priority_wait_s",
                              "preemptions", "scale_ups_prefill"]),
    "alerts": ({"alerts": {"must_fire": ["CoordOutage"],
                           "must_not_fire": "*"}},
               {"alerts_fired": ["ReplicaLost"]},
               ["CoordOutage did not fire", "unexpected alerts"]),
    "alerts_absent": ({"alerts": {"must_fire": []}}, {},
                      ["no alerts_fired"]),
}


@pytest.mark.parametrize("case", sorted(ENVELOPE_CASES))
def test_envelope_bounds(case):
    env, row, want = ENVELOPE_CASES[case]
    bad = Envelope.from_dict(env).check(row)
    assert len(bad) == len(want), bad
    for b, w in zip(bad, want):
        assert w in b


def _passing_row(name: str) -> dict:
    env = builtin(name).envelope
    return {"metric": f"scenario/{name}", "scenario": name,
            "lost_requests": 0, "p99_queue_wait_s": 0.05, "recovery_s": 5.0,
            "scale_ups": env.min_scale_ups, "drains": env.min_drains,
            "scale_ups_prefill": env.min_scale_ups_prefill,
            "scale_ups_decode": env.min_scale_ups_decode,
            "p99_ttft_s": 0.05, "priority_bad": 0, "replica_deaths": 0,
            "preemptions": env.min_preemptions,
            "p99_priority_wait_s": 0.05,
            "router_recoveries": env.min_router_recoveries,
            "quarantines": env.min_quarantines,
            "reinstated": env.min_reinstated, "corrupted_terminals": 0,
            "burn_rate_300s": 0.0, "decisions_completed": 500,
            "decisions_failed": 0,
            "alerts_fired": sorted(env.alerts.get("must_fire") or []),
            "envelope_ok": True, "violations": []}


@pytest.mark.parametrize("case", ["recheck_raw_fields", "embedded_verdict",
                                  "full_matrix", "noise_skipped"])
def test_envelope_checker(case, tmp_path):
    if case == "recheck_raw_fields":
        # the emitter says ok, the raw fields say otherwise
        row = _passing_row("steady_state")
        row["lost_requests"] = 3
        bad = tenv.check_row(row)
        assert bad and "lost_requests" in bad[0]
    elif case == "embedded_verdict":
        assert tenv.check_row({"scenario": "custom", "envelope_ok": False,
                               "violations": ["p99 blew up"]}) \
            == ["p99 blew up"]
        assert tenv.check_row({"scenario": "custom",
                               "envelope_ok": True}) == []
    elif case == "full_matrix":
        rows = [_passing_row(n) for n in names()]
        ok, report = tenv.check_rows(rows)
        assert ok, report
        ok, report = tenv.check_rows(rows[:-1])
        assert not ok and any("missing" in line for line in report)
        ok, report = tenv.check_rows(rows[:3], min_scenarios=5,
                                     require_builtin=False)
        assert not ok and any("only 3" in line for line in report)
    else:
        path = tmp_path / "bench.jsonl"
        path.write_text("\n".join([
            "some log line",
            json.dumps({"metric": "serve/throughput", "value": 1.0}),
            json.dumps(_passing_row("steady_state")), "{not json"]) + "\n")
        assert [r["scenario"] for r in tenv.scenario_rows(str(path))] \
            == ["steady_state"]


@pytest.mark.parametrize("case", ["window", "needs_clock", "bad_window",
                                  "virtual_clock"])
def test_fabric_and_clock(case):
    from tpudist_torch.runtime.faults import FaultInjected
    from tpudist_torch.sim import SimFabric, VirtualClock

    vc = VirtualClock(wall_base=500.0)
    if case == "window":
        fab = SimFabric(clock=vc.monotonic)
        fab.add_outage(1.0, 2.0)
        fab.set("k", b"v")
        vc.advance(1.5)
        assert fab.in_outage()
        for op in (lambda: fab.set("k", b"w"), lambda: fab.get("k"),
                   lambda: fab.keys(), lambda: fab.delete("k"),
                   lambda: fab.add("c", 1), lambda: fab.live()):
            with pytest.raises(FaultInjected):
                op()
        fab.up("ns:r0")            # leases are server-side: outage-exempt
        fab.down("ns:r0")
        vc.advance(1.0)
        assert fab.get("k") == b"v"
        assert fab.clone() is fab
    elif case == "needs_clock":
        with pytest.raises(ValueError, match="needs a clock"):
            SimFabric().add_outage(0.0, 1.0)
    elif case == "bad_window":
        with pytest.raises(ValueError, match="bad outage window"):
            SimFabric(clock=vc.monotonic).add_outage(2.0, 1.0)
    else:
        vc.advance(1.5)
        assert vc.monotonic() == pytest.approx(1.5)
        assert vc.wall() == pytest.approx(501.5)
        with pytest.raises(ValueError):
            vc.advance(-0.1)


@pytest.mark.parametrize("check,want_rc", [(True, 1), (False, 0)])
def test_cli_exit_codes(check, want_rc, tmp_path, capsys):
    """``--check`` turns an envelope violation into rc 1; the written
    JSONL gates through the envelope CLI."""
    from tpudist_torch.sim.__main__ import main as sim_main

    spec = {"name": "cli-bad", "duration_s": 3.0,
            "arrival": {"kind": "constant", "rate": 5.0},
            "max_new": {"kind": "const", "value": 8}, "seed": 32,
            "envelope": {"min_scale_ups": 5}}   # cannot happen
    spath = tmp_path / "spec.json"
    spath.write_text(json.dumps(spec))
    jpath = tmp_path / "rows.jsonl"
    argv = ["--spec", str(spath), "--jsonl", str(jpath)]
    assert sim_main(argv + (["--check"] if check else [])) == want_rc
    out, err = capsys.readouterr()
    row = json.loads(out.strip())
    assert row["metric"] == "scenario/cli-bad" and not row["envelope_ok"]
    assert "envelope VIOLATED" in err
    assert tenv.main([str(jpath), "--min-scenarios", "1",
                      "--no-require-builtin"]) == 1
    with pytest.raises(SystemExit):
        sim_main([])


def _tenant_prompts(runs: list) -> list:
    """The first prompts of cold_prefix_tenants' workload, drawn in one
    process per ``(package, PYTHONHASHSEED)`` run, all started together."""
    procs = []
    for package, hash_seed in runs:
        # the sim modules and what they import, without the package's
        # __init__, which imports every subsystem (the most of this cost)
        code = (f"import sys, types; pkg = types.ModuleType({package!r}); "
                f"pkg.__path__ = [{os.path.join(REPO, package)!r}]; "
                f"sys.modules[{package!r}] = pkg\n"
                f"from {package}.sim.workload import synthesize\n"
                f"from {package}.sim.scenario import builtin\n"
                "reqs, _ = synthesize(builtin('cold_prefix_tenants'))"
                ".requests(0.0)\n"
                "print([r.prompt[:8].tolist() for r in reqs[:12]])\n")
        env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED=hash_seed,
                   JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO))
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def test_tenant_prefixes_do_not_depend_on_string_hashing():
    """The port draws each tenant's shared prefix from the CRC-32 of its
    name: two processes with other string-hash salts draw the same
    prompts.  tpudist mixes in ``hash(name)`` and draws others (ROADMAP
    Queue C 14); its rows do not change, only the prompts."""
    port_1, port_2, ref_1, ref_2 = _tenant_prompts(
        [("tpudist_torch", "1"), ("tpudist_torch", "2"), ("tpudist", "1"),
         ("tpudist", "2")])
    assert port_1 == port_2
    assert ref_1 != ref_2


def test_sim_imports_without_torch():
    """``import tpudist_torch.sim``, spec parsing, synthesis and the
    envelope checker run with torch made unimportable."""
    code = "\n".join([
        "import sys",
        "sys.modules['torch'] = None",
        "import tpudist_torch.sim as sim",
        "from tpudist_torch.sim.envelope import check_rows",
        "spec = sim.builtin('steady_state')",
        "assert len(sim.synthesize(spec)) > 100",
        "ok, report = check_rows([], min_scenarios=0,",
        "                        require_builtin=False)",
        "assert ok, report",
        "print('ok')"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    assert sorted(BUILTIN) == names()
