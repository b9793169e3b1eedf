"""tpudist_torch.sim — trace-replay load harness + offline fleet simulator
(counterpart of :mod:`tpudist.sim`).

Scenario diversity as a regression suite (see docs/OBSERVABILITY.md):

* :mod:`tpudist_torch.sim.scenario` — declarative :class:`ScenarioSpec`\\ s
  (arrival process, prompt/budget/deadline distributions, tenant mix,
  fleet + autoscaler policy) with per-scenario SLO
  :class:`Envelope`\\ s, plus the named ``BUILTIN`` matrix CI runs.
* :mod:`tpudist_torch.sim.workload` — :func:`synthesize` draws a
  deterministic timed workload from a spec;
  :func:`workload_from_trace` reconstructs one from a recorded
  ``tpudist.events/1`` document, so an incident replays as a scenario.
* :mod:`tpudist_torch.sim.simulator` — :class:`FleetSim` runs the REAL
  router + autoscaler code against a virtual clock and simulated
  replicas, emitting the same decision counters and bench-JSONL
  summary schema as a live run, orders of magnitude faster.
* :mod:`tpudist_torch.sim.envelope` — the shared envelope checker the CI
  scenario-matrix job gates on (``python -m tpudist_torch.sim.envelope``).

``python -m tpudist_torch.sim --all --check`` runs the builtin matrix
offline and exits nonzero on any envelope violation.
"""

from tpudist_torch.sim.scenario import (
    BUILTIN,
    Envelope,
    ScenarioSpec,
    builtin,
)
from tpudist_torch.sim.workload import (
    WorkItem,
    Workload,
    service_rates_from_trace,
    synthesize,
    workload_from_trace,
)

__all__ = [
    "BUILTIN",
    "Envelope",
    "FleetSim",
    "ScenarioSpec",
    "SimFabric",
    "SimReplica",
    "VirtualClock",
    "WorkItem",
    "Workload",
    "builtin",
    "service_rates_from_trace",
    "synthesize",
    "workload_from_trace",
]


def __getattr__(name):
    # FleetSim pulls in the runtime stack (router/autoscaler -> torch);
    # keep `import tpudist_torch.sim` light so the envelope checker and spec
    # parsing work in minimal CI environments
    if name in ("FleetSim", "SimReplica", "VirtualClock"):
        from tpudist_torch.sim import simulator
        return getattr(simulator, name)
    if name == "SimFabric":
        from tpudist_torch.sim.fabric import SimFabric
        return SimFabric
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
