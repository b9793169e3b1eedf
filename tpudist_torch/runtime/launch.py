"""Multi-process launcher — the torchrun / horovodrun / ``mp.spawn`` twin
(counterpart of :mod:`tpudist.runtime.launch`).

The reference boots its worlds three ways (SURVEY.md §1 L5): ``torchrun``
with c10d rendezvous + restart-on-failure (`mnist_ddp_elastic.py:5-6`),
``horovodrun`` over MPI (`horovod_mnist_elastic.py:108`), and in-process
``torch.multiprocessing.spawn`` (`model_parallel_ResNet50.py:257-260`).  On
TPU pods the platform launches one process per host, so in production none
of this is needed — but the *capability* (spawn an N-process world on one
machine, supervise it, restart the gang on failure) is what makes
multi-process code testable on one host.  ``python -m
tpudist_torch.runtime.launch`` provides it:

* spawns ``-n`` worker processes, each with ``TPUDIST_COORDINATOR`` /
  ``TPUDIST_NUM_PROCESSES`` / ``TPUDIST_PROCESS_ID`` /
  ``TPUDIST_LOCAL_RANK`` / ``TPUDIST_SPAWN_ID`` /
  ``TPUDIST_RESTART_ATTEMPT`` env vars — tpudist's names, so either
  package's workers read them — and ``TPUDIST_DEVICE`` (``cuda`` or
  ``cpu``, the counterpart of tpudist's ``JAX_PLATFORMS``: the device the
  worker's entry points take),
* starts the native coordination service and exports ``TPUDIST_COORD_ADDR``
  so workers can rendezvous / heartbeat through it,
* supervises the gang: if any worker dies, the rest are terminated and the
  whole gang restarts (TorchElastic semantics), up to ``--max-restarts``.

Workers are plain subprocesses (``fork`` + ``exec``: nothing of the
launcher's CUDA state crosses).  The gang does NOT form a process group:
torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_*`` are neither exported
nor inherited, because elastic workers sync over the coordination store
(:mod:`tpudist_torch.runtime.collectives`) and several of them may share
one card, which holds one NCCL rank.  With ``device="cuda"`` worker
``r`` takes card ``r % device_count`` (see
:func:`tpudist_torch.elastic.worker.worker_device`).

tpudist counts restarts, blacklistings and worker failures in its metrics
registry; the port keeps them as plain counters in :data:`counters`.
"""

from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

# process-wide; each also ticks tpudist's obs counter launch/{name}
counters = {"restarts": 0, "blacklisted": 0, "blacklist_recovered": 0,
            "worker_failures": 0}


def _tick(name: str) -> None:
    from tpudist_torch import obs

    counters[name] += 1
    obs.counter(f"launch/{name}").inc()
# the last launch's attempts as the supervisor saw them: the world, the
# spawn ids it scheduled and their exit codes (a healthy worker torn down
# early may not have run far enough to say so itself)
history: list[dict] = []
# torchrun's process-group contract: never handed to a gang (see above)
_PROCESS_GROUP_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                      "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _discover_world_size(discover_cmd: str, current: int, lo: int,
                         hi: int) -> int:
    """Run the discovery command; its stdout (an int) is the next world
    size, clamped to [lo, hi].  Failures keep the current size (a broken
    discovery script must not take the job down)."""
    try:
        out = subprocess.run(
            discover_cmd, shell=True, capture_output=True, text=True,
            timeout=30, check=True,
        ).stdout.strip()
        return min(hi, max(lo, int(out.splitlines()[-1])))
    except Exception as e:  # noqa: BLE001 - discovery is advisory
        stderr = getattr(e, "stderr", None)
        log.warning("discovery command failed (%s)%s; keeping world=%d",
                    e, f": {stderr.strip()}" if stderr else "", current)
        return current


def launch(
    cmd: list[str],
    nprocs: int,
    max_restarts: int = 0,
    env: dict | None = None,
    device: str = "cuda",
    coord_server: bool = True,
    min_nprocs: int | None = None,
    restart_cooldown: tuple[float, float] | float | None = None,
    discover_cmd: str | None = None,
    elastic_inprocess: bool = False,
    blacklist_after: int | None = None,
    blacklist_cooldown: tuple[float, float] | float | None = None,
    timeout_s: float | None = None,
) -> int:
    """Run ``cmd`` as an ``nprocs``-process gang; returns the gang's exit
    code (0 only if every worker of some attempt exited 0).

    ``device`` is exported as ``TPUDIST_DEVICE``: ``"cuda"`` (the
    default) or ``"cpu"``.  ``timeout_s`` bounds the whole launch: past
    it every worker is killed and :class:`TimeoutError` raised (tests
    bound their gangs with it; tpudist's launcher has no such bound).

    Elastic restarts (the ``horovodrun --min-np/--host-discovery-script/
    --blacklist-cooldown-range`` surface, `horovod_mnist_elastic.py:108`):

    * ``min_nprocs`` — after a failed attempt the gang restarts one worker
      SMALLER (a persistently failing member is dropped, Horovod's
      blacklist effect), never below this floor; workers see the new size
      in ``TPUDIST_NUM_PROCESSES`` and rescale via their reset callbacks.
    * ``discover_cmd`` — shell command run before each restart whose stdout
      (an integer) sets the next world size, clamped to
      ``[min_nprocs or 1, nprocs]`` (≙ ``--host-discovery-script``).
    * ``restart_cooldown`` — seconds (or a ``(lo, hi)`` range sampled
      uniformly) to wait before each restart.
    * ``blacklist_after`` — PER-WORKER blacklist (Horovod's actual
      per-host semantics: the SPECIFIC failing host is excluded, healthy
      ones keep their place).  Every spawn slot carries a stable
      ``TPUDIST_SPAWN_ID`` across attempts; a slot whose worker exits
      nonzero in ``blacklist_after`` attempts is excluded from the roster
      and a FRESH spawn id re-grows the world (≙ a replacement host from
      discovery), while healthy slots are never the ones dropped.
    * ``blacklist_cooldown`` — seconds (or ``(lo, hi)`` sampled) until a
      blacklisted slot may rejoin the roster with its failure count reset
      (``--blacklist-cooldown-range``); ``None`` = excluded for the rest
      of this launch.
    * ``elastic_inprocess`` — a dying worker does NOT tear the gang down:
      survivors are expected to detect the loss themselves via coordination-
      service TTL heartbeats and re-rendezvous smaller in-process
      (:func:`tpudist_torch.elastic.worker.run_elastic_worker` — the Horovod
      elastic-driver model, vs. the default torchrun gang-restart model).
      The attempt succeeds when at least ``min_nprocs or 1`` workers exit 0.
    """
    if min_nprocs is not None and min_nprocs > nprocs:
        raise ValueError(
            f"min_nprocs ({min_nprocs}) must not exceed nprocs ({nprocs})")
    if blacklist_after is not None and blacklist_after < 1:
        raise ValueError(
            f"blacklist_after must be >= 1, got {blacklist_after}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    deadline = (None if timeout_s is None
                else time.monotonic() + timeout_s)
    server = None
    watcher = None
    base_env = {k: v for k, v in os.environ.items()
                if k not in _PROCESS_GROUP_ENV}
    # Workers must resolve the same package the launcher runs from, however
    # the launcher itself was put on sys.path (pytest rootdir, pip -e, ...).
    pkg_root = str(Path(__file__).resolve().parents[2])
    base_env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([base_env["PYTHONPATH"]] if base_env.get("PYTHONPATH") else [])
    )
    if env:
        base_env.update(env)
    if coord_server:
        try:
            from tpudist_torch.runtime.coord import CoordServer

            server = CoordServer(0)
            base_env["TPUDIST_COORD_ADDR"] = f"127.0.0.1:{server.port}"
            # the health plane rides the same store the workers publish
            # metrics through: the watcher classifies stragglers/stale
            # ranks so supervision decisions below can cite evidence
            try:
                from tpudist_torch.obs.health import HealthWatcher

                watcher = HealthWatcher(base_env["TPUDIST_COORD_ADDR"])
            except Exception as e:  # noqa: BLE001 - health is advisory
                log.warning("health watcher unavailable (%s); continuing", e)
        except Exception as e:  # noqa: BLE001 - control plane is optional
            log.warning("coordination server unavailable (%s); continuing", e)

    world = nprocs
    floor = max(1, min_nprocs) if min_nprocs else None

    def _sample(cool):
        lo, hi = cool if isinstance(cool, tuple) else (cool,) * 2
        return random.uniform(lo, hi)

    # per-spawn-slot failure ledger (blacklist_after mode): slots carry a
    # stable spawn id across attempts; repeat offenders are excluded and
    # replaced by FRESH ids so healthy workers keep their place
    roster = list(range(nprocs))
    next_sid = nprocs
    history.clear()
    fail_counts: dict[int, int] = {}
    black_until: dict[int, float] = {}
    try:
        for attempt in range(max_restarts + 1):
            if attempt > 0:
                if restart_cooldown is not None:
                    time.sleep(_sample(restart_cooldown))
                if discover_cmd is not None:
                    world = _discover_world_size(
                        discover_cmd, world, floor or 1, nprocs)
                elif floor is not None and blacklist_after is None:
                    world = max(floor, world - 1)
                _tick("restarts")
                if blacklist_after is not None:
                    now = time.monotonic()
                    for sid, until in list(black_until.items()):
                        if until <= now:   # cooled down: eligible again
                            del black_until[sid]
                            fail_counts.pop(sid, None)
                            # Rejoin AHEAD of synthetic replacement slots
                            # (sids >= nprocs): the scheduled set is
                            # roster[:world], so a tail append would park
                            # the recovered slot behind the fresh sids
                            # that replaced it — cooled down yet never
                            # scheduled again.  Original slots keep their
                            # relative order; replacements only fill
                            # whatever room is left.
                            insert_at = next(
                                (i for i, s in enumerate(roster)
                                 if s >= nprocs), len(roster))
                            roster.insert(insert_at, sid)
                            _tick("blacklist_recovered")
                    for sid in list(roster):
                        if fail_counts.get(sid, 0) >= blacklist_after:
                            black_until[sid] = (
                                now + _sample(blacklist_cooldown)
                                if blacklist_cooldown is not None
                                else float("inf"))
                            roster.remove(sid)
                            _tick("blacklisted")
                            log.warning(
                                "spawn id %d blacklisted after %d failed "
                                "attempts%s%s", sid, fail_counts[sid],
                                "" if blacklist_cooldown is None else
                                f" (cooldown until +{black_until[sid] - now:.1f}s)",
                                f" [{watcher.describe()}]" if watcher else "")
                    while len(roster) < world:
                        roster.append(next_sid)   # fresh replacement slot
                        next_sid += 1
            ids = (roster[:world] if blacklist_after is not None
                   else list(range(world)))
            coordinator = f"127.0.0.1:{_free_port()}"
            procs: list[subprocess.Popen] = []
            for rank in range(world):
                wenv = dict(base_env)
                wenv.update({
                    "TPUDIST_COORDINATOR": coordinator,
                    "TPUDIST_NUM_PROCESSES": str(world),
                    "TPUDIST_PROCESS_ID": str(rank),
                    "TPUDIST_LOCAL_RANK": str(rank),
                    "TPUDIST_SPAWN_ID": str(ids[rank]),
                    "TPUDIST_RESTART_ATTEMPT": str(attempt),
                    "TPUDIST_DEVICE": device,
                })
                procs.append(subprocess.Popen(cmd, env=wenv))
            codes = _supervise(procs, tear_down=not elastic_inprocess,
                               deadline=deadline)
            history.append({"attempt": attempt, "world": world,
                            "spawn_ids": list(ids), "codes": codes})
            if blacklist_after is not None:
                # charge the ACTUAL failers, not supervisor-terminated
                # survivors (they exit -SIGTERM; a straggler escalated to
                # SIGKILL is indistinguishable from a kill -9 death and is
                # charged — acceptable: it failed to exit cleanly)
                for sid, code in zip(ids, codes):
                    if code not in (0, -signal.SIGTERM):
                        fail_counts[sid] = fail_counts.get(sid, 0) + 1
                        _tick("worker_failures")
            if elastic_inprocess:
                if sum(c == 0 for c in codes) >= (floor or 1):
                    return 0
            elif all(c == 0 for c in codes):
                return 0
            log.warning(
                "gang attempt %d failed (exit codes %s)%s%s", attempt, codes,
                "; restarting" if attempt < max_restarts else "",
                f" [{watcher.describe()}]" if watcher else "")
        # Survivors torn down by _supervise exit with the termination
        # signal; report the code of the worker that actually failed.
        failing = [c for c in codes
                   if c not in (0, -signal.SIGTERM, -signal.SIGKILL)]
        return failing[0] if failing else next(c for c in codes if c != 0)
    finally:
        if watcher is not None:
            try:
                watcher.stop()
            except Exception:  # noqa: BLE001 - advisory plane
                pass
        if server is not None:
            server.stop()


def _supervise(procs: list[subprocess.Popen],
               tear_down: bool = True,
               deadline: float | None = None) -> list[int]:
    """Wait for the gang; on first failure, terminate the survivors (the
    torchrun gang-failure contract).  With ``tear_down=False`` a failure
    leaves the survivors running (in-process elastic: they shrink the world
    themselves via TTL rendezvous).  Past ``deadline`` (monotonic) every
    worker is killed and :class:`TimeoutError` raised."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return codes  # type: ignore[return-value]
            if deadline is not None and time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                raise TimeoutError(
                    f"gang still running at its deadline (exit codes "
                    f"{[p.returncode for p in procs]}); killed")
            if tear_down and any(c not in (None, 0) for c in codes):
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                deadline = time.monotonic() + 10
                for p in procs:
                    timeout = max(0.1, deadline - time.monotonic())
                    try:
                        p.wait(timeout=timeout)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                return [p.returncode for p in procs]
            time.sleep(0.05)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p in procs:
            p.wait()
        raise


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpudist_torch.runtime.launch",
        description="Spawn and supervise an N-process tpudist_torch gang on "
                    "this host",
    )
    ap.add_argument("-n", "--nprocs", type=int, required=True)
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="gang restarts on worker failure (torchrun semantics)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="TPUDIST_DEVICE for workers: 'cuda' (worker r on "
                         "card r %% device_count) or 'cpu'")
    ap.add_argument("--min-nprocs", type=int, default=None,
                    help="shrink the gang toward this floor on repeated "
                         "failure (horovodrun --min-np semantics)")
    ap.add_argument("--restart-cooldown", default=None,
                    help="seconds before each restart, or LO:HI range")
    ap.add_argument("--blacklist-after", type=int, default=None,
                    help="exclude a spawn slot after this many failed "
                         "attempts, re-growing the world with a fresh "
                         "slot (per-host blacklist semantics)")
    ap.add_argument("--blacklist-cooldown", default=None,
                    help="seconds (or LO:HI range) until a blacklisted "
                         "slot may rejoin (horovodrun "
                         "--blacklist-cooldown-range); default: excluded "
                         "for the rest of the run")
    ap.add_argument("--discover-cmd", default=None,
                    help="shell command printing the next world size "
                         "(horovodrun --host-discovery-script)")
    ap.add_argument("--no-coord", action="store_true",
                    help="skip the native coordination server")
    ap.add_argument("--elastic-inprocess", action="store_true",
                    help="don't tear the gang down on a worker death; "
                         "survivors shrink via TTL rendezvous "
                         "(tpudist_torch.elastic.worker)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command, e.g. script.py arg1 arg2")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("missing worker command")
    if cmd[0].endswith(".py"):
        cmd = [sys.executable, *cmd]
    def parse_cooldown(value, flag):
        if value is None:
            return None
        try:
            parts = [float(v) for v in str(value).split(":")]
        except ValueError:
            ap.error(f"{flag} must be SECONDS or LO:HI, got {value!r}")
        if len(parts) > 2:
            ap.error(f"{flag} must be SECONDS or LO:HI, got {value!r}")
        if any(p < 0 for p in parts):
            ap.error(f"{flag} values must be non-negative")
        return (parts[0], parts[1]) if len(parts) == 2 else parts[0]

    cooldown = parse_cooldown(args.restart_cooldown, "--restart-cooldown")
    bl_cooldown = parse_cooldown(args.blacklist_cooldown,
                                 "--blacklist-cooldown")
    if args.min_nprocs is not None and args.min_nprocs > args.nprocs:
        ap.error(f"--min-nprocs ({args.min_nprocs}) must not exceed "
                 f"-n ({args.nprocs})")
    return launch(
        cmd, args.nprocs, max_restarts=args.max_restarts,
        device=args.device, coord_server=not args.no_coord, min_nprocs=args.min_nprocs,
        restart_cooldown=cooldown, discover_cmd=args.discover_cmd,
        elastic_inprocess=args.elastic_inprocess,
        blacklist_after=args.blacklist_after,
        blacklist_cooldown=bl_cooldown,
    )


if __name__ == "__main__":
    sys.exit(main())
