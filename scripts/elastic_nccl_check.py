"""Elastic training's process-group data plane across cards: the kill-9
gang one worker a card over NCCL, held against the same gang on the
store-backed plane, and the DDP MLP's gradient allreduce timed on the
group.

    python scripts/elastic_nccl_check.py                     # 4 cards, NCCL
    python scripts/elastic_nccl_check.py --device cpu        # gloo rehearsal

The gang is ``tests/workers/torch_ttl_elastic_worker.py`` (MLP(1, 32),
SGD 0.1, 30 steps, a commit every 5, global batch 12) started by the
port's launcher: ``--workers`` workers, worker ``r`` on card ``r``;
spawn ``--kill-spawn`` SIGKILLs itself after step 13.  On the ici plane
(``WORKER_DATA_PLANE=ici``) every round forms a process group (NCCL on
cards, gloo on the CPU) and the survivors must re-form one at world
``workers - 1``, resume at batch 10, rescale the lr once to
``0.1 · (workers - 1) / workers``, end bitwise equal among themselves
(their last durable commits), have counted calls on each round's group
and carried one allreduce a round (the root election's score) on the
store.  The same gang on the host plane (an f32 wire) must end within
ELASTIC_RTOL of each parameter tensor's largest magnitude.  Detection and
recovery seconds come from the workers' event times.

Then ``--workers`` processes (one a card) form one group through
``IciDataPlane`` and time ``allreduce_mean`` of the DDP MLP's gradient
(``MLP(5, 1024)``: 6,062,090 f32, 24.25 MB), at the full world and again
with one process fewer, beside nothing: chip_smoke's ``host_collectives``
times the store plane on the same tree.  The script prints the card's
name and power limit, one JSON line, and exits non-zero when a check
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

WORKER = os.path.join(ROOT, "tests", "workers", "torch_ttl_elastic_worker.py")
ELASTIC_RTOL = 1e-4
GANG_TIMEOUT_S = 300
ALLREDUCE_WARMUP, ALLREDUCE_REPS = 3, 10
ALLREDUCE_TIMEOUT_S = 300


def _jsonl(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _check(cond: bool, msg: str, failures: list) -> None:
    if not cond:
        failures.append(msg)
        print(f"elastic_nccl_check: FAILED: {msg}", file=sys.stderr,
              flush=True)


def _last_params(ckpt: str, sid: int) -> dict:
    import numpy as np

    from tpudist_torch.elastic.checkpoint import latest_step

    d = f"{ckpt}/w{sid}"
    with np.load(f"{d}/step_{latest_step(d)}/state.npz") as z:
        return {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}


def gang(args, plane: str, tmp: str, failures: list) -> dict:
    """One kill-9 gang on ``plane``; its checks, times and parameters."""
    import numpy as np

    from tpudist_torch.runtime.launch import launch

    out, ckpt = f"{tmp}/{plane}/events", f"{tmp}/{plane}/ckpt"
    os.makedirs(out)
    n, victim = args.workers, args.kill_spawn
    t0 = time.perf_counter()
    rc = launch([sys.executable, WORKER], nprocs=n, min_nprocs=n - 1,
                elastic_inprocess=True, device=args.device,
                timeout_s=GANG_TIMEOUT_S,
                env={"WORKER_OUT_DIR": out, "WORKER_CKPT_DIR": ckpt,
                     "WORKER_KILL_SPAWN_ID": str(victim),
                     "WORKER_KILL_AT_STEP": "13",
                     "WORKER_DATA_PLANE": plane,
                     "TPUDIST_COLL_COMPRESS": "none",
                     "OMP_NUM_THREADS": "1"})
    wall = time.perf_counter() - t0
    tag = f"{plane} gang"
    _check(rc == 0, f"{tag}: exited {rc}", failures)
    ev = {sid: _jsonl(f"{out}/events_{sid}.jsonl") for sid in range(n)}
    loops = {sid: _jsonl(f"{out}/loop_{sid}.jsonl") for sid in range(n)}
    suicide = [e for e in ev[victim] if e["event"] == "suicide"]
    _check(len(suicide) == 1 and suicide[0]["step"] == 13,
           f"{tag}: spawn {victim} did not die at step 13", failures)
    if not suicide:
        return {"failed": True}
    t_kill = suicide[0]["t"]
    survivors = [sid for sid in range(n) if sid != victim]
    detect, recover, done, groups = {}, {}, {}, {}
    for sid in survivors:
        rounds = [e for e in ev[sid] if e["event"] == "round"]
        resets = [(e["old_world"], e["new_world"], e["lr"])
                  for e in ev[sid] if e["event"] == "reset"]
        fin = [e for e in ev[sid] if e["event"] == "done"]
        _check([r["world"] for r in rounds] == [n, n - 1]
               and rounds[-1]["resume_batch"] == 10,
               f"{tag}: spawn {sid}'s rounds {rounds}", failures)
        _check(len(resets) == 1 and resets[0][:2] == (n, n - 1)
               and abs(resets[0][2] - 0.1 * (n - 1) / n) < 1e-12,
               f"{tag}: spawn {sid}'s resets {resets}", failures)
        _check(bool(fin) and fin[-1]["steps"] == 30
               and fin[-1]["world"] == n - 1,
               f"{tag}: spawn {sid}'s done {fin}", failures)
        lost = [r for r in loops[sid]
                if r["event"] in ("world_changed", "peer_lost")]
        first = [e for e in ev[sid] if e["event"] == "first_step"
                 and rounds and e["round"] == rounds[-1]["round"]]
        _check(bool(lost and first),
               f"{tag}: spawn {sid} has no detection or recovery event",
               failures)
        if fin:
            done[sid] = fin[-1]
        if lost and first:
            detect[sid] = {"seconds": lost[0]["t"] - t_kill,
                           "by": lost[0]["event"]}
            recover[sid] = first[0]["t"] - t_kill
        if plane == "ici":
            hlo = [e for e in ev[sid] if e["event"] == "hlo"]
            ctl = [r for r in loops[sid] if r["event"] == "control_plane"]
            want = "nccl" if args.device == "cuda" else "gloo"
            _check([e["round"] for e in hlo] == [r["round"] for r in rounds]
                   and all(e["backend"] == want and e["calls"] > 0
                           for e in hlo),
                   f"{tag}: spawn {sid}'s group events {hlo}", failures)
            _check(bool(ctl) and ctl[-1]["calls"].get("allreduce") == 1
                   and ctl[-1]["data_calls"].get("allreduce") == 20,
                   f"{tag}: spawn {sid}'s control plane {ctl}", failures)
            groups[sid] = {"backend": hlo[-1]["backend"] if hlo else None,
                           "formed_s": [r["seconds"] for r in loops[sid]
                                        if r["event"] == "ici_formed"],
                           "teardown_s": [r["seconds"] for r in loops[sid]
                                          if r["event"] == "ici_teardown"],
                           "last_round_calls": ctl[-1]["data_calls"]
                           if ctl else None,
                           "store_calls": ctl[-1]["calls"] if ctl else None}
    params = {sid: _last_params(ckpt, sid) for sid in survivors}
    ref = params[survivors[0]]
    _check(all(np.array_equal(ref[k], params[sid][k])
               for sid in survivors[1:] for k in ref)
           and len({done[sid]["checksum"] for sid in done}) == 1,
           f"{tag}: survivors differ", failures)

    def ms_per_step(lo, hi):
        t = {e["step"]: e["t"] for e in ev[survivors[0]]
             if e["event"] == "commit"}
        return (t[hi] - t[lo]) / (hi - lo) * 1e3

    return {"wall_s": wall, "params": ref,
            "loss": done[survivors[0]]["loss"] if done else None,
            "detection_s": detect, "recovery_s": recover,
            "ms_per_step": {f"world{n}": ms_per_step(5, 10),
                            f"world{n - 1}": ms_per_step(15, 30)},
            "groups": groups}


def allreduce_rank_main(argv) -> int:
    """One rank of the allreduce timing (a process of its own)."""
    import torch

    from tpudist_torch.models import MLP
    from tpudist_torch.runtime.coord import CoordClient
    from tpudist_torch.runtime.ici import IciCollectives, IciDataPlane

    rank, world, port, round_id = (int(v) for v in argv[:4])
    device, out_path = argv[4], argv[5]
    dev = torch.device("cuda", rank) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    g = torch.Generator(device=dev).manual_seed(1000 + rank)
    tree = {n: torch.randn(p.shape, generator=g, device=dev)
            for n, p in MLP(5, 1024, device=dev).named_parameters()}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with CoordClient("127.0.0.1", port) as client:
        plane = IciDataPlane(client, device=dev)
        group = plane.form(round_id, rank, world)
        coll = IciCollectives(group, device=dev)
        for _ in range(ALLREDUCE_WARMUP):
            coll.allreduce_mean(tree)
        sync()
        ms = []
        for _ in range(ALLREDUCE_REPS):
            t0 = time.perf_counter()
            got = coll.allreduce_mean(tree)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        checksum = float(sum(v.double().sum() for v in got.values()))
        plane.finalize(rank, lambda: client.barrier(
            f"allreduce_done/{round_id}", world, 60.0))
    with open(out_path, "w") as fh:
        json.dump({"rank": rank, "ms": ms, "checksum": checksum,
                   "backend": plane.backend,
                   "f32": sum(v.numel() for v in tree.values())}, fh)
    return 0


def allreduce_timing(args, world: int, round_id: int, port: int, tmp: str,
                     failures: list) -> dict:
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-main",
                 str(rank), str(world), str(port), str(round_id),
                 args.device, f"{tmp}/ar_{world}_{rank}.json"],
                start_new_session=True))
        deadline = time.monotonic() + ALLREDUCE_TIMEOUT_S
        for p in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            _check(rc == 0, f"allreduce at world {world}: a rank exited "
                            f"{rc}", failures)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    rows = [_jsonl(f"{tmp}/ar_{world}_{r}.json") for r in range(world)]
    if not all(rows):
        return {"failed": True}
    rows = [r[0] for r in rows]
    _check(len({r["checksum"] for r in rows}) == 1,
           f"allreduce at world {world}: ranks differ", failures)
    ms = sorted(m for r in rows for m in r["ms"])
    return {"world": world, "backend": rows[0]["backend"],
            "f32": rows[0]["f32"], "mbytes": rows[0]["f32"] * 4 / 1e6,
            "ms_median": ms[len(ms) // 2], "ms_min": ms[0], "ms_max": ms[-1],
            "reps_per_rank": ALLREDUCE_REPS}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-main"]:
        return allreduce_rank_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--kill-spawn", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda":
        if torch.cuda.device_count() < args.workers:
            print(f"elastic_nccl_check: needs {args.workers} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    from tpudist_torch.runtime.coord import CoordServer

    failures: list = []
    with tempfile.TemporaryDirectory() as tmp:
        ici = gang(args, "ici", tmp, failures)
        host = gang(args, "host", tmp, failures)
        rel = None
        if not ici.get("failed") and not host.get("failed"):
            rel = max(float(abs(ici["params"][k] - host["params"][k]).max()
                            / abs(host["params"][k]).max())
                      for k in host["params"])
            _check(rel <= ELASTIC_RTOL,
                   f"ici against host plane: {rel} > {ELASTIC_RTOL}",
                   failures)
        with CoordServer(0) as srv:
            timing = [allreduce_timing(args, w, i, srv.port, tmp, failures)
                      for i, w in enumerate((args.workers,
                                             args.workers - 1))]
    for g in (ici, host):
        g.pop("params", None)
    print(json.dumps({"elastic_nccl_check": {
        "device": args.device, "workers": args.workers,
        "cards": torch.cuda.device_count() if args.device == "cuda" else 0,
        "ici": ici, "host": host, "ici_vs_host_param_max_rel": rel,
        "allreduce_24mb": timing, "failures": failures,
        "ok": not failures}}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
