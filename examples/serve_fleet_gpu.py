"""Fault-tolerant serve fleet demo on the GPU: a router over N replica
processes (the PyTorch/CUDA twin of ``serve_fleet_tpu.py``).

It starts the native coordination server, launches ``--replicas`` serve
worker subprocesses (each a `ServeLoop` on ``--device``, default the card,
over identical seed-0 tiny-LM weights, holding a TTL heartbeat lease and
publishing its load gauges; each prefills through the flash-forward
kernel and decodes through the paged flash-decode kernel), then routes a
queue of mixed requests least-loaded across the fleet
(`tpudist_torch.runtime.router`).  Several replicas share one card here.

With ``--kill`` one replica SIGKILLs itself mid-decode
(``TPUDIST_FAULT_KILL_AFTER_SEGMENTS`` — the fault-injection harness):
the router notices the lapsed heartbeat, drains the dead replica's
outstanding requests, and redispatches them to survivors.  Every request
still completes, and because decoding is greedy over identical weights
the redispatched outputs are token-identical to the undisturbed ones —
the demo verifies this against a local single-loop reference run.

The elastic tier:

* ``--join`` scales a RUNNING fleet up by one replica mid-traffic
  (`scale_fleet`) — the router discovers it on its next membership poll
  (`router/joins` ticks) and starts dispatching to it immediately.
* ``--hot-swap`` serves a first batch on version-1 weights, then rolls
  version-2 weights through the live fleet (`roll_weights` →
  drain-gated, one-replica-at-a-time ticket chain → `wait_swapped`)
  and serves a second batch — verified token-identical to a local
  reference on the NEW weights, with zero requests lost to the roll.

The disaggregated tier:

* ``--disagg`` splits the fleet into 1 prefill replica + N-1 decode
  replicas.  The prefill replica runs chunked prefill to completion,
  serializes the finished slot's KV pages, and hands them to a decode
  replica over the coord store (``router/handoffs`` ticks); the decode
  replica adopts the pages without re-prefilling.  Greedy decoding over
  identical weights keeps the output token-identical to a unified
  single-loop reference, which the demo verifies.

The control-plane tier:

* ``--autoscale`` (the autoscaler) is not ported yet: it raises
  ``NotImplementedError`` until ROADMAP Queue A 10's remainder lands.
* ``--roll-structural`` performs a blue-green rollout of a STRUCTURAL
  change in-place weight swaps cannot express (paged KV block size
  16 -> 8): green pool spun up, warmed, canary exact-checked, traffic
  shifted, blue drained — then serves a second batch on green.

Run (on the card by default; ``--device cpu`` for the CPU; each replica
is a separate process):

    python examples/serve_fleet_gpu.py --replicas 3 --kill
    python examples/serve_fleet_gpu.py --replicas 2 --join --hot-swap
    python examples/serve_fleet_gpu.py --replicas 3 --disagg
    python examples/serve_fleet_gpu.py --replicas 1 --roll-structural
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--requests", type=int, default=6)
    parser.add_argument("--kill", action="store_true",
                        help="SIGKILL the last replica mid-decode and "
                             "watch the router redispatch")
    parser.add_argument("--kill-after-segments", type=int, default=4)
    parser.add_argument("--join", action="store_true",
                        help="scale the running fleet up by one joiner "
                             "replica while traffic flows")
    parser.add_argument("--hot-swap", action="store_true",
                        help="roll new weights through the live fleet "
                             "between two batches (drain-gated, zero "
                             "lost requests)")
    parser.add_argument("--autoscale", action="store_true",
                        help="let the autoscaler buy capacity for the "
                             "batch instead of scaling by hand")
    parser.add_argument("--roll-structural", action="store_true",
                        help="blue-green rollout of a structural "
                             "change (paged block size 16 -> 8) with "
                             "a canary exact-check, then a second "
                             "batch on green")
    parser.add_argument("--disagg", action="store_true",
                        help="split the fleet into 1 prefill + N-1 "
                             "decode replicas; finished prefill KV "
                             "pages migrate to a decode replica "
                             "instead of being recomputed")
    parser.add_argument("--ttl", type=float, default=1.0,
                        help="replica heartbeat lease (the death-"
                             "detection latency floor)")
    parser.add_argument("--device", default="cuda",
                        help="where replicas and the reference serve "
                             "(default cuda; raises without a card)")
    args = parser.parse_args(argv)
    if args.autoscale:
        raise NotImplementedError(
            "--autoscale: the autoscaler is not ported yet "
            "(ROADMAP Queue A 10 (autoscaler))")
    if args.hot_swap and args.roll_structural:
        parser.error("--hot-swap and --roll-structural are separate "
                     "demos; pick one")
    if args.disagg and (args.kill or args.join or args.hot_swap
                        or args.autoscale or args.roll_structural):
        parser.error("--disagg is its own demo; run it without the "
                     "other mode flags")
    if args.disagg and args.replicas < 2:
        parser.error("--disagg needs --replicas >= 2 "
                     "(1 prefill + N-1 decode)")

    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.runtime.coord import CoordClient, CoordServer
    from tpudist_torch.runtime.router import (Router, build_tiny_lm,
                                              exit_reports,
                                              launch_local_fleet,
                                              roll_weights, scale_fleet,
                                              stop_fleet, wait_live,
                                              wait_swapped)
    from tpudist_torch.utils.device import resolve_device

    device = str(resolve_device(args.device))   # raises without a card

    try:
        server = CoordServer(0)
    except Exception as e:  # noqa: BLE001 - native lib may be unbuilt
        print(f"native coord store unavailable ({e}); it is built from "
              "native/coord.cpp with g++ at first use", file=sys.stderr)
        return 1

    def make_requests(n, seed):
        rng = np.random.default_rng(seed)
        return [Request(rng.integers(0, 64, 4 + i % 6).astype(np.int32),
                        16 + 2 * (i % 4), rid=f"q{seed}-{i}")
                for i in range(n)]

    def reference(seed, reqs):
        cfg, params = build_tiny_lm(seed=seed)
        loop = ServeLoop(cfg, params, num_slots=2, steps_per_sync=4,
                         prefill_chunk=8, cache_layout="paged",
                         kv_block_size=16, device=device)
        return {c.rid: c.tokens.tolist() for c in loop.run(reqs)}

    env = ({args.replicas - 1:
            {"TPUDIST_FAULT_KILL_AFTER_SEGMENTS":
             args.kill_after_segments}} if args.kill else None)
    client = CoordClient(port=server.port)

    replica_args = ["--cache-layout", "paged", "--kv-block-size", "16",
                    "--ttl", str(args.ttl)]
    snap_dir = None
    if args.hot_swap:
        # version 1 goes to the shared snapshot dir BEFORE launch:
        # replicas (and any later joiner) restore the fleet's current
        # weights from it instead of trusting their build seed
        snap_dir = tempfile.mkdtemp(prefix="tpudist-weights-")
        roll_weights(client, snap_dir, build_tiny_lm(seed=0)[1],
                     version=1)
        replica_args += ["--snapshot-dir", snap_dir,
                         "--swap-turn-timeout", "5.0"]

    if args.disagg:
        # prefill replicas require chunked prefill; pin the chunk and
        # fused segment length to match the reference loop
        replica_args += ["--prefill-chunk", "8",
                         "--steps-per-sync", "4"]
        print(f"launching disaggregated fleet: 1 prefill + "
              f"{args.replicas - 1} decode replicas (KV pages migrate "
              "at handoff)")
        procs = launch_local_fleet(
            f"127.0.0.1:{server.port}", 1,
            replica_args=replica_args + ["--role", "prefill"],
            device=device)
        procs += scale_fleet(
            f"127.0.0.1:{server.port}", args.replicas - 1,
            start_index=1,
            replica_args=replica_args + ["--role", "decode"],
            device=device)
    else:
        print(f"launching {args.replicas} replicas"
              + (f" (replica r{args.replicas - 1} will SIGKILL itself "
                 f"after {args.kill_after_segments} decode segments)"
                 if args.kill else ""))
        procs = launch_local_fleet(
            f"127.0.0.1:{server.port}", args.replicas,
            replica_args=replica_args, env_overrides=env, device=device)
    requests = make_requests(args.requests, seed=0)
    comps2: list = []
    try:
        wait_live(client, args.replicas, timeout_s=120.0, procs=procs)
        print("fleet live; routing")
        router = Router(client, lost_after_s=5.0)
        if args.join:
            router._poll({}, {}, None)  # pin the membership baseline
            print("scaling up: one joiner replica entering the "
                  "live fleet")
            procs += scale_fleet(f"127.0.0.1:{server.port}", 1,
                                 start_index=args.replicas,
                                 replica_args=replica_args, device=device)
        t0 = time.perf_counter()
        comps = router.run(requests, timeout_s=180.0)
        wall = time.perf_counter() - t0
        if args.disagg:
            from tpudist_torch import obs

            snap = obs.snapshot()["counters"]
            handoffs = int(snap.get("router/handoffs",
                                    {}).get("value", 0))
            print(f"{handoffs} KV handoffs crossed the "
                  "prefill -> decode seam")
        if args.roll_structural:
            canary = Request(np.arange(5, dtype=np.int32), 8,
                             rid="probe")
            want_canary = np.asarray(reference(0, [canary])["probe"],
                                     np.int32)
            print("blue-green structural roll: paged KV block size "
                  "16 -> 8 (canary exact-checked before traffic "
                  "shifts)")
            res = router.roll_structural(
                lambda: scale_fleet(
                    f"127.0.0.1:{server.port}", 1,
                    replica_args=["--cache-layout", "paged",
                                  "--kv-block-size", "8", "--ttl",
                                  str(args.ttl), "--pool", "green"],
                    device=device),
                1, canary=canary, expect_tokens=want_canary)
            procs += res.get("procs", [])
            print(f"roll {'committed' if res['ok'] else 'ROLLED BACK'}"
                  f"; blue drained: {bool(res.get('blue_drained'))}")
            comps2 = router.run(make_requests(args.requests, seed=1),
                                timeout_s=180.0)
        if args.hot_swap:
            survivors = (args.replicas + (1 if args.join else 0)
                         - (1 if args.kill else 0))
            print("rolling weight hot-swap to version 2 "
                  f"across {survivors} live replicas")
            roll_weights(client, snap_dir, build_tiny_lm(seed=1)[1],
                         version=2)
            swapped = wait_swapped(client, survivors, 2,
                                   timeout_s=120.0)
            print(f"version 2 live on ranks {sorted(swapped)}; "
                  "routing the post-swap batch")
            comps2 = router.run(make_requests(args.requests, seed=1),
                                timeout_s=180.0)
    finally:
        stop_fleet(client, procs)
        if snap_dir is not None:
            shutil.rmtree(snap_dir, ignore_errors=True)

    # verify: greedy fleet output (including anything redispatched)
    # must be token-identical to one uninterrupted local loop — batch 1
    # against the version-1 weights, batch 2 against version 2
    want = reference(0, requests)
    mismatched = [c.rid for c in comps
                  if c.tokens.tolist() != want[c.rid]]
    n_want = len(requests)
    if args.hot_swap:
        want2 = reference(1, make_requests(args.requests, seed=1))
        mismatched += [c.rid for c in comps2
                       if c.tokens.tolist() != want2[c.rid]]
        n_want += args.requests
    elif args.roll_structural:
        # same weights, different paged block size: still exact
        want2 = reference(0, make_requests(args.requests, seed=1))
        mismatched += [c.rid for c in comps2
                       if c.tokens.tolist() != want2[c.rid]]
        n_want += args.requests

    for c in sorted(comps + comps2, key=lambda c: c.rid):
        print(f"  {c.rid}: {len(c.tokens)} tokens ({c.reason})")
    reports = exit_reports(client)
    print(f"{len(comps) + len(comps2)}/{n_want} requests completed "
          f"(first batch in {wall:.1f}s); "
          f"clean exits: {sorted(reports)}; "
          f"pools drained: "
          f"{all(r.get('pool_drained') for r in reports.values())}")
    if len(comps) + len(comps2) != n_want or mismatched:
        print(f"FAILED: mismatched={mismatched}", file=sys.stderr)
        return 1
    print("exact match vs uninterrupted reference run"
          + ("s (both weight versions)" if args.hot_swap else "")
          + " OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
