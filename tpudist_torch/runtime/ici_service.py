"""Standalone host of one elastic round's ``torch.distributed`` store
(counterpart of :mod:`tpudist.runtime.ici_service`; run as ``python -m
tpudist_torch.runtime.ici_service``).

Each round of the process-group data plane (:mod:`tpudist_torch.runtime.ici`)
forms its group over a ``TCPStore``.  A ``TCPStore`` server hosted inside
a worker dies with that worker: were the round's rank 0 killed while its
peers were still forming the group (or re-forming the next one against the
same address), every survivor would block on a dead store until its
timeout.  So, as in tpudist, no worker hosts it: the round's rank 0 spawns
this tiny detached process, which serves the store until SIGTERM (a later
round's sweep, or the end of the run) or ``--max-lifetime-s`` (a leak
backstop).

It binds an ephemeral port itself and prints ``ready <port>`` on stdout
once the store accepts connections, so no port can be taken between a
probe and the bind.

Starting one takes seconds (the interpreter imports torch), and a round
must not wait for that on its recovery path.  So every worker keeps one
SPARE started ahead of need (``--parent-pid``): a spare ends when its
parent does, until the worker that takes it for a round ADOPTS it with
SIGUSR1; from then on it serves until SIGTERM like any round's store.

A ``torch.distributed.Store`` subclass over the coordination store
(:class:`~tpudist_torch.runtime.coord.CoordClient`) would need no process,
but gloo's and NCCL's rendezvous block in the store's ``wait``/``get`` from
their own threads, and the coordination client is single-threaded: each
caller would need its own connection.  A dedicated ``TCPStore`` keeps the
data plane's bootstrap off the control plane altogether.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpudist_torch.runtime."
                                      "ici_service")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-lifetime-s", type=float, default=3600.0)
    ap.add_argument("--parent-pid", type=int, default=None,
                    help="a spare: end when this process does, until "
                         "adopted by SIGUSR1")
    args = ap.parse_args(argv)

    import os
    from datetime import timedelta

    import torch.distributed as dist

    state = {"stop": False, "parent": args.parent_pid}

    def on_term(signum, frame):
        state["stop"] = True

    def on_adopt(signum, frame):
        state["parent"] = None

    # before "ready": the adopting worker signals as soon as it reads it
    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGUSR1, on_adopt)
    store = dist.TCPStore(args.host, 0, is_master=True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=60))
    print(f"ready {store.port}", flush=True)
    deadline = time.monotonic() + args.max_lifetime_s
    while not state["stop"] and time.monotonic() < deadline:
        if state["parent"] is not None and os.getppid() != state["parent"]:
            break  # an unadopted spare whose worker is gone
        time.sleep(0.2)
    del store
    return 0


if __name__ == "__main__":
    sys.exit(main())
