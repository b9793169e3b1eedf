"""Worker for the port's TTL-heartbeat elastic tests, the twin of
``ttl_elastic_worker.py`` on ``tpudist_torch``: the same constants, the
same ``WORKER_*`` knobs and the same events, so a gang of these and a gang
of those can be held against each other.

A DP job where workers may SIGKILL themselves mid-training; the survivors
must detect the loss via the coordination service's TTL leases (NOT
launcher exit-code polling), roll back to the last commit, re-rendezvous
at the smaller world, fire the lr-rescale reset callback, and finish.
Gradient sync rides ``HostCollectives`` over the store.  Every worker
appends JSON events to ``$WORKER_OUT_DIR/events_<spawn_id>.jsonl``; each
event carries its wall time ``t`` (the chip phase reads detection and
recovery seconds from them).  At the end (and a victim just before its
kill) a worker writes the elastic loop's own round, world-change and
peer-loss records, and a ``kernel_launches`` record with this process's
launch counts of the port's CUDA kernels (K1-K10; this path runs none),
to ``$WORKER_OUT_DIR/loop_<spawn_id>.jsonl``.

``WORKER_DATA_PLANE=ici`` syncs gradients over each round's
``torch.distributed`` group instead (its backend from
``TPUDIST_ICI_BACKEND``, else the device's); after a round's first step
a worker then emits ``hlo``, the counterpart of tpudist's event of that
name: the group's backend and the collectives counted on it this round.

Extra knobs of the twin: ``WORKER_INIT_NPZ``, the MLP's initial
``state_dict`` (the test converts flax's init to it; without it the
weights are drawn from a CPU generator seeded 0), and ``TPUDIST_DEVICE``
(set by the launcher; ``cpu`` in the CPU tests, several workers share
one card under ``cuda``).
"""

import json
import os
import signal
import sys
import time

import numpy as np
import torch

from tpudist_torch.elastic import worker as elastic_worker
from tpudist_torch.elastic.checkpoint import Checkpointer
from tpudist_torch.elastic.state import ElasticState, HostDataState
from tpudist_torch.elastic.worker import (
    OverlappedGradSync,
    run_elastic_worker,
    worker_device,
)
from tpudist_torch.models import MLP
from tpudist_torch.ops.losses import cross_entropy
from tpudist_torch.train.state import TrainState, sgd

TOTAL_STEPS = 30
COMMIT_EVERY = 5
GLOBAL_BATCH = 12  # divisible by both world sizes (3 and 2)
BASE_LR = 0.1

SPAWN_ID = os.environ.get("TPUDIST_PROCESS_ID", "x")
# comma-separated spawn_id:step pairs, e.g. "2:13,1:22" for a double kill;
# only armed on the FIRST gang attempt — a launcher-restarted gang (the
# full-gang-loss test) must run to completion
KILL_PLAN = dict(
    pair.split(":") for pair in
    os.environ.get("WORKER_KILL_PLAN", "").split(",") if pair)
KILL_SPAWN_ID = os.environ.get("WORKER_KILL_SPAWN_ID")
KILL_AT_STEP = int(os.environ.get("WORKER_KILL_AT_STEP", "13"))
if KILL_SPAWN_ID is not None:
    KILL_PLAN[KILL_SPAWN_ID] = str(KILL_AT_STEP)
if int(os.environ.get("TPUDIST_RESTART_ATTEMPT", "0")) > 0:
    KILL_PLAN = {}
CKPT_DIR = os.environ.get("WORKER_CKPT_DIR")
STEP_DELAY = float(os.environ.get("WORKER_STEP_DELAY", "0"))
OUT = os.environ["WORKER_OUT_DIR"]
DATA_PLANE = os.environ.get("WORKER_DATA_PLANE", "host")
OVERLAP = os.environ.get("WORKER_OVERLAP", "") not in ("", "0", "false")
BUCKETED = int(os.environ.get("WORKER_BUCKETED", "0") or "0")
INIT_NPZ = os.environ.get("WORKER_INIT_NPZ")


def emit(event: str, **fields) -> None:
    with open(os.path.join(OUT, f"events_{SPAWN_ID}.jsonl"), "a") as fh:
        fh.write(json.dumps({"event": event, **fields, "t": time.time()})
                 + "\n")


def kernel_launches() -> dict:
    from tpudist_torch.ops import flash_attention as fa
    from tpudist_torch.ops import flash_decode as fd
    from tpudist_torch.ops import group_norm as gn
    from tpudist_torch.ops import moe_dispatch as md

    kernels = {"K1": fa.FLASH_FORWARD, "K2": fd.FLASH_DECODE,
               "K3": fa.FLASH_BWD_DQ, "K4": fa.FLASH_BWD_DKV,
               "K5": fd.PAGED_FLASH_DECODE, "K6": fd.FLASH_DECODE_Q8,
               "K7": md.MOE_GMM, "K8": fa.FLASH_BWD_DQ_DELTA,
               "K9": gn.GN_FWD, "K10": gn.GN_BWD}
    return {name: k.launches for name, k in kernels.items()}


def dump_loop_records() -> None:
    with open(os.path.join(OUT, f"loop_{SPAWN_ID}.jsonl"), "w") as fh:
        for rec in elastic_worker.recorded:
            fh.write(json.dumps(rec) + "\n")
        fh.write(json.dumps({"event": "kernel_launches",
                             **kernel_launches()}) + "\n")


def global_batch(step: int):
    rng = np.random.default_rng(5000 + step)
    x = rng.standard_normal((GLOBAL_BATCH, 28 * 28)).astype(np.float32)
    y = rng.integers(0, 10, GLOBAL_BATCH)
    return x, y


def main() -> int:
    dev = worker_device()
    # drawn on the host: a CUDA generator draws other numbers, and the card
    # and CPU gangs must start from the same weights
    model = MLP(hidden_layers=1, features=32, device="cpu")
    if INIT_NPZ:
        with np.load(INIT_NPZ) as z:
            model.load_state_dict({k: torch.from_numpy(z[k]) for k in z})
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev)
    train_state = TrainState.create(model, sgd(BASE_LR), seed=0)
    ckpt = None
    if CKPT_DIR:
        ckpt = Checkpointer(os.path.join(CKPT_DIR, f"w{SPAWN_ID}"), keep=3)
    state = ElasticState(train_state, host=HostDataState(),
                         checkpointer=ckpt)
    if state.restored_step is not None:
        emit("restored", step=state.restored_step,
             batch=state.host.batch)

    def on_reset(s: ElasticState, old: int, new: int) -> None:
        group = s.state.optimizer.param_groups[0]
        group["lr"] = group["lr"] * new / old
        emit("reset", old_world=old, new_world=new, lr=group["lr"])

    state.register_reset_callbacks([on_reset])
    params = dict(model.named_parameters())

    def local_grads(x, y):
        model.zero_grad(set_to_none=True)
        loss = cross_entropy(model(x), y)
        loss.backward()
        return loss.detach()

    def train_fn(state: ElasticState, ctx) -> None:
        emit("round", round=ctx.round, rank=ctx.rank, world=ctx.world_size,
             resume_batch=state.host.batch)
        # fresh sync per round: the step-1 plan is recorded against THIS
        # round's membership and collectives instance
        bucketed = (OverlappedGradSync(ctx.collectives, bucket_bytes=BUCKETED)
                    if BUCKETED else None)
        hooks = bucketed.hook(model) if bucketed is not None else []
        shard = GLOBAL_BATCH // ctx.world_size
        last_loss = float("nan")
        first = True
        hlo_emitted = False
        try:
            for step in range(state.host.batch, TOTAL_STEPS):
                if STEP_DELAY:
                    time.sleep(STEP_DELAY)  # stretch the run for join tests
                gx, gy = global_batch(step)
                lo = ctx.rank * shard
                x = torch.from_numpy(gx[lo:lo + shard]).to(dev)
                y = torch.from_numpy(gy[lo:lo + shard]).to(dev)
                # the gradients stream into the buckets from the backward
                # hooks (backward order) when bucketed
                loss = local_grads(x, y)
                if bucketed is not None:
                    bucketed.grad_ready("loss", loss)
                    out = bucketed.reduce(mean=True)
                    grads = {n: out[n] for n in params}
                    gloss = out["loss"]
                else:
                    payload = ({n: p.grad for n, p in params.items()}, loss)
                    if OVERLAP:
                        handle = ctx.collectives.allreduce_mean_async(payload)
                        if step + 1 < TOTAL_STEPS:
                            global_batch(step + 1)
                        grads, gloss = handle.wait()
                    else:
                        grads, gloss = ctx.collectives.allreduce_mean(payload)
                if ctx.data_plane == "ici" and not hlo_emitted:
                    # this round's gradient sync rode the group, not the
                    # store (tpudist shows the compiled all-reduce here)
                    import torch.distributed as dist

                    emit("hlo", round=ctx.round, world=ctx.world_size,
                         backend=str(dist.get_backend(ctx.mesh)),
                         calls=sum(ctx.collectives.calls.values()),
                         bytes=ctx.collectives.bytes)
                    hlo_emitted = True
                for n, p in params.items():
                    p.grad = grads[n].view_as(p)
                state.state.apply_gradients()
                state.host.batch = step + 1
                last_loss = float(gloss)
                if first:
                    emit("first_step", round=ctx.round, step=step + 1)
                    first = False
                if KILL_PLAN.get(SPAWN_ID) == str(step + 1):
                    emit("suicide", step=step + 1)
                    dump_loop_records()
                    os.kill(os.getpid(), signal.SIGKILL)  # kill -9
                if (step + 1) % COMMIT_EVERY == 0:
                    state.commit()
                    emit("commit", step=step + 1)
                    ctx.check()  # the per-commit membership poll
        finally:
            for h in hooks:
                h.remove()
        state.commit()
        checksum = float(sum(p.detach().abs().sum().item()
                             for p in model.parameters()))
        emit("done", steps=TOTAL_STEPS, loss=last_loss, checksum=checksum,
             lr=state.state.optimizer.param_groups[0]["lr"],
             world=ctx.world_size)

    run_elastic_worker(train_fn, state, worker_id=f"w{SPAWN_ID}",
                       ttl_s=1.5, heartbeat_interval_s=0.3,
                       data_plane=DATA_PLANE)
    dump_loop_records()
    return 0


if __name__ == "__main__":
    sys.exit(main())
