"""Elastic allreduce MNIST training with commit/rollback on NVIDIA GPUs (the
PyTorch port), the twin of ``horovod_mnist_elastic_tpu.py`` and of the
reference's ``horovod/horovod_mnist_elastic.py``.

The reference: AdamW lr=0.01/sqrt(world), ``@hvd.elastic.run`` around
``train(state)``, ``TorchState(model, optimizer, batch=0, epoch=0)``,
``state.commit()`` every 30 batches, batch-offset skip on resume, an
``on_state_reset`` callback rescaling lr on world-size change, and a final
accuracy test (`horovod_mnist_elastic.py:11-108`).

Here :class:`tpudist_torch.elastic.ElasticState` + :func:`elastic_run`
give the same contract: commit = a host copy of the parameters, AdamW's
state, the step and the (epoch, batch) position (plus an optional durable
checkpoint); rollback + reset callbacks on a world change; resume lands
exactly on the committed (epoch, batch).  ``--elastic sim`` runs one
process (or a torchrun world) and ``--resize-at epoch:batch:new_size``
injects a resize.  ``--elastic ttl`` is real membership-driven elastic:
each worker syncs its gradients through the coordination store, and the
TTL rendezvous decides when the world resizes.

The device comes from ``TPUDIST_DEVICE`` (``cuda`` unless set; the
launcher exports it, ``--device cpu`` there), the counterpart of the TPU
twin's ``JAX_PLATFORMS``; several ttl workers may share one card.

Run (one card):   python3 examples/horovod_mnist_elastic_gpu.py --epochs 15
Run (ttl, 3 workers; kill -9 one to watch the survivors re-form):
                  python3 -m tpudist_torch.runtime.launch -n 3 \\
                      --min-nprocs 2 --elastic-inprocess -- \\
                      examples/horovod_mnist_elastic_gpu.py --elastic ttl
Run (CPU, tiny):  TPUDIST_DEVICE=cpu python3 \\
                      examples/horovod_mnist_elastic_gpu.py --epochs 1 \\
                      --limit 512 --resize-at 0:1:2
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

BATCHES_PER_COMMIT = 30  # `horovod_mnist_elastic.py:13`


def say(line: str) -> None:
    """Print ``line`` in ONE write and flush: the ranks of a gang share
    their launcher's pipe, and with unbuffered output (``-u``,
    ``PYTHONUNBUFFERED``) ``print`` writes the text and its newline apart,
    so two ranks' lines printed at once could merge into one."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", default=15, type=int,
                        help="reference trains 15 (`horovod_mnist_elastic.py:61`)")
    parser.add_argument("--batch-size", default=128, type=int,
                        help="per-replica batch (`horovod_mnist_elastic.py:52`)")
    parser.add_argument("--base-lr", default=0.01, type=float,
                        help="lr is base/sqrt(world) (`horovod_mnist_elastic.py:41`)")
    parser.add_argument("--commit-every", default=BATCHES_PER_COMMIT, type=int)
    parser.add_argument("--limit", default=0, type=int)
    parser.add_argument("--resize-at", default="",
                        help="epoch:batch:new_world — inject one elastic resize")
    parser.add_argument(
        "--elastic", choices=["sim", "ttl"], default="sim",
        help="sim: one process (or a torchrun world), --resize-at injects "
             "a synthetic resize; ttl: REAL membership-driven elastic over "
             "the coordination service — launch as `python -m "
             "tpudist_torch.runtime.launch -n 3 --min-nprocs 2 "
             "--elastic-inprocess -- examples/horovod_mnist_elastic_gpu.py "
             "--elastic ttl` and kill -9 a worker to watch survivors "
             "re-rendezvous")
    parser.add_argument(
        "--overlap", action="store_true",
        help="ttl mode: submit gradient allreduce async and prepare the "
             "next batch during the wire time (hvd.DistributedOptimizer "
             "overlap; identical numerics, lower step latency)")
    args = parser.parse_args(argv)

    if args.elastic == "ttl":
        return _ttl_main(args)

    import torch

    from tpudist_torch.data.loader import ShardedLoader
    from tpudist_torch.data.mnist import load_mnist
    from tpudist_torch.elastic.loop import WorldChanged, elastic_run
    from tpudist_torch.elastic.state import ElasticState
    from tpudist_torch.models import ConvNet
    from tpudist_torch.ops.losses import nll_loss
    from tpudist_torch.parallel import (
        broadcast_params,
        make_dp_masked_eval_step,
        make_dp_train_step,
    )
    from tpudist_torch.runtime import initialize, shutdown
    from tpudist_torch.train import TrainState, adamw
    from tpudist_torch.utils.device import resolve_device

    device = resolve_device(os.environ.get("TPUDIST_DEVICE") or "cuda")
    ctx = initialize(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world = ctx.process_count
    global_batch = args.batch_size * world

    train_ds = load_mnist("train", n=args.limit or None)
    test_ds = load_mnist("test", n=args.limit or None)
    loader = ShardedLoader([train_ds.images, train_ds.labels], global_batch,
                           shuffle=True, device=device)
    test_loader = ShardedLoader([test_ds.images, test_ds.labels],
                                global_batch, drop_last=False, device=device)

    model = ConvNet(device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))

    def lr_for(world_size: int) -> float:
        return args.base_lr / math.sqrt(world_size)

    def loss_fn(model, batch, generator):
        x, y = batch
        return nll_loss(model(x, train=True, generator=generator), y), {}

    train_step = make_dp_train_step(loss_fn)
    eval_step = make_dp_masked_eval_step(lambda m, inputs: m(*inputs))

    state = ElasticState(
        TrainState.create(broadcast_params(model), adamw(lr_for(world))),
        world_size=world)

    def on_state_reset(es: ElasticState, old_world: int,
                       new_world: int) -> None:
        # lr rescale on world change (`horovod_mnist_elastic.py:80-82`);
        # AdamW's state layout does not depend on the lr, so setting the
        # param groups' lr is the whole reset
        for group in es.state.optimizer.param_groups:
            group["lr"] = lr_for(new_world)
        if ctx.is_coordinator:
            print(f"reset: world {old_world} -> {new_world}, "
                  f"lr -> {lr_for(new_world):.5f}", flush=True)

    state.register_reset_callbacks([on_state_reset])

    resize_at = None
    if args.resize_at:
        e, b, w = (int(v) for v in args.resize_at.split(":"))
        resize_at = {"epoch": e, "batch": b, "world": w, "armed": True}

    def train(es: ElasticState) -> None:
        # the reference's `@hvd.elastic.run def train(state)` body
        # (`horovod_mnist_elastic.py:55-77`): resume from the committed
        # epoch, skip batches before the committed offset, commit
        # periodically
        metrics = None
        for epoch in range(es.host.epoch, args.epochs):
            batch_offset = es.host.batch if epoch == es.host.epoch else 0
            for batch_idx, batch in enumerate(
                    loader.epoch(epoch, start_step=batch_offset),
                    start=batch_offset):
                if (resize_at and resize_at["armed"]
                        and epoch == resize_at["epoch"]
                        and batch_idx == resize_at["batch"]):
                    resize_at["armed"] = False
                    raise WorldChanged(resize_at["world"])
                es.state, metrics = train_step(es.state, *batch)
                es.host.epoch, es.host.batch = epoch, batch_idx + 1
                if (batch_idx + 1) % args.commit_every == 0:
                    es.commit()
            es.host.epoch, es.host.batch = epoch + 1, 0
            es.commit()
            if ctx.is_coordinator and metrics is not None:
                print(f"Epoch {epoch} done | loss "
                      f"{float(metrics['loss']):.4f}", flush=True)

    try:
        elastic_run(train, state)
        correct = seen = 0
        for step, batch in enumerate(test_loader.epoch(0)):
            c, t = eval_step(state.state.model, *batch,
                             test_loader.valid_mask(step))
            correct, seen = correct + int(c), seen + int(t)
    finally:
        shutdown()
    accuracy = correct / max(seen, 1)
    if ctx.is_coordinator:
        print(f"accuracy: {100 * accuracy:.2f}%")  # `horovod_mnist_elastic.py:102`
    return accuracy


def _ttl_main(args) -> float:
    """Membership-driven elastic (`horovod_mnist_elastic.py:108` semantics):
    each process trains its rank's shard, syncs gradients through the
    coordination-store collectives, and the TTL rendezvous — not a
    simulated flag — decides when the world resizes."""
    import numpy as np
    import torch

    from tpudist_torch.data.mnist import load_mnist
    from tpudist_torch.data.sampler import ShardedSampler
    from tpudist_torch.elastic.state import ElasticState
    from tpudist_torch.elastic.worker import run_elastic_worker, worker_device
    from tpudist_torch.models import ConvNet
    from tpudist_torch.ops.losses import nll_loss
    from tpudist_torch.train import TrainState, adamw

    device = worker_device()
    train_ds = load_mnist("train", n=args.limit or None)
    test_ds = load_mnist("test", n=args.limit or None)
    model = ConvNet(device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    params = dict(model.named_parameters())

    def lr_for(world: int) -> float:
        return args.base_lr / math.sqrt(world)

    state = ElasticState(TrainState.create(model, adamw(lr_for(1))))

    def on_state_reset(es: ElasticState, old: int, new: int) -> None:
        for group in es.state.optimizer.param_groups:
            group["lr"] = lr_for(new)
        say(f"reset: world {old} -> {new}, lr -> {lr_for(new):.5f}")

    state.register_reset_callbacks([on_state_reset])

    def grads_fn(x, y, generator):
        model.zero_grad(set_to_none=True)
        loss = nll_loss(model(x, train=True, generator=generator), y)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in params.items()}

    def batch_on_device(sel):
        return (torch.from_numpy(train_ds.images[sel]).to(device),
                torch.from_numpy(train_ds.labels[sel]).to(device))

    def train(es: ElasticState, ctx) -> None:
        # dataset sharding re-derived per (re)start at the current world —
        # the reference rebuilds its dataset per restart too
        # (`horovod_mnist_elastic.py:57-58`)
        sampler = ShardedSampler(
            len(train_ds), ctx.world_size, ctx.rank, shuffle=True)
        steps = sampler.shard_size // args.batch_size
        gloss = float("nan")
        for epoch in range(es.host.epoch, args.epochs):
            idx = sampler.indices(epoch)
            start = es.host.batch if epoch == es.host.epoch else 0
            for b in range(start, steps):
                sel = idx[b * args.batch_size:(b + 1) * args.batch_size]
                loss, grads = grads_fn(*batch_on_device(sel),
                                       es.state.generator(ctx.rank))
                payload = (grads, loss)
                if args.overlap:
                    # async submit: the next batch's index selection and
                    # host-side staging ride the allreduce's wire time;
                    # wait() returns the identical tree the sync call would
                    handle = ctx.collectives.allreduce_mean_async(payload)
                    if b + 1 < steps:
                        np.ascontiguousarray(train_ds.images[
                            idx[(b + 1) * args.batch_size:
                                (b + 2) * args.batch_size]])
                    grads, gloss = handle.wait()
                else:
                    grads, gloss = ctx.collectives.allreduce_mean(payload)
                for n, p in params.items():
                    p.grad = grads[n].view_as(p)
                es.state.apply_gradients()
                es.host.epoch, es.host.batch = epoch, b + 1
                if (b + 1) % args.commit_every == 0:
                    es.commit()
                    if ctx.rank == 0:
                        print(f"[rank 0/{ctx.world_size}] epoch {epoch} "
                              f"batch {b + 1} committed", flush=True)
                    ctx.check()
            es.host.epoch, es.host.batch = epoch + 1, 0
            es.commit()
            ctx.check()
            say(f"[rank {ctx.rank}/{ctx.world_size}] epoch {epoch} "
                f"loss {float(gloss):.4f}")

    run_elastic_worker(train, state)

    correct = 0
    with torch.no_grad():
        for lo in range(0, len(test_ds), 512):
            logits = model(torch.from_numpy(
                test_ds.images[lo:lo + 512]).to(device))
            labels = torch.from_numpy(test_ds.labels[lo:lo + 512])
            correct += int((logits.argmax(-1).cpu() == labels).sum())
    accuracy = correct / len(test_ds)
    say(f"accuracy: {100 * accuracy:.2f}%")  # `horovod_mnist_elastic.py:102`
    return accuracy


if __name__ == "__main__":
    main()
