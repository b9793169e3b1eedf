"""All-reduce data-parallel MNIST training on NVIDIA GPUs (the PyTorch
port), the twin of ``mnist_horovod_tpu.py`` and of the reference's
``horovod/mnist_horovod.py``.

The reference: ``hvd.init()`` and a ring all-reduce, the ConvNet, SGD
lr=0.01 in ``hvd.DistributedOptimizer``, the parameters broadcast from
rank 0, 50 epochs of NLL at batch 1024 per replica, the loss printed
every 5 batches (``mnist_horovod.py:28-67``).  Here each process drives
one device: ``broadcast_params`` is the rank-0 broadcast and
``make_dp_train_step``'s gradient all-reduce (NCCL on the cards, gloo on
the CPU) is Horovod's.  The ConvNet's dropout draws from the step's
generator.

Run (one card):   python3 examples/mnist_horovod_gpu.py --epochs 50
Run (N cards):    torchrun --nproc-per-node N examples/mnist_horovod_gpu.py
Run (CPU, tiny):  python3 examples/mnist_horovod_gpu.py --device cpu \\
                      --epochs 1 --batch-size 64 --limit 256
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", default=50, type=int,
                        help="reference trains 50 epochs "
                             "(`mnist_horovod.py:58`)")
    parser.add_argument("--batch-size", default=1024, type=int,
                        help="per-replica batch (`mnist_horovod.py:44`)")
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--momentum", default=0.0, type=float,
                        help="0 = the reference's plain SGD "
                             "(`mnist_horovod.py:50`)")
    parser.add_argument("--log-every", default=5, type=int,
                        help="loss print interval in batches "
                             "(`mnist_horovod.py:65`)")
    parser.add_argument("--limit", default=0, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu' (plain PyTorch)")
    args = parser.parse_args(argv)

    import torch

    from tpudist_torch.data.loader import ShardedLoader
    from tpudist_torch.data.mnist import load_mnist
    from tpudist_torch.models import ConvNet
    from tpudist_torch.ops.losses import nll_loss
    from tpudist_torch.parallel import broadcast_params, make_dp_train_step
    from tpudist_torch.runtime import initialize, shutdown
    from tpudist_torch.train import TrainState, sgd
    from tpudist_torch.utils.device import resolve_device

    ctx = initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    global_batch = args.batch_size * ctx.process_count  # per-replica flag

    train_ds = load_mnist("train", n=args.limit or None)
    loader = ShardedLoader([train_ds.images, train_ds.labels], global_batch,
                           shuffle=True, prefetch=2, device=device)
    model = ConvNet(device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))

    def loss_fn(model, batch, generator):
        x, y = batch
        return nll_loss(model(x, train=True, generator=generator), y), {}

    state = TrainState.create(broadcast_params(model),  # hvd.broadcast_
                              sgd(args.lr, momentum=args.momentum or None),
                              seed=args.seed)
    train_step = make_dp_train_step(loss_fn)

    final_loss = float("nan")
    try:
        for epoch in range(args.epochs):
            for batch_idx, batch in enumerate(loader.epoch(epoch)):
                state, metrics = train_step(state, *batch)
                if batch_idx % args.log_every == 0:
                    final_loss = float(metrics["loss"])
                    if ctx.is_coordinator:
                        print(f"Train Epoch: {epoch} [{batch_idx * global_batch}"
                              f"/{len(train_ds)}]\tLoss: {final_loss:.6f}")
    finally:
        shutdown()
    return final_loss


if __name__ == "__main__":
    main()
