"""Data-parallel MNIST training on NVIDIA GPUs (the PyTorch port), the twin
of ``mnist_ddp_elastic_tpu.py`` and of the reference's
``pytorch_elastic/mnist_ddp_elastic.py``.

The reference recipe: an MLP(784 -> 1024 x 5 -> 10), Adam lr=1e-3,
cross-entropy, batch 128 per rank, a snapshot every ``save_every``
epochs, resume from the snapshot on (re)start, a test pass every epoch,
the wall clock printed at exit (``mnist_ddp_elastic.py:192-213``).  Here
``tpudist_torch``'s ``Trainer``: each process drives one device and
all-reduces its gradients over the world.  Restart = rerun this script:
the snapshot restores the parameters, the optimizer, the seed and the
step.  A world that changes size while it trains (TTL rendezvous,
commit/rollback, the lr rescale) is ``tpudist_torch.elastic``'s worker
and ``tpudist_torch.runtime.launch``; ``horovod_mnist_elastic_gpu.py``
drives them.

Run (one card):   python3 examples/mnist_ddp_elastic_gpu.py 5 1
Run (N cards):    torchrun --nproc-per-node N \\
                      examples/mnist_ddp_elastic_gpu.py 5 1
Real handwriting (``data/real_digits.npz``, held-out accuracy >= 0.90):
                  python3 examples/mnist_ddp_elastic_gpu.py 12 100 \\
                      --batch_size 16 --data real_digits
Run (CPU, plain PyTorch, tiny):
                  python3 examples/mnist_ddp_elastic_gpu.py 1 1 \\
                      --device cpu --limit 256 --features 64
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("total_epochs", type=int,
                        help="Total epochs to train the model")
    parser.add_argument("save_every", type=int,
                        help="How often to save a snapshot")
    parser.add_argument("--batch_size", default=128, type=int,
                        help="Input batch size on each process (default: "
                             "128); the global batch is this times the "
                             "world size, like the reference's per-rank "
                             "DataLoader batch")
    parser.add_argument("--snapshot-path", default="snapshot.npz")
    parser.add_argument("--limit", default=0, type=int,
                        help="cap dataset size (0 = full)")
    parser.add_argument("--data", default="auto",
                        choices=["auto", "real_digits"],
                        help="'auto': real MNIST if IDX files are on disk "
                             "(TPUDIST_MNIST_DIR or ./data/MNIST/raw), "
                             "synthetic otherwise; 'real_digits': the "
                             "committed real-handwriting set "
                             "(data/real_digits.npz)")
    parser.add_argument("--features", default=1024, type=int)
    parser.add_argument("--hidden-layers", default=5, type=int)
    parser.add_argument("--steps-per-dispatch", default=1, type=int,
                        help="optimizer steps per call of the train loop; "
                             "numerics identical to stepwise")
    parser.add_argument("--seed", default=0, type=int,
                        help="seed of the weights and the step's random "
                             "stream")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu' (plain PyTorch)")
    args = parser.parse_args(argv)

    import dataclasses

    import torch

    import tpudist_torch
    from tpudist_torch.data.loader import ShardedLoader
    from tpudist_torch.data.mnist import load_mnist, load_real_digits
    from tpudist_torch.models import MLP
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.runtime import initialize, shutdown
    from tpudist_torch.train import adam
    from tpudist_torch.utils.device import resolve_device

    ctx = initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    limit = args.limit or None
    if args.data == "real_digits":
        def cap(ds):
            return dataclasses.replace(
                ds, images=ds.images[:limit], labels=ds.labels[:limit]
            ) if limit else ds

        train_ds = cap(load_real_digits("train"))
        test_ds = cap(load_real_digits("test"))
    else:
        train_ds = load_mnist("train", n=limit)
        test_ds = load_mnist("test", n=limit)

    # MLP(5, 1024) and Adam(1e-3): the reference's load_train_objs
    # (`mnist_ddp_elastic.py:162-175`)
    model = MLP(hidden_layers=args.hidden_layers, features=args.features,
                device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    # per-process flag (the reference's per-rank DataLoader batch) ->
    # the global TrainerConfig value
    global_batch = args.batch_size * ctx.process_count
    cfg = tpudist_torch.TrainerConfig(
        total_epochs=args.total_epochs, save_every=args.save_every,
        batch_size=global_batch, snapshot_path=args.snapshot_path,
        steps_per_dispatch=args.steps_per_dispatch)
    train_loader = ShardedLoader([train_ds.images, train_ds.labels],
                                 cfg.batch_size, shuffle=False, prefetch=2,
                                 device=device)
    test_loader = ShardedLoader([test_ds.images, test_ds.labels],
                                cfg.batch_size, drop_last=False,
                                device=device)
    trainer = tpudist_torch.Trainer(cfg, model, adam(1e-3), None,
                                    train_loader, test_loader,
                                    loss_fn=cross_entropy, seed=args.seed)
    start = time.time()
    try:
        summary = trainer.train()
    finally:
        shutdown()
    elapsed = time.time() - start
    if ctx.is_coordinator:
        # the reference's exit print (`mnist_ddp_elastic.py:210-213`)
        print(f"Training completed in: {elapsed:.2f} seconds")
        print(f"Summary: {summary}")
    return summary


if __name__ == "__main__":
    main()
