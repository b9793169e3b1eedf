"""Parameter-server hybrid parallelism on NVIDIA GPUs (the PyTorch port),
the twin of ``server_model_data_parallel_tpu.py`` and of the reference's
``rpc/server_model_data_parallel.py``.

The reference: a master, two trainers and a parameter server; an
``EmbeddingBag(100, 16, mode=sum)`` on the server behind ``RemoteModule``
lookups, each trainer a DDP ``Linear(16, 8)`` over its own random ragged
batches, ``dist_autograd`` + ``DistributedOptimizer`` (SGD lr=0.05)
routing the table's gradients back while gloo all-reduces the dense
ones; 100 epochs x 10 batches, cross-entropy, a progress line every 5
epochs (``server_model_data_parallel.py:71-185``).  Here the roles are
shardings of a ``data x model`` mesh (``tpudist_torch.parallel.
ps_hybrid``): the table's rows are cut over ``model`` (the server), the
dense layer is replicated over ``data`` (the trainers), the lookup is a
masked gather plus one all-reduce over the model group, and each step
averages the gradients as DDP does.

Run (4 cards):   torchrun --nproc-per-node 4 \\
                     examples/server_model_data_parallel_gpu.py
Run (one card):  python3 examples/server_model_data_parallel_gpu.py \\
                     --model-shards 1
Run (CPU, gloo): torchrun --nproc-per-node 4 \\
                     examples/server_model_data_parallel_gpu.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", default=100, type=int,
                        help="`server_model_data_parallel.py:93`")
    parser.add_argument("--batches-per-epoch", default=10, type=int,
                        help="`server_model_data_parallel.py:56`")
    parser.add_argument("--batch-size", default=10, type=int,
                        help="per data shard, like each trainer's stream")
    parser.add_argument("--num-embeddings", default=100, type=int)
    parser.add_argument("--embedding-dim", default=16, type=int)
    parser.add_argument("--num-classes", default=8, type=int)
    parser.add_argument("--model-shards", default=2, type=int)
    parser.add_argument("--lr", default=0.05, type=float)
    parser.add_argument("--log-every", default=5, type=int)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default, NCCL) or 'cpu' (gloo)")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from tpudist_torch.data import ragged_embedding_batches
    from tpudist_torch.models import EmbeddingBagClassifier
    from tpudist_torch.models.mlp import linear_as
    from tpudist_torch.ops.losses import cross_entropy
    from tpudist_torch.parallel.ps_hybrid import make_ps_hybrid_train_step
    from tpudist_torch.runtime import (
        data_model_mesh,
        initialize,
        local_block,
    )
    from tpudist_torch.train import TrainState, sgd
    from tpudist_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ctx = initialize(device=device)
    if ctx.process_count == 1:
        # one process: a group of one, so the mesh and its step are the same
        initialize(store=dist.HashStore(), world_size=1, rank=0,
                   device=device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = data_model_mesh(args.model_shards)
    data_shards = mesh.size(0)
    global_batch = args.batch_size * data_shards

    # the whole table from one CPU generator on every process, then each
    # keeps its rows
    full = EmbeddingBagClassifier(args.num_embeddings, args.embedding_dim,
                                  args.num_classes, device="cpu")
    full.init_weights(torch.Generator().manual_seed(0))
    if args.num_embeddings % args.model_shards:
        raise SystemExit(f"{args.num_embeddings} rows not divisible by "
                         f"{args.model_shards} model shards")
    model = EmbeddingBagClassifier(
        args.num_embeddings // args.model_shards, args.embedding_dim,
        args.num_classes, device=device)
    sd = full.state_dict()
    sd["embedding"] = local_block(sd["embedding"], mesh, ("model",))
    model.load_state_dict(sd)

    def dense_apply(m, bag):
        return linear_as(bag, m.fc, torch.float32).float()

    state = TrainState.create(model, sgd(args.lr))
    step = make_ps_hybrid_train_step(
        dense_apply, cross_entropy, mesh, state,
        num_embeddings=args.num_embeddings)

    loss = float("nan")
    for epoch in range(args.epochs):
        stream = ragged_embedding_batches(
            args.batches_per_epoch, batch=global_batch,
            num_embeddings=args.num_embeddings,
            num_classes=args.num_classes, seed=epoch)
        for indices, mask, target in stream:
            batch = [local_block(torch.from_numpy(a), mesh, ("data",))
                     .to(device) for a in (indices, mask, target)]
            state, metrics = step(state, *batch)
        if epoch % args.log_every == 0:
            loss = float(metrics["loss"])
            # `server_model_data_parallel.py:110-111` progress print
            if ctx.process_index == 0:
                print(f"Training done for epoch {epoch} | loss {loss:.4f}",
                      flush=True)
    return float(metrics["loss"])


if __name__ == "__main__":
    try:
        main()
    finally:
        from tpudist_torch.runtime import shutdown

        shutdown()
