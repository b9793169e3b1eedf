"""Micro-batched ResNet50 pipeline on NVIDIA GPUs (the PyTorch port), the
twin of ``model_parallel_resnet50_tpu.py`` and of the reference's
``rpc/model_parallel_ResNet50.py``.

The reference: two ResNet50 shards on RPC workers, micro-batches chained
master -> worker1 -> worker2 by async RPC, ``dist_autograd`` backward,
``DistributedOptimizer`` SGD lr=0.05, MSE on random one-hot labels, 3
batches of 32 x 3 x 128 x 128, a sweep over ``num_split`` in {4, 8} timed
per sweep (``model_parallel_ResNet50.py:191-262``).  Here
``tpudist_torch.parallel.pipeline``: each process of a ``data x stage``
mesh runs one stage of the GPipe table, activations and cotangents hop
between neighbours by P2P send/recv, the backward walks the table in
reverse.  ``--packed`` holds each stage's parameters only on its own
process (one packed row).

Run (2 cards):   torchrun --nproc-per-node 2 \\
                     examples/model_parallel_resnet50_gpu.py
Run (one card):  python3 examples/model_parallel_resnet50_gpu.py
                 (all stages in this one process: one card holds one NCCL
                 rank, so a one-process run drives every stage here)
Run (CPU, gloo): torchrun --nproc-per-node 2 \\
                     examples/model_parallel_resnet50_gpu.py --device cpu \\
                     --image-size 32 --batch-size 4 --num-splits 2
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
    parser.add_argument("--num-splits", default="4,8",
                        help="micro-batch sweep (`model_parallel_ResNet50.py:257`)")
    parser.add_argument("--batch-size", default=32, type=int,
                        help="global batch (`model_parallel_ResNet50.py:194`)")
    parser.add_argument("--num-batches", default=3, type=int,
                        help="batches per sweep (`model_parallel_ResNet50.py:212`)")
    parser.add_argument("--image-size", default=128, type=int)
    parser.add_argument("--num-classes", default=1000, type=int)
    parser.add_argument("--stages", default=2, type=int)
    parser.add_argument("--lr", default=0.05, type=float)
    parser.add_argument("--remat", action="store_true",
                        help="recompute stage activations in the backward "
                             "(torch.utils.checkpoint)")
    parser.add_argument("--packed", action="store_true",
                        help="stage-shard the parameters (packed buffer: "
                             "each process holds the widest stage, the "
                             "reference's two-shard placement property)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default, NCCL) or 'cpu' (gloo)")
    args = parser.parse_args(argv)

    import torch
    from torch.func import functional_call

    from tpudist_torch.data import synthetic_images
    from tpudist_torch.models import resnet50_stages
    from tpudist_torch.ops.losses import mse_loss
    from tpudist_torch.parallel.pipeline import (
        ParamTree,
        make_packed_pipeline_train_step,
        make_pipeline_train_step,
        pack_stage_params,
        shard_stage_params,
    )
    from tpudist_torch.runtime import initialize, local_block, pipeline_mesh
    from tpudist_torch.train import TrainState, sgd
    from tpudist_torch.utils.device import resolve_device

    ctx = initialize(device=args.device)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if ctx.process_count > 1:
        mesh, local = pipeline_mesh(args.stages), None
    else:
        mesh, local = None, args.stages

    # every process draws every stage's weights from one CPU generator, so
    # the replicas agree without a broadcast
    cpu_stages = resnet50_stages(args.stages, num_classes=args.num_classes,
                                 device="cpu")
    for s, seg in enumerate(cpu_stages):
        seg.init_weights(torch.Generator().manual_seed(s))
    x_np, one_hot_np = synthetic_images(args.batch_size, hw=args.image_size,
                                        num_classes=args.num_classes)
    x, y = torch.from_numpy(x_np), torch.from_numpy(one_hot_np)
    if mesh is not None:
        x, y = (local_block(t, mesh, ("data",)) for t in (x, y))
    x, y = x.to(device), y.to(device)

    results: dict[int, float] = {}
    for num_split in (int(v) for v in str(args.num_splits).split(",")):
        if args.packed:
            templates = resnet50_stages(args.stages,
                                        num_classes=args.num_classes,
                                        device="meta")
            fns = [lambda p, a, m=m: functional_call(m, p, (a,))
                   for m in templates]
            flat, meta = pack_stage_params(
                [seg.state_dict() for seg in cpu_stages])
            model = ParamTree(shard_stage_params(flat, mesh,
                                                 {".": ("stage",)}),
                              device=device)
            state = TrainState.create(model, sgd(args.lr))
            step = make_packed_pipeline_train_step(
                fns, mse_loss, mesh, num_split, meta, state,
                remat=args.remat, local_stages=local)
        else:
            stages = torch.nn.ModuleList(
                resnet50_stages(args.stages, num_classes=args.num_classes,
                                device=device))
            stages.load_state_dict(
                torch.nn.ModuleList(cpu_stages).state_dict())
            state = TrainState.create(stages, sgd(args.lr))
            step = make_pipeline_train_step(
                [lambda m, a: m(a)] * args.stages, mse_loss, mesh,
                num_split, remat=args.remat, local_stages=local)
        # a warm-up step outside the timed region (cuDNN's algorithm
        # choice, the allocator); the reference times its eager RPC
        state, metrics = step(state, x, y)
        float(metrics["loss"])
        tik = time.time()
        for _ in range(args.num_batches):
            state, metrics = step(state, x, y)
        float(metrics["loss"])
        tok = time.time()
        if ctx.process_index == 0:
            print(f"number of splits = {num_split}, execution time = "
                  f"{tok - tik}", flush=True)
        results[num_split] = tok - tik
        del state
    return results


if __name__ == "__main__":
    try:
        main()
    finally:
        from tpudist_torch.runtime import shutdown

        shutdown()
