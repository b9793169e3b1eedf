"""Trainer (counterpart of :mod:`tpudist.train.trainer`), the twin of the
DDP elastic example's ``Trainer`` (``mnist_ddp_elastic.py:30-130``):
snapshot load on start, per-epoch train and test, periodic snapshot
save.  The model is not wrapped in DDP: the step
(:func:`~tpudist_torch.parallel.data_parallel.make_dp_train_step`)
all-reduces the gradients over the data axis itself.

As in tpudist, beyond the reference:
* a snapshot holds the parameters, the optimizer's state, the seed, the
  step and the epochs run, so a resume is exact (the reference saves the
  model and the epoch count, ``mnist_ddp_elastic.py:99-102``);
* only rank 0 writes snapshots, asynchronously (the copies start before
  ``save`` returns; the disk write overlaps the next epoch);
* ``test()`` sums exact correct counts over the data axis, padding
  excluded, with one host sync per evaluation.

A :class:`~tpudist_torch.parallel.mesh.MeshSpec` (passed as ``mesh``,
or parsed from ``config.mesh_axes``) selects how the model trains by axis
sizes: dp, fsdp, tp and ep through
:func:`~tpudist_torch.parallel.mesh.make_composed_train_step` on a state
sharded by :func:`~tpudist_torch.parallel.mesh.make_composed_state`
(pipelines, ``pp > 1``, are driven through the composed step directly).
Snapshots of a sharded state hold the whole parameters and optimizer
state, gathered from every process, and a restore cuts them again.

Telemetry as tpudist's: ``train/*`` counters, gauges and the step-time
histogram; spans ``train_epoch``, ``train_step`` / ``train_dispatch``,
``snapshot_save`` and ``cost_probe``; a flight-recorder guard around
:meth:`Trainer.train`; and, per epoch, ``xla/step_tflops`` / ``xla/mfu``
from the first step's FLOPs (counted as it runs, by
:func:`~tpudist_torch.obs.xla.cost_flops`) and the card's memory gauges.
tpudist's recorder also keeps the step's HLO text; the port has no
program text to keep.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from tpudist_torch import obs
from tpudist_torch.data.device_prefetch import device_prefetch
from tpudist_torch.data.loader import ShardedLoader
from tpudist_torch.elastic.checkpoint import Checkpointer, restore_pytree
from tpudist_torch.obs import xla as obs_xla
from tpudist_torch.ops.losses import cross_entropy
from tpudist_torch.parallel.data_parallel import (
    broadcast_params,
    make_dp_masked_eval_step,
    make_dp_train_loop,
    make_dp_train_step,
)
from tpudist_torch.parallel.mesh import (
    MeshSpec,
    _mesh_size,
    make_composed_eval_step,
    make_composed_state,
    make_composed_train_step,
)
from tpudist_torch.parallel.pipeline import state_specs_like
from tpudist_torch.parallel.tensor_parallel import gather_tree, shard_tree
from tpudist_torch.runtime.distributed import process_index
from tpudist_torch.train.state import (
    OptimizerFactory,
    TrainState,
    init_optimizer_state,
)
from tpudist_torch.utils.config import config_field
from tpudist_torch.utils.logging import get_logger
from tpudist_torch.utils.metrics import (
    MetricLogger,
    ThroughputMeter,
    maybe_profile,
)

log = get_logger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    """CLI-overridable twin of the reference's argparse surface
    (``mnist_ddp_elastic.py:203-208``)."""

    total_epochs: int = config_field(5, "epochs to train")
    save_every: int = config_field(1, "snapshot period in epochs")
    batch_size: int = config_field(
        128, "GLOBAL batch size (reference default 128)")
    snapshot_path: str = config_field("snapshot.npz", "snapshot file")
    log_every: int = config_field(50, "log every N steps")
    eval_every_epoch: bool = config_field(
        True, "run test() after every epoch")
    profile_dir: str = config_field(
        "", "write a torch.profiler Chrome trace of the first trained epoch "
            "here")
    steps_per_dispatch: int = config_field(
        1,
        "optimizer steps per call of the train loop, over stacked "
        "batches (make_dp_train_loop); numerics identical to stepwise")
    device_prefetch: int = config_field(
        2,
        "train batches whose host-to-device copies are kept in flight "
        "ahead of the step on a side stream "
        "(tpudist_torch.data.device_prefetch); 0 = copy each batch when "
        "the step asks for it; numerics identical either way")
    async_snapshot: bool = config_field(
        True,
        "snapshot saves block only to start the copies; the disk write "
        "overlaps the next epoch (Checkpointer async_save); False makes "
        "saves fully synchronous")
    mesh_axes: str = config_field(
        "",
        "composed-mesh axis sizes, e.g. 'dp=2,fsdp=2,tp=2' — selects HOW "
        "the model trains by axis size instead of strategy function "
        "(tpudist_torch.parallel.mesh.MeshSpec); empty keeps the "
        "data-parallel path over the provided mesh")


class Trainer:
    def __init__(
        self,
        config: TrainerConfig,
        model: nn.Module,
        optimizer: OptimizerFactory,
        mesh: DeviceMesh | MeshSpec | None,
        train_loader: ShardedLoader,
        test_loader: ShardedLoader | None = None,
        loss_fn: Callable = cross_entropy,
        train_kwargs: dict | None = None,
        seed: int = 0,
        params: dict | None = None,
    ) -> None:
        """``model`` is an ``nn.Module`` on its device; ``optimizer``
        builds its optimizer (:func:`~tpudist_torch.train.state.adam`,
        :func:`~tpudist_torch.train.state.sgd`); ``mesh`` is a data mesh,
        None (the whole world) or a :class:`MeshSpec` (its mesh is built
        here); ``loss_fn(logits, labels)``; ``train_kwargs`` go to the
        model's forward in training (e.g. ``{"train": True}`` for the
        ConvNet's dropout).  Under a mesh spec the state is sharded from
        the whole model's ``params`` (a ``state_dict``; default: rank 0's
        ``model``, which is then built unsharded)."""
        self.mesh_spec: MeshSpec | None = None
        if isinstance(mesh, MeshSpec):
            self.mesh_spec, mesh = mesh, None
        elif config.mesh_axes:
            self.mesh_spec = MeshSpec.parse(config.mesh_axes)
            for name, size in self.mesh_spec.axis_sizes().items():
                if _mesh_size(mesh, name) != size:
                    have = {a: _mesh_size(mesh, a) for a in
                            (getattr(mesh, "mesh_dim_names", None) or ())}
                    raise ValueError(
                        f"config.mesh_axes={config.mesh_axes!r} wants axis "
                        f"{name}={size} but the provided mesh has {have}; "
                        "build it with MeshSpec.parse(config.mesh_axes)"
                        ".build()")
        elif not (mesh is None or isinstance(mesh, DeviceMesh)):
            raise TypeError(f"mesh must be a DeviceMesh, a MeshSpec or "
                            f"None, got {type(mesh).__name__}")
        if self.mesh_spec is not None and self.mesh_spec.pp > 1:
            raise ValueError(
                "Trainer's epoch/eval/snapshot loop assumes a "
                "(state, inputs, labels) step; pipeline (pp > 1) training "
                "uses stage-stacked params and a schedule-specific batch "
                "layout — drive make_composed_train_step directly (see "
                "tpudist_torch/parallel/pipeline.py)")
        if self.mesh_spec is not None and mesh is None:
            mesh = self.mesh_spec.build()
        self.config = config
        self.mesh = mesh
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.epochs_run = 0
        train_kwargs = train_kwargs or {}
        if config.batch_size != train_loader.global_batch:
            raise ValueError(
                f"TrainerConfig.batch_size={config.batch_size} does not "
                f"match train_loader.global_batch="
                f"{train_loader.global_batch}; the config value is the "
                "single source of truth for the CLI surface")

        def dp_loss(model, batch, generator):
            inputs, labels = batch
            logits = model(inputs, generator=generator, **train_kwargs)
            return loss_fn(logits, labels), {}

        def dp_predict(model, inputs):
            return model(*inputs)

        spec = self.mesh_spec
        self._param_specs = None
        if spec is None:
            self.state = TrainState.create(broadcast_params(model, mesh),
                                           optimizer, seed=seed)
        else:
            if params is None:
                params = {k: v.detach().clone() for k, v in
                          broadcast_params(model).state_dict().items()}
            self.state, self._param_specs = make_composed_state(
                model, params, optimizer, spec, mesh, seed=seed)
        # one save path with the elastic runtime's: the flat layout keeps
        # the reference's rolling snapshot.npz
        self._ckpt = Checkpointer(config.snapshot_path,
                                  async_save=config.async_snapshot,
                                  layout="flat")
        self._maybe_load_snapshot()
        if spec is None:
            self.train_step = make_dp_train_step(dp_loss, mesh)
            self.train_loop = (make_dp_train_loop(dp_loss, mesh)
                               if config.steps_per_dispatch > 1 else None)
            self.eval_step = make_dp_masked_eval_step(dp_predict, mesh)
        else:
            pure_dp = spec.fsdp == spec.tp == spec.ep == 1
            self.train_step = make_composed_train_step(
                spec, mesh, dp_loss,
                param_specs=None if pure_dp else self._param_specs)
            if config.steps_per_dispatch > 1:
                if not pure_dp:
                    raise ValueError(
                        "steps_per_dispatch > 1 (the stacked dp loop) is "
                        "data-parallel only; set it to 1 for fsdp/tp/ep "
                        "specs")
                self.train_loop = make_dp_train_loop(dp_loss, mesh,
                                                     axis="dp")
            else:
                self.train_loop = None
            self.eval_step = make_composed_eval_step(
                dp_predict, mesh, self._param_specs, spec.data_axes())
        self.metrics = MetricLogger()
        self.throughput = ThroughputMeter(warmup_steps=2)
        # obs handles cached once: the hot loop touches them by attribute.
        # Recording stays lazy — the loss gauge takes the device scalar
        # as it is, counters take host ints, the step-time histogram
        # host floats — so nothing here adds a sync to the step path
        # (snapshot() pays the one batched copy)
        self._obs_steps = obs.counter("train/steps", unit="steps")
        self._obs_examples = obs.counter("train/examples", unit="examples")
        self._obs_epochs = obs.counter("train/epochs", unit="epochs")
        self._obs_loss = obs.gauge("train/loss")
        self._obs_tput = obs.gauge("train/images_per_sec", unit="img/s")
        self._obs_step_time = obs.histogram("train/step_time", unit="s")
        # per-optimizer-step FLOPs, counted on the first call; feeds the
        # live MFU gauge
        self._step_flops: float | None = None
        self._cost_probed = False

    def _call(self, fn, steps_per_dispatch: int, *batch):
        """``fn(state, *batch)``; the first call runs under the FLOP
        counter (the ``cost_probe`` span), so the probe is a step the
        trainer takes anyway, never an extra one."""
        if self._cost_probed:
            return fn(self.state, *batch)
        self._cost_probed = True
        out: list = []
        try:
            with obs.span("cost_probe"):
                flops = obs_xla.cost_flops(
                    lambda: out.append(fn(self.state, *batch)))
            if flops is not None:
                self._step_flops = flops / steps_per_dispatch
        except Exception as e:  # noqa: BLE001 - telemetry must not stop training
            if not out:
                raise
            log.debug("cost probe failed: %s", e)
        return out[0]

    # -- snapshots (the reference's _save_snapshot/_load_snapshot, full
    # state)

    def _snapshot_tree(self) -> dict:
        """The parameters and the optimizer's state; under a mesh spec
        gathered whole from every process's blocks (a collective)."""
        params = self.state.model.state_dict()
        opt = self.state.optimizer.state_dict()["state"]
        if self._param_specs is None:
            return {"params": params, "opt_state": opt}
        opt_specs = self._opt_specs()
        return {"params": gather_tree(params, self.mesh, self._param_specs),
                "opt_state": {i: gather_tree(v, self.mesh, opt_specs[i])
                              for i, v in opt.items()}}

    def _opt_specs(self) -> dict:
        return state_specs_like(self.state, self._param_specs)["opt_state"]

    def _snapshot_found(self) -> bool:
        """Whether the snapshot exists, as process 0 sees it, on every
        process: process 0 writes it (asynchronously) and a sharded
        restore is a collective, so the others must not decide on a file
        still being written."""
        found = os.path.exists(self.config.snapshot_path)
        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return found
        flag = torch.tensor([int(found)],
                            device=next(self.state.model.parameters()).device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def _maybe_load_snapshot(self) -> None:
        if not self._snapshot_found():
            return
        opt = init_optimizer_state(self.state.optimizer)
        tree, meta = restore_pytree(self.config.snapshot_path,
                                    self._snapshot_tree())
        params = {k: v for k, v in tree["params"].items()}
        opt_state = {int(k): v for k, v in tree["opt_state"].items()}
        if self._param_specs is not None:
            opt_specs = self._opt_specs()
            params = shard_tree(params, self.mesh, self._param_specs)
            opt_state = {i: shard_tree(v, self.mesh, opt_specs[i])
                         for i, v in opt_state.items()}
        self.state.model.load_state_dict(params)
        sd = opt.state_dict()
        sd["state"] = opt_state
        opt.load_state_dict(sd)
        self.state.step = int(meta.get("step", 0))
        self.state.seed = int(meta.get("seed", self.state.seed))
        self.epochs_run = int(meta.get("epochs_run", 0))
        log.info("Resuming from snapshot at epoch %d", self.epochs_run)

    def _save_snapshot(self, epoch: int) -> None:
        tree = self._snapshot_tree()
        if process_index() != 0:
            return
        with obs.span("snapshot_save", epoch=epoch):
            self._ckpt.save(epoch, tree,
                            meta={"epochs_run": epoch + 1,
                                  "step": self.state.step,
                                  "seed": self.state.seed})
        log.info("Epoch %d | snapshot save started to %s (async=%s, "
                 "blocked %.4f s)", epoch, self.config.snapshot_path,
                 self._ckpt.async_save, self._ckpt.last_blocked_s)

    # -- the hot loop (the reference's _run_epoch/_run_batch)

    def _feed(self, epoch: int, n_steps: int = 0, start_step: int = 0):
        """This epoch's batches on the device, through one prefetch
        layer: the loader's own when it runs ahead on a thread
        (``thread_prefetch``), else ``config.device_prefetch`` batches
        copied ahead on a side stream (0: the loader copies each batch
        when the step asks).  ``n_steps`` > 0 gives the stacked groups."""
        loader = self.train_loader
        if self.config.device_prefetch > 0 and not loader.thread_prefetch:
            host = (loader.host_epoch_stacked(epoch, n_steps) if n_steps
                    else loader.host_epoch(epoch, start_step))
            return device_prefetch(host, depth=self.config.device_prefetch,
                                   device=loader.device)
        return (loader.epoch_stacked(epoch, n_steps) if n_steps
                else loader.epoch(epoch, start_step=start_step))

    def _run_epoch(self, epoch: int) -> dict:
        self.throughput.start()
        loader = self.train_loader
        n = self.config.steps_per_dispatch
        last = loader.steps_per_epoch - 1
        start_step = 0
        if self.train_loop is not None:
            start_step = loader.stacked_groups(n) * n
            for g, batch in enumerate(self._feed(epoch, n_steps=n)):
                t0 = time.perf_counter()
                with obs.span("train_dispatch", steps=n):
                    self.state, metrics = self._call(self.train_loop, n,
                                                     *batch)
                # stacked [n] metrics; every optimizer step weighs equally
                self.metrics.update(**metrics)
                self.throughput.step(n * loader.global_batch,
                                     block=(g + 1) * n - 1 == last)
                # the loss gauge keeps the stacked device tensor; its last
                # element is folded out at snapshot time, never here
                self._obs_loss.set(metrics["loss"])
                self._obs_steps.inc(n)
                self._obs_examples.inc(n * loader.global_batch)
                self._obs_step_time.record((time.perf_counter() - t0) / n)
                if (g * n) % self.config.log_every < n:
                    loss = float(metrics["loss"][-1])
                    log.info("epoch %d step %d loss %.4f", epoch,
                             g * n + n - 1, loss)
                    # flight-recorder breadcrumb at log granularity: the
                    # loss is already on the host here, no extra sync
                    obs.recorder.record("train_log", epoch=epoch,
                                        step=g * n + n - 1, loss=loss)
        for step, batch in enumerate(self._feed(epoch,
                                                start_step=start_step),
                                     start=start_step):
            t0 = time.perf_counter()
            with obs.span("train_step", step=step):
                self.state, metrics = self._call(self.train_step, 1,
                                                 *batch)
            # device scalars kept as they are: one host sync per epoch
            # (and at log points), not per step
            self.metrics.update(**metrics)
            self.throughput.step(loader.global_batch, block=step == last)
            self._obs_loss.set(metrics["loss"])
            self._obs_steps.inc()
            self._obs_examples.inc(loader.global_batch)
            # dispatch time unless TPUDIST_OBS_FENCE=1 makes spans fence
            self._obs_step_time.record(time.perf_counter() - t0)
            if step % self.config.log_every == 0:
                loss = float(metrics["loss"])
                log.info("epoch %d step %d loss %.4f", epoch, step, loss)
                obs.recorder.record("train_log", epoch=epoch, step=step,
                                    loss=loss)
        return self.metrics.reset()

    def train(self, max_epochs: int | None = None) -> dict:
        # any unhandled exception dumps a post-mortem bundle (event ring,
        # final snapshot) before propagating
        with obs.recorder.guard("trainer", epochs_run=self.epochs_run):
            return self._train(max_epochs)

    def _train(self, max_epochs: int | None = None) -> dict:
        max_epochs = max_epochs or self.config.total_epochs
        summary: dict = {}
        start_epoch = self.epochs_run
        for epoch in range(start_epoch, max_epochs):
            profiling = self.config.profile_dir and epoch == start_epoch
            with maybe_profile(self.config.profile_dir if profiling
                               else None):
                with obs.span("train_epoch", epoch=epoch):
                    epoch_metrics = self._run_epoch(epoch)
            self._obs_epochs.inc()
            self._obs_tput.set(self.throughput.items_per_sec)
            # live efficiency gauges, refreshed per epoch: TFLOP/s (and
            # MFU on a known card) from the first step's FLOPs over the
            # measured mean step time, and the card's allocator gauges
            # (nothing on the CPU)
            obs_xla.note_step(self.throughput.mean_step_time,
                              self._step_flops)
            obs_xla.update_memory_gauges()
            obs.recorder.record(
                "epoch_end", epoch=epoch,
                loss=epoch_metrics.get("loss"),
                images_per_sec=round(self.throughput.items_per_sec, 2))
            summary = {"epoch": epoch, **epoch_metrics}
            if self.config.eval_every_epoch and self.test_loader is not None:
                summary["test_accuracy"] = self.test()
                log.info("epoch %d done | loss %.4f | test acc %.2f%%",
                         epoch, epoch_metrics.get("loss", float("nan")),
                         100 * summary["test_accuracy"])
            if epoch % self.config.save_every == 0:
                self._save_snapshot(epoch)
            self.epochs_run = epoch + 1
        # the last snapshot is on disk when train() returns
        self._ckpt.wait()
        summary["images_per_sec"] = self.throughput.items_per_sec
        return summary

    def test(self) -> float:
        """Exact test accuracy: each real sample counted once (the
        validity mask zeroes the wrap-around padding of a
        ``drop_last=False`` loader) over the true number of samples
        evaluated, with one host sync."""
        if self.test_loader is None:
            raise ValueError("Trainer.test needs a test_loader")
        correct: list = []
        seen: list = []
        for step, batch in enumerate(self.test_loader.epoch(0)):
            mask = self.test_loader.valid_mask(step)
            c, t = self.eval_step(self.state.model, *batch, mask)
            correct.append(c)
            seen.append(t)
        if not seen:
            return 0.0
        c, t = torch.stack([torch.stack(correct).sum(),
                            torch.stack(seen).sum()]).tolist()
        return c / max(t, 1)
