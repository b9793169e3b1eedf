"""One mesh-axis spec: declarative dp × fsdp × tp × pp × ep composition
(counterpart of :mod:`tpudist.parallel.mesh`).

:class:`MeshSpec` replaces strategy selection with axis sizes: declare
``MeshSpec(dp=2, fsdp=2, tp=2)``, build ONE five-axis ``DeviceMesh``
(``dp, fsdp, ep, pp, tp``, row-major, ``tp`` varying fastest) over the
processes, and :func:`make_composed_train_step` returns one step for that
point of the composition space, assembled from the strategies' building
blocks:

* ``dp``   — batch replication; gradients averaged over the axis;
* ``fsdp`` — ZeRO-3 (:func:`~tpudist_torch.parallel.fsdp.fsdp_specs`:
  the largest free divisible dimension of every leaf, gathered before use
  and reduce-scattered after);
* ``tp``   — the Megatron layout from the rules (``spec.rules``, e.g.
  :func:`~tpudist_torch.parallel.tensor_parallel.transformer_tp_rules`
  over ``"tp"``), the model built with ``tp_axis="tp"``;
* ``ep``   — expert sharding (:func:`~tpudist_torch.parallel.
  expert_parallel.moe_ep_rules` over ``"ep"``), the model built with
  ``ep_axis="ep", ep_tokens="replicated"``: tokens stay sharded over
  ``dp × fsdp`` alone, as tpudist's GSPMD program runs them;
* ``pp``   — a pipeline schedule over the ``pp`` axis (GPipe stacked
  blocks with ``tp``, or 1F1B / interleaved).

Rule precedence as in tpudist: the ``tp``/``ep`` rules claim dimensions
first (first match wins), then ``fsdp`` shards the largest dimension left
free; a leaf with none replicates over ``fsdp``; ``dp`` shards only the
batch.  tpudist publishes the axis sizes and the bubble to its obs
registry; the port keeps them as the step's ``mesh_gauges`` until the obs
layer is ported (ROADMAP Queue A 10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist
from torch import nn

from tpudist_torch.runtime.mesh import axis_size

Rules = Sequence

MESH_AXES = ("dp", "fsdp", "ep", "pp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis sizes + sharding rules: the one declarative knob for how a
    model trains.  ``rules`` are path-pattern → spec pairs over the
    canonical axis names (``transformer_tp_rules("tp")``,
    ``moe_ep_rules("ep")``; concatenate for MoE × TP, first match wins).
    ``num_microbatches`` / ``virtual_stages`` parameterise the pipeline
    schedule and are ignored at ``pp == 1``."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    rules: Rules = ()
    num_microbatches: int = 1
    virtual_stages: int = 1

    def __post_init__(self) -> None:
        for name in MESH_AXES:
            if getattr(self, name) < 1:
                raise ValueError(f"axis {name!r} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.num_microbatches < 1 or self.virtual_stages < 1:
            raise ValueError("num_microbatches and virtual_stages must be "
                             ">= 1")

    @classmethod
    def parse(cls, text: str, **kwargs) -> "MeshSpec":
        """``MeshSpec.parse("dp=2,fsdp=2,tp=2")`` — the CLI spelling."""
        sizes: dict[str, int] = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            if name not in MESH_AXES:
                raise ValueError(
                    f"unknown mesh axis {name!r}; valid: {MESH_AXES}")
            sizes[name] = int(val)
        return cls(**sizes, **kwargs)

    def axis_sizes(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in MESH_AXES}

    @property
    def n_devices(self) -> int:
        return math.prod(self.axis_sizes().values())

    @property
    def n_stages(self) -> int:
        """Stacked depth of the pipeline parameter stack (P·V chunks)."""
        return self.pp * self.virtual_stages

    def data_axes(self) -> tuple[str, ...]:
        """Mesh axes the batch dimension shards over (``dp`` alone under
        pipelining)."""
        return ("dp",) if self.pp > 1 else ("dp", "fsdp")

    def batch_spec(self) -> tuple:
        return (self.data_axes(),)

    def build(self, devices: Sequence | None = None):
        """One mesh, all five axes (size-1 axes included), over every
        process of the process group: a process a device.  ``devices``,
        when given, must be one per process."""
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError("MeshSpec.build needs a process group: call "
                               "tpudist_torch.runtime.initialize() first")
        n = dist.get_world_size() if devices is None else len(devices)
        if n != self.n_devices or dist.get_world_size() != self.n_devices:
            raise ValueError(
                f"{self.axis_sizes()} needs {self.n_devices} devices, got "
                f"{n}")
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(device_type,
                                tuple(self.axis_sizes().values()),
                                mesh_dim_names=MESH_AXES)

    def param_specs(self, params: Any) -> dict[str, tuple]:
        """``{name: spec}`` for the non-pipeline axes of ``params`` (a
        module or a mapping): the rules claim dimensions for ``tp``/``ep``
        first, then ``fsdp`` shards the largest remaining divisible
        dimension of every leaf."""
        from tpudist_torch.parallel.fsdp import fsdp_specs
        from tpudist_torch.parallel.tensor_parallel import (
            spec_tree_from_rules,
        )

        if self.fsdp > 1:
            return fsdp_specs(params, {"fsdp": self.fsdp}, axis="fsdp",
                              tp_rules=self.rules or None)
        return spec_tree_from_rules(params, self.rules)


def _mesh_size(mesh, name: str) -> int | None:
    if name not in (getattr(mesh, "mesh_dim_names", None) or ()):
        return None
    return axis_size(mesh, name)


def shard_composed_batch(batch: Any, mesh, spec: MeshSpec) -> Any:
    """This process's rows of the batch tensors: the leading dimension
    cut over the spec's data axes (``dp×fsdp``, or ``dp`` under
    pipelining)."""
    from tpudist_torch.parallel.tensor_parallel import shard_batch

    return shard_batch(batch, mesh, spec.data_axes())


def mesh_gauges(spec: MeshSpec, bubble: float) -> dict[str, float]:
    """tpudist's gauges of a composed step: each axis size and the
    schedule's bubble (0.0 off-pipeline)."""
    out = {f"mesh/axis_size~axis={name}": float(size)
           for name, size in spec.axis_sizes().items()}
    out["train/bubble_fraction"] = float(bubble)
    return out


def make_composed_train_step(
    spec: MeshSpec,
    mesh,
    loss_fn: Callable | None = None,
    *,
    params: Any = None,
    state_example: Any = None,
    block_fn: Callable | None = None,
    stage_loss_fn: Callable | None = None,
    embed_fn: Callable | None = None,
    head_loss_fn: Callable | None = None,
    state_specs: Any = None,
    grad_sync_axes: Any = None,
    schedule: str = "1f1b",
    donate: bool = True,
    param_specs: Mapping[str, tuple] | None = None,
):
    """One ``train_step(state, *batch) -> (state, metrics)`` for any point
    of the dp × fsdp × tp × pp × ep composition space:

    * ``pp == 1``, everything else 1 → the data-parallel step over ``dp``
      (:func:`~tpudist_torch.parallel.data_parallel.make_dp_train_step`);
    * ``pp == 1``, any of fsdp/tp/ep > 1 → the per-shard step
      (:func:`~tpudist_torch.parallel.tensor_parallel.make_spmd_train_step`)
      under ``spec.param_specs(params)``, the batch over ``dp × fsdp``:
      fsdp-sharded leaves gathered and reduce-scattered over ``fsdp``.
      ``loss_fn(model, batch, generator)`` (the mean over this process's
      rows) and ``params`` (the model laid out for the spec, or
      ``state_example``) are required.  ``param_specs`` given takes this
      path at any sizes (a mesh of one-process axes then issues every
      collective of the sharded step, as ``chip_smoke.py`` runs it on
      one card);
    * ``pp > 1`` → a pipeline schedule over ``pp`` with ``dp`` riding
      along: ``tp > 1`` or ``schedule="gpipe"`` the stacked GPipe step
      (:func:`~tpudist_torch.parallel.pipeline.
      make_stacked_pipeline_train_step`; ``state_specs`` /
      ``grad_sync_axes`` for tensor-parallel blocks), else 1F1B /
      interleaved (``embed_fn``/``head_loss_fn`` for the real-model
      mode).  ``fsdp``/``ep`` under ``pp`` are rejected.

    The step has ``.param_specs``, ``.bubble_fraction`` (0.0
    off-pipeline), ``.mesh_spec`` and ``.mesh_gauges``."""
    from tpudist_torch.parallel.data_parallel import make_dp_train_step
    from tpudist_torch.parallel.pipeline import (
        make_1f1b_pipeline_train_step,
        make_stacked_pipeline_train_step,
    )
    from tpudist_torch.parallel.tensor_parallel import make_spmd_train_step

    for name in MESH_AXES:
        if _mesh_size(mesh, name) != getattr(spec, name):
            raise ValueError(
                f"mesh axis {name!r} is {_mesh_size(mesh, name)} but spec "
                f"says {getattr(spec, name)}; build the mesh with "
                f"spec.build()")
    if spec.pp == 1:
        if loss_fn is None:
            raise ValueError("pp == 1 composition requires loss_fn "
                             "(model, batch, generator) -> (loss, aux)")
        if spec.fsdp == spec.tp == spec.ep == 1 and param_specs is None:
            step = make_dp_train_step(loss_fn, mesh, axis="dp",
                                      donate=donate)
            step.param_specs = None
        else:
            if param_specs is None:
                if params is None:
                    params = getattr(state_example, "model", None)
                if params is None:
                    raise ValueError(
                        "fsdp/tp/ep composition needs example params (pass "
                        "params= or state_example=) to derive sharding "
                        "specs")
                param_specs = spec.param_specs(params)
            step = make_spmd_train_step(loss_fn, mesh, param_specs, donate,
                                        batch_axes=spec.data_axes())
        step.bubble_fraction = 0.0
    else:
        if spec.fsdp > 1 or spec.ep > 1:
            raise ValueError(
                f"pp={spec.pp} with fsdp={spec.fsdp}/ep={spec.ep} is not "
                "supported: pipeline stages already shard parameters over "
                "the pp axis; combine pp with dp and tp, or drop pp and "
                "use fsdp×tp×ep")
        if block_fn is None or state_example is None:
            raise ValueError(
                "pp > 1 composition requires block_fn and state_example "
                "(stage-stacked params — see pipeline.py)")
        if spec.tp > 1 or schedule == "gpipe":
            if spec.virtual_stages > 1:
                raise ValueError(
                    "virtual_stages > 1 requires the 1f1b schedule "
                    "(tp == 1)")
            step = make_stacked_pipeline_train_step(
                block_fn, stage_loss_fn, mesh, spec.num_microbatches,
                state_example, data_axis="dp", stage_axis="pp",
                donate=donate, state_specs=state_specs,
                grad_sync_axes=grad_sync_axes)
        elif schedule == "1f1b":
            step = make_1f1b_pipeline_train_step(
                block_fn, stage_loss_fn, mesh, spec.num_microbatches,
                state_example, data_axis="dp", stage_axis="pp",
                donate=donate, virtual_stages=spec.virtual_stages,
                embed_fn=embed_fn, head_loss_fn=head_loss_fn)
        else:
            raise ValueError(f"unknown schedule {schedule!r} "
                             "(expected '1f1b' or 'gpipe')")
        step.param_specs = state_specs
    step.mesh_spec = spec
    step.mesh_gauges = mesh_gauges(spec, step.bubble_fraction)
    return step


def make_composed_state(model: nn.Module, params: Mapping[str, Any],
                        optimizer, spec: MeshSpec, mesh, seed: int = 0):
    """Shard the whole ``params`` (a ``state_dict``) by
    ``spec.param_specs`` into ``model`` (built for the spec's tp/ep
    layout) and build the state over the blocks, the optimizer's state
    sharded alike.  Returns ``(state, param_specs)``.  Non-pipeline
    specs only: stage-stacked states are built by the caller (see
    pipeline.py)."""
    if spec.pp > 1:
        raise ValueError(
            "make_composed_state is for pp == 1 specs; pipeline states are "
            "stage-stacked trees built per-model (see pipeline.py)")
    from tpudist_torch.parallel.tensor_parallel import sharded_state

    param_specs = spec.param_specs(model)
    return sharded_state(model, params, optimizer, mesh, param_specs,
                         seed), param_specs


def make_composed_eval_step(predict_fn: Callable[[Any, tuple],
                                                 torch.Tensor],
                            mesh, param_specs: Mapping[str, tuple] | None
                            = None, axes: Sequence[str] = ("dp", "fsdp")):
    """Masked exact counts for any non-pipeline composition:
    ``eval_step(model, *inputs, labels, mask) -> (correct, total)``, int64
    tensors summed over the batch ``axes``.  Leaves that ``param_specs``
    shards over a batch axis are gathered first (under ``no_grad``); the
    model issues its own tensor/expert collectives."""
    from tpudist_torch.parallel.data_parallel import _eval_mode, all_reduce_sum
    from tpudist_torch.parallel.tensor_parallel import ShardedParams, _Gathered

    layout = (None if param_specs is None
              else ShardedParams(mesh, param_specs, axes))
    groups = [mesh.get_group(a) for a in axes]

    def eval_step(model: nn.Module, *batch):
        *inputs, labels, mask = batch
        with torch.no_grad(), _eval_mode(model):
            full = None if layout is None else layout.full(
                layout.check(model))
            fn = model if full is None else _Gathered(model, full)
            logits = predict_fn(fn, tuple(inputs))
        mask = torch.as_tensor(mask, device=logits.device, dtype=torch.bool)
        hit = (logits.argmax(-1) == labels) & mask
        counts = [hit.sum(dtype=torch.int64), mask.sum(dtype=torch.int64)]
        all_reduce_sum(counts, groups)
        return counts[0], counts[1]

    return eval_step
