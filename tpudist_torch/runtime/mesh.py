"""Process meshes (counterpart of :mod:`tpudist.runtime.mesh`).

tpudist lays its named axes (``data``, ``seq``, ...) over a grid of
devices; here the grid is one of processes, each driving one device, and
the mesh is a ``torch.distributed`` :class:`DeviceMesh` whose
``mesh_dim_names`` are the axis names.  Each axis gives a process group
(``mesh.get_group(axis)``) for the collectives along it, and
:func:`local_block` cuts a process's block out of a global batch, as
``device_put`` with ``NamedSharding(mesh, P("data", "seq"))`` places it.
The last axis varies fastest over the ranks, so its groups are runs of
adjacent ranks.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def resolve_axes(axes: Mapping[str, int], n: int) -> dict[str, int]:
    """``{axis: size}`` with the one ``-1`` axis (if any) given what is
    left of ``n`` processes; raises unless the sizes multiply to ``n``."""
    axes = dict(axes)
    wild = [k for k, v in axes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one -1 axis allowed, got {wild}")
    fixed = math.prod(v for v in axes.values() if v != -1)
    if wild:
        if n % fixed:
            raise ValueError(f"{n} processes not divisible by {fixed}")
        axes[wild[0]] = n // fixed
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(f"mesh {axes} needs {total} processes, the world "
                         f"has {n}")
    return axes


def make_mesh(axes: Mapping[str, int]) -> DeviceMesh:
    """A mesh of ``{axis: size}`` over every process of the group (one axis
    may be ``-1``: all remaining).  Needs :func:`initialize` first; its
    device type follows the group's backend (NCCL: ``cuda``, gloo:
    ``cpu``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "tpudist_torch.runtime.initialize() first")
    sizes = resolve_axes(axes, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def data_mesh(n: int | None = None) -> DeviceMesh:
    """1-D data-parallel mesh over all processes (``n``, when given, must
    be their number)."""
    return make_mesh({"data": -1 if n is None else n})


def data_model_mesh(model: int, n: int | None = None) -> DeviceMesh:
    """2-D ``data × model`` mesh (data parallelism × parameter sharding);
    ``model`` varies fastest, so a model group is a run of adjacent
    ranks.  ``n``, when given, must be the number of processes."""
    return make_mesh({"data": _rest(n, model), "model": model})


def pipeline_mesh(stages: int, n: int | None = None) -> DeviceMesh:
    """2-D ``data × stage`` mesh for (optionally data-parallel)
    pipelining; ``stage`` varies fastest."""
    return make_mesh({"data": _rest(n, stages), "stage": stages})


def _rest(n: int | None, inner: int) -> int:
    if n is None:
        return -1
    if n % inner:
        raise ValueError(f"{n} processes not divisible by {inner}")
    return n // inner


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This process's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def _dim(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has axes {names}, not {axis!r}")
    return names.index(axis)


def local_batch_size(global_batch: int, mesh: DeviceMesh,
                     axis: str = "data") -> int:
    n = axis_size(mesh, axis)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{axis}={n}")
    return global_batch // n


def local_block(x: torch.Tensor, mesh: DeviceMesh,
                spec: Sequence[str | None] = ("data", "seq")) -> torch.Tensor:
    """This process's block of a global tensor: dimension ``i`` split
    evenly over mesh axis ``spec[i]`` (``None``: kept whole), as a
    ``PartitionSpec(*spec)`` places it."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} not "
                             f"divisible by {axis}={n}")
        x = x.chunk(n, dim)[axis_index(mesh, axis)]
    return x
