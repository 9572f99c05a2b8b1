"""Device meshes for dp/fsdp/sp/ep/tp layouts (port of the JAX package's
``parallel/mesh.py``).

JAX builds a ``jax.sharding.Mesh`` over the devices one process drives.
PyTorch runs one process per rank, so a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, with named dims; the caller initialises that group
first, naming its backend (``parallel.distributed``). Model-parallel axes
(tp, sp) are innermost, data-parallel outermost, as in JAX: consecutive
ranks share a tp group, which is what keeps tp inside one host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch


@dataclass(frozen=True)
class MeshSpec:
    """Named mesh shape, e.g. {'dp': 2, 'fsdp': 2, 'tp': 2}. Axis size 1 is
    legal and keeps the axis name addressable (so one model definition runs
    from 1 chip to a pod)."""

    axes: Dict[str, int] = field(default_factory=dict)

    @property
    def names(self) -> tuple:
        return tuple(self.axes.keys())

    @property
    def shape(self) -> tuple:
        return tuple(self.axes.values())

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.axes else 1

    @staticmethod
    def for_devices(n: int, fsdp: int = 1, sp: int = 1, tp: int = 1,
                    ep: int = 1) -> "MeshSpec":
        """Default 5-axis layout for n devices: fill fsdp/sp/ep/tp as asked,
        rest is dp. All five axis names always exist (size 1 where unused) so
        one set of specs works at any scale. ep sits between sp and tp:
        expert all_to_alls are bulkier than tp all-reduces but rarer, so tp
        keeps the innermost (fastest) ring."""
        denom = fsdp * sp * ep * tp
        if n % denom:
            raise ValueError(
                f"{n} devices not divisible by fsdp*sp*ep*tp={denom}")
        return MeshSpec({"dp": n // denom, "fsdp": fsdp, "sp": sp, "ep": ep,
                         "tp": tp})


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of a torch.distributed process group: "
            "call torch.distributed.init_process_group (or "
            "parallel.distributed.distributed_init_from_env) first, with "
            "its backend named")
    return dist.get_world_size()


def _device_mesh(device_type: str, grid: np.ndarray, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.as_tensor(grid),
                      mesh_dim_names=names)


def multislice_mesh(n_slices: int, fsdp: int = 1, sp: int = 1, tp: int = 1,
                    ep: int = 1, device_type: str = "cuda"):
    """Mesh for a gang that spans slices: the OUTER dp axis is the slice
    index, so its collectives (the data-parallel gradient all-reduce)
    cross slices while fsdp/sp/ep/tp stay inside each. Ranks must be
    slice-major (slice 0's ranks first), the worker-id order the gang
    plugin injects."""
    per_slice = fsdp * sp * ep * tp
    need = n_slices * per_slice
    have = _world()
    if need != have:
        raise ValueError(
            f"multislice mesh {n_slices}x{per_slice} needs {need} ranks, "
            f"have {have}")
    grid = np.arange(need).reshape((n_slices, fsdp, sp, ep, tp))
    return _device_mesh(device_type, grid, ("dp", "fsdp", "sp", "ep", "tp"))


def make_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``spec``'s shape and dim names over the ranks
    of the default process group, rank order row-major (the last axis
    innermost). ``device_type`` is ``"cuda"`` or ``"cpu"``."""
    have = _world()
    if spec.size != have:
        raise ValueError(
            f"mesh {spec.axes} needs {spec.size} ranks, have {have}")
    grid = np.arange(spec.size).reshape(spec.shape or (1,))
    return _device_mesh(device_type, grid, spec.names or ("dp",))


class MeshAxes:
    """One rank's view of a mesh with named dims (a ``DeviceMesh``, or
    anything ``parallel.sharding.mesh_coords`` reads): the size of every
    axis (1 for an axis the mesh lacks), this rank's coordinate on each
    and, for an axis of size > 1, its process group (the ranks that
    differ from this one on that axis only). The training code
    (``models/llama.py``) runs its collectives on these groups; JAX named
    the same axes inside ``shard_map`` and GSPMD."""

    def __init__(self, mesh) -> None:
        from .sharding import mesh_coords

        self.mesh = mesh
        self.sizes, self.index = mesh_coords(mesh)
        self._groups: Dict[str, object] = {}

    @staticmethod
    def of(mesh) -> "MeshAxes":
        return mesh if isinstance(mesh, MeshAxes) else MeshAxes(mesh)

    def size(self, *axes: str) -> int:
        """The product of the named axes' sizes (every axis: the world)."""
        names = axes or tuple(self.sizes)
        return int(np.prod([self.sizes.get(a, 1) for a in names]))

    def group(self, axis: str):
        """The process group of ``axis``; None for an axis of size 1, on
        which every collective is the identity."""
        if self.sizes.get(axis, 1) == 1:
            return None
        if axis not in self._groups:
            self._groups[axis] = self.mesh.get_group(axis)
        return self._groups[axis]
