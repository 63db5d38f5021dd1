"""Ranks on named axes, batch shards and the collectives over them.

Port of ``safe_control_gym_tpu/parallel/mesh.py``.  The JAX package runs one
SPMD program over a ``jax.sharding.Mesh`` of devices; the port runs one
process (rank) per shard in a ``torch.distributed`` process group:

- a :class:`Mesh` lays the group's ranks out on named axes (a
  ``torch.distributed.device_mesh.DeviceMesh``); in one process with no
  group formed it is a one-rank mesh with no group, and every collective
  below is skipped, as the JAX helpers run unchanged on one device;
- a ``NamedSharding(P(axis))`` placement becomes this rank's contiguous
  slice of the global batch (:func:`shard_batch`);
- ``psum`` becomes :func:`all_reduce_sum` over the mesh's group.

Backends: NCCL takes CUDA tensors, gloo CPU tensors.  Where several ranks
share one card (NCCL refuses two ranks on one device), the group is gloo and
the tensors live on the card: every collective here then stages its tensor
through host memory explicitly.  PyTorch's backend table gives gloo CUDA
support for ``all_reduce`` and ``broadcast`` alone; staging serves the
gather too, by one path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

ENV_AXIS = "env"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group on named axes, row-major: the rank of
    coordinate ``c`` is ``sum(c[i] * prod(sizes[i+1:]))``.

    ``device_mesh`` is None in one process with no group formed (one rank,
    every collective skipped)."""

    axis_names: tuple
    sizes: tuple
    coordinate: tuple  # this rank's index on each axis
    device_mesh: object = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def group(self, axis_names=None):
        """The process group over ``axis_names`` (default: every axis, the
        only group a caller needs: the mesh spans the world), or None in one
        process with no group."""
        names = _names(self, axis_names)
        if set(names) != set(self.axis_names):
            raise ValueError(f"a group over {names} of a mesh over {self.axis_names}")
        return None if self.device_mesh is None else dist.group.WORLD

    def shard(self, axis_names=None):
        """(index, count) of this rank's shard over ``axis_names``: the ranks
        that differ only on other axes hold the same shard."""
        names = _names(self, axis_names)
        idx, n = 0, 1
        for a in names:
            i = self.axis_names.index(a)
            idx, n = idx * self.sizes[i] + self.coordinate[i], n * self.sizes[i]
        return idx, n


def _names(mesh: Mesh, axis_names) -> tuple:
    if axis_names is None:
        return mesh.axis_names
    names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
    unknown = [a for a in names if a not in mesh.axis_names]
    if unknown:
        raise ValueError(f"axes {unknown} are not in the mesh's {mesh.axis_names}")
    return names


def mesh_over_ranks(sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of ``sizes`` over every rank of the current group, or the
    one-rank mesh where no group is formed (``sizes`` must then be ones)."""
    sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
    if len(sizes) != len(axis_names):
        raise ValueError(f"{len(sizes)} sizes for the axes {axis_names}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(sizes) != world:
        raise ValueError(f"a mesh of {dict(zip(axis_names, sizes))} needs {math.prod(sizes)} "
                         f"ranks; the group has {world}")
    if not dist.is_initialized():
        return Mesh(axis_names, sizes, (0,) * len(sizes))
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(world).reshape(sizes), mesh_dim_names=axis_names)
    return Mesh(axis_names, sizes, tuple(dm.get_coordinate()), dm)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = ENV_AXIS) -> Mesh:
    """1D mesh over every rank of the group (one rank where none is
    formed).  ``n_devices`` (optional) must be that count: a rank outside a
    mesh would have no shard."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a group of {world} ranks")
    return mesh_over_ranks((world,), (axis_name,))


def shard_slice(mesh: Mesh, num_envs: int, axis_names=None):
    """(start, count) of this rank's contiguous range of ``num_envs``."""
    idx, n = mesh.shard(axis_names)
    if num_envs % n:
        raise ValueError(f"num_envs={num_envs} not divisible by {n} shards")
    count = num_envs // n
    return idx * count, count


def shard_batch(tree, mesh: Mesh, axis_name=ENV_AXIS):
    """This rank's slice of every leading-B leaf of a tree of tensors
    (dataclasses such as ``QuadState`` or ``RolloutCarry``, dicts, tuples and
    lists; other leaves and 0-dim tensors are returned as they are)."""
    if torch.is_tensor(tree):
        if tree.dim() == 0:
            return tree
        start, count = shard_slice(mesh, tree.shape[0], axis_name)
        return tree[start:start + count]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: shard_batch(getattr(tree, f.name), mesh, axis_name)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis_name) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(v, mesh, axis_name) for v in tree)
    return tree


def _staged(t: torch.Tensor):
    """The tensor a collective of the current backend takes for ``t``: a
    host copy of a CUDA tensor under gloo, else ``t`` itself."""
    if t.device.type == "cuda" and dist.get_backend() == "gloo":
        return t.cpu()
    return t.contiguous()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``group`` (``t`` itself where the
    group is None).  Returns a new tensor on ``t``'s device."""
    if group is None:
        return t
    buf = _staged(t)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in rank
    order (``t`` itself where the group is None)."""
    if group is None:
        return t
    buf = _staged(t)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim).to(t.device)


def broadcast_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Overwrite ``t`` in place with rank 0's (nothing where the group is
    None)."""
    if group is None:
        return t
    buf = _staged(t)
    dist.broadcast(buf, 0, group=group)
    if buf is not t:
        t.copy_(buf)
    return t
