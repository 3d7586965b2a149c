"""The ambient mesh (torch counterpart of `repro.distributed.context` and
of the `jax.sharding.Mesh` it holds).

A :class:`Mesh` names the axes of the ranks of a `torch.distributed` run,
("data", "model") as the reference's host mesh does, with the ranks laid
out row-major over the axes (rank = d * M + m for a data x model mesh),
and holds one `ProcessGroup` per axis: the ranks that differ from this one
in that axis alone.  `set_mesh` makes it ambient: the lookup registry
resolves the `sharded` placement against it (`repro_torch.core.lookup`),
and in train mode, where each data rank holds its slice of the global
batch, the batchnorm statistics and the loss's denominator sum over its
"data" axis (`repro_torch.nn.core.BatchNorm`,
`repro_torch.models.transformer.loss_fn`).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """Axis names, their sizes, this rank's coordinates and one process
    group per axis.  Hashed by identity: the lookup registry caches plans
    per mesh."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                             f"length")
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(shape) != world:
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"ranks, the run has {world}")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        self.coords = {a: (rank // s) % n
                       for a, s, n in zip(axes, strides, shape)}
        self._groups = {}
        # every rank creates every group, in the same order
        for i, axis in enumerate(axes):
            others = [range(n) if j != i else (0,)
                      for j, n in enumerate(shape)]
            for start in itertools.product(*others):
                ranks = [sum(c * s for c, s in zip(start, strides))
                         + k * strides[i] for k in range(shape[i])]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[axis] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.coords[axis]

    def group(self, axis: str) -> dist.ProcessGroup:
        """The ranks that share every coordinate with this one but
        `axis`'s."""
        return self._groups[axis]


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def batch_axes():
    """The data-parallel axis entry for the current mesh (None without
    one)."""
    return None if _MESH is None else "data"


def axis_group(axis: str) -> Optional[dist.ProcessGroup]:
    """The ambient mesh's group along `axis`; None without a mesh, without
    that axis, or when the axis has one rank (nothing to reduce)."""
    if _MESH is None or axis not in _MESH.axis_names \
            or _MESH.size(axis) == 1:
        return None
    return _MESH.group(axis)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The identity: a torch tensor carries no sharding annotation, so the
    reference's `with_sharding_constraint` has nothing to pin here.  Each
    rank computes on its own tensors; where the layout matters the port
    says so explicitly (the row-sharded table, the batch slice)."""
    del spec
    return x
