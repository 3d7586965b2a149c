"""The ambient mesh (torch counterpart of `repro.distributed.context` and
of the `jax.sharding.Mesh` it holds).

A :class:`Mesh` names the axes of the ranks of a `torch.distributed` run,
("data", "model") as the reference's host mesh does, or ("pod", "data",
"model") on a multi-pod mesh, with the ranks laid out row-major over the
axes (rank = d * M + m for a data x model mesh), and holds one
`ProcessGroup` for every set of its axes: the ranks that differ from this
one in those axes alone (and a gloo twin of each for the checkpoint's
host gathers; in a world whose backend makes no gloo group, the fake
one-process world of the dry-run, `launch.dryrun`, each twin is the
world's own group).  `set_mesh` makes it ambient: the lookup registry
resolves the `sharded` placement against it (`repro_torch.core.lookup`),
and in train mode, where each data rank holds its slice of the global
batch, the batchnorm statistics and the loss's denominator sum over the
batch axes, ``data`` or ("pod", "data") (`batch_axes`, `batch_group`;
`repro_torch.nn.core.BatchNorm`, `repro_torch.models.transformer.loss_fn`).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """Axis names, their sizes, this rank's coordinates and one process
    group per set of axes.  Hashed by identity: the lookup registry caches
    plans per mesh."""

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
        self._groups, self._io_groups = {}, {}
        # a fake world (the dry-run's) makes no gloo group: its io groups
        # are its own groups
        fake = dist.get_backend() == "fake"
        # every rank creates every group, in the same order: for each set
        # of axes (in mesh order), one group per coordinate of the others,
        # its ranks ascending (row-major over the set's axes)
        dims = range(len(axes))
        for r in range(1, len(axes) + 1):
            for subset in itertools.combinations(dims, r):
                others = [range(n) if j not in subset else (0,)
                          for j, n in enumerate(shape)]
                inner = [range(shape[j]) for j in subset]
                for start in itertools.product(*others):
                    base = sum(c * s for c, s in zip(start, strides))
                    ranks = [base + sum(c * strides[j]
                                        for c, j in zip(pos, subset))
                             for pos in itertools.product(*inner)]
                    group = dist.new_group(ranks)
                    io_group = (group if fake else
                                dist.new_group(ranks, backend="gloo"))
                    if rank in ranks:
                        key = tuple(axes[j] for j in subset)
                        self._groups[key] = group
                        self._io_groups[key] = io_group

    def axes_key(self, axes) -> tuple[str, ...]:
        """`axes` (one name or several) as a tuple in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise KeyError(f"axes {sorted(unknown)} are not in the mesh "
                           f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        """The ranks along `axes` (one name or several): their product."""
        return math.prod(self.shape[a] for a in self.axes_key(axes))

    def index(self, axes) -> int:
        """This rank's coordinate along `axes`: row-major over them in the
        order given (("pod", "data"): pod * data_size + data), the order
        in which `NamedSharding` lays out a dim split over a tuple of
        axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes) -> dist.ProcessGroup:
        """The ranks that share every coordinate with this one but those
        along `axes` (one name or several), ascending: a rank's place in
        the group is its coordinate row-major over `axes` in mesh
        order."""
        return self._groups[self.axes_key(axes)]

    def io_group(self, axes) -> dist.ProcessGroup:
        """`group(axes)`'s ranks in a gloo group of their own, for the
        checkpoint's gathers of host arrays: no collective of it
        interleaves with the training's on `group(axes)`, and the arrays
        stay in host memory under any backend.  Under the fake backend
        (the dry-run's one-process world, which can make no gloo group)
        it is `group(axes)` itself."""
        return self._io_groups[self.axes_key(axes)]


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def batch_axes():
    """The data-parallel axis entry for the current mesh: ("pod", "data")
    on a multi-pod mesh, else "data"; None without a mesh."""
    if _MESH is None:
        return None
    if "pod" in _MESH.axis_names:
        return ("pod", "data")
    return "data"


def axis_group(axes) -> Optional[dist.ProcessGroup]:
    """The ambient mesh's group along `axes` (one name or several); None
    without a mesh, without one of those axes, or when they hold one rank
    (nothing to reduce)."""
    if _MESH is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if any(a not in _MESH.axis_names for a in axes) or _MESH.size(axes) == 1:
        return None
    return _MESH.group(axes)


def batch_group() -> Optional[dist.ProcessGroup]:
    """The group over `batch_axes()`: the ranks that hold the other slices
    of the global batch (None without a mesh or with one such rank)."""
    axes = batch_axes()
    return None if axes is None else axis_group(axes)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The identity: a torch tensor carries no sharding annotation, so the
    reference's `with_sharding_constraint` has nothing to pin here.  Each
    rank computes on its own tensors; where the layout matters the port
    says so explicitly (the row-sharded table, the batch slice, the
    dense weights' blocks gathered before a forward)."""
    del spec
    return x
