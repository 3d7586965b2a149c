"""Placement of a model over the mesh (the subset of
`repro.distributed.sharding` the port needs): the batch's rows over
``data`` and the memory tables' rows over the axis their plan names.
The dense weights stay replicated on every rank (the reference's GSPMD
FSDP/TP rules for them are a memory layout, ROADMAP A12 part 2).

Between a rank's rows and the global array, for checkpoints (the
reference checkpoints a sharded table as its global array):
`gather_rows` joins the row shards of one leaf on the first rank of its
group, and `own_rows` keeps this rank's rows of a global leaf, as
`shard_params` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core import lookup
from repro_torch.core.lram import LRAM
from repro_torch.quant import QuantizedTable


def batch_slice(mesh, batch: dict) -> dict:
    """This data rank's rows of the global batch (the reference's
    `batch_pspec`: the batch axis over ``data``); the batch itself without
    a mesh or a data axis."""
    if mesh is None or "data" not in mesh.axis_names:
        return batch
    d, n = mesh.index("data"), mesh.size("data")
    out = {}
    for key, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch[{key!r}] has {v.shape[0]} rows, not "
                             f"divisible by the {n} data ranks")
        size = v.shape[0] // n
        out[key] = v[d * size:(d + 1) * size]
    return out


def sharded_tables(model: nn.Module, mesh) -> dict[str, str]:
    """{parameter or buffer prefix: mesh axis} of every memory table whose
    plan splits its rows over an axis of `mesh` (`table_rows_axis`)."""
    if mesh is None:
        return {}
    out = {}
    for name, layer in model.named_modules():
        if isinstance(layer, LRAM):
            axis = lookup.resolve(layer.cfg).table_rows_axis
            if axis is not None and axis in mesh.axis_names:
                out[f"{name}.values" if name else "values"] = axis
    return out


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Keep in every row-sharded memory table only this rank's rows
    [i * R, (i + 1) * R) (i its coordinate along the plan's axis, R = N /
    size), in place, on the table's device: an fp32 table as the layer's
    `values` Parameter, a `QuantizedTable` as one of R rows.  Call it on
    the whole model, drawn alike on every rank, before the optimizer's
    state is made.  Returns the model."""
    for name, axis in sharded_tables(model, mesh).items():
        layer = model.get_submodule(name.rpartition(".")[0]) \
            if "." in name else model
        n, i = mesh.size(axis), mesh.index(axis)
        values = layer.values
        whole = layer.cfg.num_locations
        have = values.num_rows if isinstance(values, QuantizedTable) \
            else values.shape[0]
        if have != whole:
            raise ValueError(f"{name}: {have} rows, not the whole table of "
                             f"{whole} (already sharded?)")
        lo, hi = i * (whole // n), (i + 1) * (whole // n)
        if isinstance(values, QuantizedTable):
            layer.values = QuantizedTable(values.q[lo:hi].clone(),
                                          values.scale[lo:hi].clone(),
                                          values.kind)
        else:
            layer.values = nn.Parameter(values.detach()[lo:hi].clone())
    return model


def gather_rows(arr: np.ndarray, mesh, axis: str) -> np.ndarray | None:
    """The global array of a leaf split by rows over `axis` (a table's
    payload, scales or Adam moment), from this rank's host rows `arr`:
    gathered over `mesh.io_group(axis)` (gloo, host memory) in
    coordinate order onto the group's first rank, which returns it.  Only
    the ranks whose other coordinates are all 0 (the group of rank 0)
    take part; every other rank returns None at once."""
    if any(mesh.index(a) for a in mesh.axis_names if a != axis):
        return None
    if mesh.size(axis) == 1:
        return arr
    group = mesh.io_group(axis)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    parts = ([torch.empty_like(t) for _ in range(mesh.size(axis))]
             if mesh.index(axis) == 0 else None)
    dist.gather(t, parts, dst=dist.get_global_rank(group, 0), group=group)
    return None if parts is None else torch.cat(parts).numpy()


def own_rows(arr, mesh, axis: str):
    """This rank's rows [i * R, (i + 1) * R) of a global leaf (i its
    coordinate along `axis`, R = rows / size): the inverse of
    `gather_rows`."""
    n, i = mesh.size(axis), mesh.index(axis)
    if arr.shape[0] % n:
        raise ValueError(f"{arr.shape[0]} rows do not split over the {n} "
                         f"ranks of {axis!r}")
    rows = arr.shape[0] // n
    return arr[i * rows:(i + 1) * rows]
