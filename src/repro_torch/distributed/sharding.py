"""Placement of a model over the mesh (torch counterpart of
`repro.distributed.sharding`): GSPMD's partition rules, hybrid FSDP
(``data``, or ("pod", "data") on a multi-pod mesh) x TP (``model``), for
the dense weights, the memory tables' rows over the axis their plan
names, and the batch's rows over the batch axes.

The rule table (`_rules`, `_apply_spec`, `_spec_for`,
`_memory_table_spec`) is the reference's, matched on each parameter's
reference path (`launch.convert.reference_path`), and `param_specs`
gives what the reference's `param_pspecs` gives leaf for leaf: a spec is
a tuple with one entry a dim (None, an axis, or a tuple of axes; a
1-tuple written as its axis, as `PartitionSpec` normalizes it), () for a
replicated leaf.  The port's leaves are per layer, not stacked, so they
need no left padding; the divisibility fallback is the same.

`shard_params` keeps on every rank only its block of each split dense
leaf (`DenseBlocks`, the model's `placement`) and its rows of a
row-sharded table.  The two differ in how they compute: the table's
rows stay apart (the range gather reads them, `sharded_lram`), while a
dense leaf is gathered whole before a forward (an all-gather over the
leaf's axes, as GSPMD's FSDP does: `DenseBlocks.gathered`) and released
after it.  A forward over bare blocks raises.  Megatron-style compute on
the blocks (heads split over ``model``) is not ported.

Between a rank's blocks and the global array, for checkpoints (the
reference checkpoints a split leaf as its global array): `gather_block`
joins the blocks of one leaf on the first rank of its group, and
`own_block` keeps this rank's block of a global leaf, as `shard_params`
does.  A block's place is `NamedSharding`'s: along a dim split over a
tuple of axes, row-major over them in the tuple's order, pod first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core import lookup
from repro_torch.core.lram import LRAM
from repro_torch.distributed import collectives
from repro_torch.models.transformer import Transformer
from repro_torch.quant import QuantizedTable


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    fsdp: tuple[str, ...] = ("data",)
    tp: str = "model"

    @classmethod
    def for_mesh(cls, mesh) -> "MeshAxes":
        if "pod" in mesh.axis_names:
            return cls(fsdp=("pod", "data"), tp="model")
        return cls(fsdp=("data",), tp="model")


def _rules(ax: MeshAxes) -> list[tuple[str, tuple]]:
    F, T = ax.fsdp, ax.tp
    return [
        # embeddings: vocab on TP, feature on FSDP
        (r"embed/embedding$", (T, F)),
        (r"pos_embed$", (None, None)),
        (r"enc_pos_embed$", (None, None)),
        (r"lm_head/kernel$", (F, T)),
        # attention
        (r"(attn|cross)/wq/kernel$", (F, T)),
        (r"(attn|cross)/wk/kernel$", (F, T)),
        (r"(attn|cross)/wv/kernel$", (F, T)),
        (r"(attn|cross)/wo/kernel$", (T, F)),
        (r"(attn|cross)/w[qkv]/bias$", (T,)),
        # dense mlp
        (r"mlp/wi(_gate|_up)?/kernel$", (F, T)),
        (r"mlp/wo/kernel$", (T, F)),
        (r"mlp/w[io].*?/bias$", (None,)),
        # MoE: experts on TP axis (expert parallelism) when E divides the
        # axis; otherwise Megatron-style TP *within* each expert (the
        # families are not ported; the rules stay the reference's)
        (r"moe/router/kernel$", (F, None)),
        (r"moe/experts/wi(_gate|_up)?$", [(T, F, None), (None, F, T)]),
        (r"moe/experts/wi$", [(T, F, None), (None, F, T)]),
        (r"moe/experts/wo$", [(T, None, F), (None, T, F)]),
        # mamba
        (r"mamba/in_proj/kernel$", (F, T)),
        (r"mamba/out_proj/kernel$", (T, F)),
        (r"mamba/conv$", (None, T)),
        (r"mamba/(A_log|D|dt_bias)$", (None,)),
        (r"mamba/norm/scale$", (T,)),
        # LRAM memory tables carry NO rule here: the resolved LookupPlan
        # places them (`table_rows_axis`, `_memory_table_spec` below)
        (r"pkm/values$", (T, None)),
        (r"pkm/subkeys[12]$", (None, T, None)),
        (r"pkm/query/kernel$", (F, T)),
        (r"memffn/wi/kernel$", (F, T)),
        (r"memffn/wo/kernel$", (T, F)),
        # norms, biases, batchnorm state: replicated
        (r".*", None),
    ]


def _axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _apply_spec(spec: tuple, ndim: int, shape, mesh):
    """Left-pad for stacked leading dims + per-dim divisibility."""
    spec = (None,) * (ndim - len(spec)) + tuple(spec)
    fixed, clean = [], True
    for dim, s in zip(shape, spec):
        if s is None:
            fixed.append(None)
            continue
        axes = _axes(s)
        size = math.prod(mesh.shape[a] for a in axes)
        if dim % size == 0:
            fixed.append(axes[0] if len(axes) == 1 else axes)
        else:
            fixed.append(None)
            clean = False
    return tuple(fixed), clean


def _spec_for(name: str, ndim: int, shape, mesh, ax: MeshAxes) -> tuple:
    for pat, spec in _rules(ax):
        if re.search(pat, name):
            if spec is None:
                return ()
            candidates = spec if isinstance(spec, list) else [spec]
            best = None
            for cand in candidates:
                p, clean = _apply_spec(cand, ndim, shape, mesh)
                if best is None:
                    best = p
                if clean:
                    return p
            return best
    return ()


def _memory_table_spec(plan, ndim: int, shape, mesh) -> tuple:
    """The memory table's spec, from its resolved plan: its rows over
    `table_rows_axis` (None: replicated)."""
    axis = plan.table_rows_axis
    if axis is None or axis not in mesh.axis_names:
        return ()
    spec, _ = _apply_spec((axis,) + (None,) * (ndim - 1), ndim, shape, mesh)
    return spec


def param_specs(model, mesh, ax: Optional[MeshAxes] = None
                ) -> dict[str, tuple]:
    """{`named_parameters` key: spec} of a whole `Transformer` (every leaf
    its full shape) on `mesh` (anything with `shape`, a dict of axis
    sizes, and `axis_names`): the reference's `param_pspecs(params, mesh,
    model_cfg=cfg)`, leaf for leaf, without a stacked run's leading
    None."""
    from repro_torch.launch.convert import reference_path  # imports us

    ax = ax or MeshAxes.for_mesh(mesh)
    plans = lookup.model_plans(model.cfg)
    mem_plan = plans[0] if plans else None
    specs = {}
    for key, p in model.named_parameters():
        path, _ = reference_path(key, model.cfg)
        name = path.removeprefix("params/")
        if mem_plan is not None and "lram/values" in name:
            specs[key] = _memory_table_spec(mem_plan, p.ndim, p.shape, mesh)
        else:
            specs[key] = _spec_for(name, p.ndim, p.shape, mesh, ax)
    return specs


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def spec_axes(spec: tuple) -> tuple[str, ...]:
    """Every mesh axis a spec splits over, in the spec's order."""
    return tuple(a for entry in spec for a in _axes(entry))


def block_index(shape, spec: tuple, mesh, coords=None) -> tuple:
    """The slices of the block of a leaf of global `shape` that the rank
    at `coords` ({axis: coordinate}; default this rank's) holds: along a
    dim split over axes (a_1, ..., a_j), block number (row-major over
    them) i of size dim / prod(sizes)."""
    coords = mesh.coords if coords is None else coords
    out = []
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
        size = shape[d] // math.prod(mesh.shape[a] for a in axes)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def global_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The global shape of a leaf whose block has `shape`."""
    return tuple(n * math.prod(mesh.shape[a] for a in _axes(entry))
                 for n, entry in itertools.zip_longest(shape, spec))


def _member_coords(mesh, axes: tuple[str, ...], j: int) -> dict:
    """The coordinates of the group member j of `mesh.group(axes)` (its
    ranks ascending: row-major over `axes` in mesh order); this rank's
    along every other axis."""
    coords = dict(mesh.coords)
    for a in reversed(mesh.axes_key(axes)):
        j, coords[a] = divmod(j, mesh.shape[a])
    return coords


class DenseBlocks:
    """This rank's blocks of a model's split dense leaves, and their
    gather.  Between steps every such `Parameter` holds its block (and
    Adam steps it and its moments there); `gather` replaces each by its
    whole value, all-gathered over the leaf's axes (one all-gather a set
    of axes, the blocks flattened and concatenated), and `release` puts
    the blocks back, dropping the whole values.  `check` raises unless
    the leaves are whole: `Transformer` calls it before every forward."""

    def __init__(self, model: nn.Module, mesh, specs: dict[str, tuple]):
        self.mesh = mesh
        self.specs = specs
        self.params = {k: model.get_parameter(k) for k in specs}
        self.shapes = {k: tuple(p.shape) for k, p in self.params.items()}
        self.index = {k: block_index(self.shapes[k], s, mesh)
                      for k, s in specs.items()}
        self._held: dict[str, torch.Tensor] | None = None
        self._depth = 0

    @torch.no_grad()
    def keep_blocks(self) -> None:
        """Cut every leaf (whole, alike on every rank) to this rank's
        block, in place."""
        for k, p in self.params.items():
            p.data = p.data[self.index[k]].clone()

    @torch.no_grad()
    def gather(self) -> None:
        """Make every split leaf whole (a collective: every rank, in the
        same order).  Nested calls gather once."""
        self._depth += 1
        if self._held is not None:
            return
        # one all-gather a set of axes (mesh order), the leaves in
        # `named_parameters` order: alike on every rank
        by_axes: dict[tuple[str, ...], list[str]] = {}
        for k, spec in self.specs.items():
            by_axes.setdefault(self.mesh.axes_key(spec_axes(spec)),
                               []).append(k)
        held, whole = {}, {}
        for axes, names in by_axes.items():
            blocks = [self.params[k].data for k in names]
            flat = torch.cat([b.reshape(-1) for b in blocks])
            parts = collectives.all_gather_blocks(flat, self.mesh.group(axes))
            for k, b in zip(names, blocks):
                held[k] = b
                whole[k] = b.new_empty(self.shapes[k])
            for j, part in enumerate(parts):
                coords = _member_coords(self.mesh, axes, j)
                for k, piece in zip(names, part.split(
                        [b.numel() for b in blocks])):
                    whole[k][block_index(self.shapes[k], self.specs[k],
                                         self.mesh, coords)] = \
                        piece.view(held[k].shape)
        for k, p in self.params.items():
            p.data = whole[k]
        self._held = held

    def release(self) -> None:
        """Back to the blocks (the whole values are dropped)."""
        self._depth = max(0, self._depth - 1)
        if self._depth or self._held is None:
            return
        for k, p in self.params.items():
            p.data = self._held[k]
        self._held = None

    @contextlib.contextmanager
    def gathered(self):
        self.gather()
        try:
            yield
        finally:
            self.release()

    @property
    def whole(self) -> bool:
        return self._held is not None

    def check(self) -> None:
        if self._held is None:
            k = next(iter(self.params))
            raise RuntimeError(
                f"this rank holds only its blocks of the dense weights "
                f"({k}: {tuple(self.params[k].shape)} of "
                f"{self.shapes[k]}); run the forward under "
                f"`sharding.gathered(model)` (an embedding block indexed "
                f"with the global token ids would read other rows)")


def dense_blocks(model: nn.Module) -> Optional[DenseBlocks]:
    """The model's `DenseBlocks` (None: every dense leaf is whole)."""
    return getattr(model, "placement", None)


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Run the body with the model's dense leaves whole (a collective on a
    mesh: every rank must enter it); a no-op for a model without
    blocks."""
    blocks = dense_blocks(model)
    if blocks is None:
        yield
        return
    with blocks.gathered():
        yield


# ---------------------------------------------------------------------------
# the batch, the tables, the placement
# ---------------------------------------------------------------------------

def batch_slice(mesh, batch: dict) -> dict:
    """This data rank's rows of the global batch (the reference's
    `batch_pspec`: the batch axis over ``data``, or ("pod", "data"), row-
    major, pod first); the batch itself without a mesh or a data axis."""
    if mesh is None or "data" not in mesh.axis_names:
        return batch
    axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    d, n = mesh.index(axes), mesh.size(axes)
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
    """Keep on this rank only its part of the model, in place, on each
    leaf's device.  Call it on the whole model, drawn alike on every
    rank, before the optimizer's state is made.  Returns the model.

    * a row-sharded memory table keeps rows [i * R, (i + 1) * R) (i this
      rank's coordinate along the plan's axis, R = N / size): an fp32
      table as the layer's `values` Parameter, a `QuantizedTable` as one
      of R rows;
    * on a `Transformer`, every dense leaf that `param_specs` splits
      keeps this rank's block, and the model's `placement` (a
      `DenseBlocks`) gathers them for a forward.  Another module (a
      memory layer alone) keeps its dense leaves whole."""
    tables = sharded_tables(model, mesh)
    for name, axis in tables.items():
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
    if isinstance(model, Transformer) and mesh is not None:
        if dense_blocks(model) is not None:
            raise ValueError("the model's dense leaves are already blocks")
        specs = {k: s for k, s in param_specs(model, mesh).items()
                 if k not in tables
                 and math.prod(mesh.size(a) for a in spec_axes(s)) > 1}
        if specs:
            model.placement = DenseBlocks(model, mesh, specs)
            model.placement.keep_blocks()
    return model


def split_leaves(model: nn.Module, mesh) -> dict[str, tuple]:
    """{state_dict key: spec} of every leaf this rank holds a part of: the
    row-sharded tables' payloads, scales and fp32 values (their rows over
    the plan's axis) and the dense blocks."""
    out = {}
    for prefix, axis in sharded_tables(model, mesh).items():
        for key, t in model.state_dict(keep_vars=True).items():
            if key == prefix or key.startswith(prefix + "."):
                out[key] = (axis,) + (None,) * (t.ndim - 1)
    blocks = dense_blocks(model)
    if blocks is not None:
        out.update(blocks.specs)
    return out


# ---------------------------------------------------------------------------
# global arrays <-> blocks (checkpoints)
# ---------------------------------------------------------------------------

def gather_block(arr: np.ndarray, mesh, spec: tuple) -> np.ndarray | None:
    """The global array of a leaf split by `spec` (a table's rows or a
    dense block, or one of their Adam moments; a stacked run's leading
    None included), from this rank's host block `arr`: gathered over
    `mesh.io_group` of the spec's axes (gloo, host memory) onto the
    group's first rank, which returns it.  Only the ranks whose other
    coordinates are all 0 (the group of rank 0) take part; every other
    rank returns None at once."""
    axes = mesh.axes_key(spec_axes(spec))
    if any(mesh.index(a) for a in mesh.axis_names if a not in axes):
        return None
    n = mesh.size(axes)
    if n == 1:
        return arr
    group = mesh.io_group(axes)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    first = all(mesh.index(a) == 0 for a in axes)
    parts = [torch.empty_like(t) for _ in range(n)] if first else None
    dist.gather(t, parts, dst=dist.get_global_rank(group, 0), group=group)
    if parts is None:
        return None
    shape = global_shape(arr.shape, spec, mesh)
    out = np.empty(shape, arr.dtype)
    for j, part in enumerate(parts):
        out[block_index(shape, spec, mesh,
                        _member_coords(mesh, axes, j))] = part.numpy()
    return out


def own_block(arr, mesh, spec: tuple):
    """This rank's block of a global leaf split by `spec`: the inverse of
    `gather_block`."""
    for n, entry in zip(arr.shape, spec):
        size = math.prod(mesh.size(a) for a in _axes(entry))
        if n % size:
            raise ValueError(f"a dim of {n} does not split over the {size} "
                             f"ranks of {entry!r}")
    return arr[block_index(arr.shape, spec, mesh)]
