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
rows stay apart (the range gather reads them, `sharded_lram`), while the
dense leaves are gathered whole one unit at a time (the embedding, each
layer, the head: `transformer.dense_units`), as GSPMD's FSDP does: an
all-gather over the leaves' axes just before the unit runs, released
just after it, gathered again just before its backward, whose gradients
are summed over the batch axes straight into this rank's blocks (a
reduce-scatter).  A forward outside `gathered(model)` raises.
Megatron-style compute on the blocks (heads split over ``model``) is not
ported: a leaf split over ``model`` is gathered whole too.

`batch_spec` and `cache_pspecs` are the reference's placements of the
input batch and of the decode cache (the dry-run reports a decode
rank's cache beside `cache_pspecs`' bytes: the port's decode keeps its
batch rows with every head); `batch_slice` takes a rank's rows, a VLM's
(3, B, S) M-RoPE positions along their batch axis.

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
from repro_torch.models.transformer import Transformer, dense_units
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


#: the site label of the dense blocks' gathers and sums
#: (`collectives.site`): `analysis.collectives` reads their bytes by it
SITE = "dense_blocks"


class _Unit:
    """The split leaves of one unit (a module the forward runs whole: the
    embedding, a layer, the head), in `named_parameters` order; `shared`
    for a unit that several call sites use (a tied embedding, a hybrid's
    `shared_attn`)."""

    def __init__(self, name: str, keys: list[str], shared: bool):
        self.name, self.keys, self.shared = name, keys, shared
        self.gather_buckets: list[tuple[tuple[str, ...], list[str]]] = []
        self.sum_buckets: list[tuple[str, list[str]]] = []


class DenseBlocks:
    """This rank's blocks of a model's split dense leaves, and their
    gather one unit at a time.

    Between steps every such `Parameter` holds its block (and Adam steps
    it and its moments there).  Under `gathered()` each unit the forward
    runs (`run`) is all-gathered whole over its leaves' axes just before
    it runs (an all-gather a flat bucket: the blocks of one set of axes
    and dtype concatenated in `named_parameters` order, alike on every
    rank, at most `collectives.FLAT_BUCKET_BYTES` of whole leaves) and
    dropped just after.  In grad mode the whole leaves are the
    outputs of one autograd node a unit (`_Gather`), whose storage is
    freed after the forward (`untyped_storage().resize_(0)`: the tensors
    autograd saved keep their shapes) and gathered again into it just
    before the unit's backward (`_PreBackward`, an identity on the unit's
    outputs whose backward runs once their gradients are complete); the
    node's backward, once every whole leaf's gradient is complete, frees
    the storage again and sums the gradients over the batch axes into
    this rank's blocks (`_sum_blocks`), which autograd accumulates into
    the block Parameters' `.grad`.  A shared unit keeps one node a pass:
    it is gathered at each use, and its gradients are summed (and its
    storage dropped) once, after its last use in the backward.  A
    forward outside `gathered()` raises (`check`)."""

    def __init__(self, model: nn.Module, mesh, specs: dict[str, tuple],
                 units: dict[str, bool]):
        self.mesh = mesh
        self.specs = specs
        self.params = {k: model.get_parameter(k) for k in specs}
        self.shapes = {k: tuple(p.shape) for k, p in self.params.items()}
        self.index = {k: block_index(self.shapes[k], s, mesh)
                      for k, s in specs.items()}
        self._owner = {}
        for k in specs:
            prefix, _, attr = k.rpartition(".")
            self._owner[k] = (model.get_submodule(prefix), attr)
        axes = MeshAxes.for_mesh(mesh).fsdp
        self.batch_axes = mesh.axes_key(tuple(a for a in axes
                                              if a in mesh.axis_names))
        self.batch_group = (mesh.group(self.batch_axes)
                            if self.batch_axes
                            and mesh.size(self.batch_axes) > 1 else None)
        self.units: dict[str, _Unit] = {}
        for k in specs:
            name = max((u for u in units if k.startswith(u + ".")),
                       key=len, default=None)
            if name is None:
                raise ValueError(f"{k}: a split leaf of no unit")
            self.units.setdefault(name, _Unit(name, [], units[name]))
            self.units[name].keys.append(k)
        for unit in self.units.values():
            self._plan(unit)
        self._unit_of = {model.get_submodule(name): unit
                         for name, unit in self.units.items()}
        self._armed = 0
        self._held: set[str] = set()
        self._live: dict[str, tuple] = {}  # a shared unit's node, this pass
        # on every gather and release: recorder(event, unit, phase, held)
        self.recorder = None
        self.stats = {"gathered_bytes": 0, "summed_bytes": 0,
                      "units_held_peak": 0, "shared_held_peak": 0}

    def _plan(self, unit: _Unit) -> None:
        """A unit's gather buckets (a set of axes and a dtype each) and
        sum buckets (a dtype and how a batch rank keeps its block each:
        "scatter" where the leaf is split over the batch axes, "block"
        where every batch rank keeps the same block), each cut into
        flat buffers of at most `collectives.FLAT_BUCKET_BYTES` of whole
        leaves (a leaf as large alone): the transient buffers of a
        gather or a sum stay that small beside the unit itself."""
        gather: dict[tuple, list[str]] = {}
        summed: dict[tuple, list[str]] = {}
        batch = set(self.batch_axes)
        for k in unit.keys:
            axes = self.mesh.axes_key(spec_axes(self.specs[k]))
            dtype = self.params[k].dtype
            gather.setdefault((axes, dtype), []).append(k)
            if batch <= set(axes):
                kind = "scatter"
            elif not batch & set(axes):
                kind = "block"
            else:
                raise ValueError(f"{k}: split over {axes}, part of the "
                                 f"batch axes {self.batch_axes}")
            summed.setdefault((kind, dtype), []).append(k)
        unit.gather_buckets = [(axes, part)
                               for (axes, _), keys in gather.items()
                               for part in self._cut(keys)]
        unit.sum_buckets = [(kind, part)
                            for (kind, _), keys in summed.items()
                            for part in self._cut(keys)]

    def _cut(self, keys: list[str]) -> list[list[str]]:
        """`keys` in order, cut where their whole leaves' bytes would pass
        `collectives.FLAT_BUCKET_BYTES`."""
        parts: list[list[str]] = [[]]
        size = 0
        for k in keys:
            nbytes = math.prod(self.shapes[k]) * self.params[k].element_size()
            if parts[-1] and size + nbytes > collectives.FLAT_BUCKET_BYTES:
                parts.append([])
                size = 0
            parts[-1].append(k)
            size += nbytes
        return parts

    @torch.no_grad()
    def keep_blocks(self) -> None:
        """Cut every leaf (whole, alike on every rank) to this rank's
        block, in place."""
        for k, p in self.params.items():
            p.data = p.data[self.index[k]].clone()

    # -- gather and release ------------------------------------------------

    def _record(self, event: str, unit: _Unit, phase: str) -> None:
        if event == "gather":
            self._held.add(unit.name)
            own = sum(not self.units[u].shared for u in self._held)
            self.stats["units_held_peak"] = max(
                self.stats["units_held_peak"], own)
            self.stats["shared_held_peak"] = max(
                self.stats["shared_held_peak"], len(self._held) - own)
        else:
            self._held.discard(unit.name)
        if self.recorder is not None:
            self.recorder(event, unit.name, phase, sorted(self._held))

    @torch.no_grad()
    def _fill(self, unit: _Unit, whole: list[torch.Tensor],
              phase: str) -> None:
        """All-gather the unit's blocks into `whole` (its leaves' whole
        tensors, in `unit.keys` order, their storage allocated): a
        collective over each bucket's axes."""
        pos = {k: i for i, k in enumerate(unit.keys)}
        for axes, keys in unit.gather_buckets:
            blocks = [self.params[k].data for k in keys]
            flat = torch.cat([b.reshape(-1) for b in blocks])
            with collectives.site(SITE):
                parts = collectives.all_gather_blocks(
                    flat, self.mesh.group(axes))
            for j, part in enumerate(parts):
                coords = _member_coords(self.mesh, axes, j)
                for k, b, piece in zip(keys, blocks, part.split(
                        [b.numel() for b in blocks])):
                    whole[pos[k]][block_index(
                        self.shapes[k], self.specs[k], self.mesh,
                        coords)] = piece.view(b.shape)
            self.stats["gathered_bytes"] += sum(
                math.prod(self.shapes[k]) * self.params[k].element_size()
                for k in keys)
        self._record("gather", unit, phase)

    def _gather(self, unit: _Unit, phase: str) -> list[torch.Tensor]:
        """The unit's leaves whole, in new tensors."""
        whole = [self.params[k].new_empty(self.shapes[k])
                 for k in unit.keys]
        self._fill(unit, whole, phase)
        return whole

    def _regather(self, unit: _Unit, aliases: list[torch.Tensor],
                  phase: str) -> None:
        """Gather the unit again into its freed storage (`aliases`: the
        whole leaves' `.data`, whose writes leave the saved tensors'
        version counters alone)."""
        for t in aliases:
            t.untyped_storage().resize_(t.numel() * t.element_size())
        self._fill(unit, aliases, phase)

    def _release(self, unit: _Unit, aliases, phase: str) -> None:
        """Drop the unit's whole values: free their storage (`aliases`),
        or leave them to their last reference (None)."""
        for t in aliases or ():
            t.untyped_storage().resize_(0)
        self._record("release", unit, phase)

    # -- the gradients -----------------------------------------------------

    @torch.no_grad()
    def _sum_blocks(self, unit: _Unit, grads) -> list[torch.Tensor]:
        """The unit's whole gradients summed over the batch axes, this
        rank's block of each (in `unit.keys` order): one reduce-scatter a
        "scatter" bucket (chunk j the blocks batch rank j keeps), one
        all-reduce of this rank's blocks a "block" bucket.  A 2-byte sum
        is the exact sum rounded once (`collectives.sum_dtype`)."""
        pos = {k: i for i, k in enumerate(unit.keys)}
        group = self.batch_group
        n = 1 if group is None else self.mesh.size(self.batch_axes)
        out: list = [None] * len(unit.keys)
        for kind, keys in unit.sum_buckets:
            dtype = self.params[keys[0]].dtype
            acc = collectives.sum_dtype(dtype, group)
            g = [grads[pos[k]] for k in keys]
            if kind == "scatter":
                chunks = [torch.cat([
                    gk[block_index(self.shapes[k], self.specs[k], self.mesh,
                                   _member_coords(self.mesh,
                                                  self.batch_axes, j))
                       ].reshape(-1) for k, gk in zip(keys, g)]).to(acc)
                    for j in range(n)]
                with collectives.site(SITE):
                    mine = collectives.reduce_scatter_(
                        torch.empty_like(chunks[0]), chunks, group)
                sent = n * mine.numel() * mine.element_size()
            else:
                with collectives.site(SITE):
                    mine = collectives.all_reduce_(torch.cat([
                        gk[self.index[k]].reshape(-1)
                        for k, gk in zip(keys, g)]).to(acc), group)
                sent = mine.numel() * mine.element_size()
            self.stats["summed_bytes"] += sent if group is not None else 0
            for k, piece in zip(keys, mine.split(
                    [self.params[k].numel() for k in keys])):
                out[pos[k]] = piece.view(self.params[k].shape).to(dtype)
        return out

    # -- running a unit ----------------------------------------------------

    @contextlib.contextmanager
    def gathered(self):
        """Forwards in the body may run: each unit is gathered as it runs
        (a collective: every rank must run the same forwards)."""
        self._armed += 1
        try:
            yield
        finally:
            self._armed -= 1
            if not self._armed:
                self._live.clear()

    @property
    def whole(self) -> bool:
        """Whether some unit's leaves are whole now."""
        return bool(self._held)

    def check(self, units: list[_Unit]) -> None:
        """Raise unless the units about to run may be gathered (the
        forward runs under `gathered()`)."""
        if self._armed:
            return
        k = units[0].keys[0]
        raise RuntimeError(
            f"this rank holds only its blocks of the dense weights "
            f"({k}: {tuple(self.params[k].shape)} of {self.shapes[k]}); "
            f"run the forward under `sharding.gathered(model)`, which "
            f"gathers each unit whole as it runs (an embedding block "
            f"indexed with the global token ids would read other rows)")

    def run(self, modules, fn, *args, **kw):
        """fn(*args, **kw) with the split leaves of the units of `modules`
        (those of them that are units) whole, released after it; in grad
        mode gathered again around their backward."""
        units = [self._unit_of[m] for m in modules if m in self._unit_of]
        if not units:
            return fn(*args, **kw)
        self.check(units)
        track = torch.is_grad_enabled()
        uses = []
        for unit in units:
            if not track:
                whole = self._gather(unit, "forward")
                uses.append((unit, whole, None))
                continue
            live = self._live.get(unit.name)
            if live is None:
                whole = _Gather.apply(self, unit,
                                      *(self.params[k] for k in unit.keys))
                live = (list(whole), [t.data for t in whole])
                if unit.shared:
                    self._live[unit.name] = live
            elif unit.name not in self._held:
                self._regather(unit, live[1], "forward")
            uses.append((unit, *live))
        with _swapped(self._owner, uses):
            out = fn(*args, **kw)
        for unit, _, aliases in uses:
            self._release(unit, aliases, "forward")
        if not track:
            return out
        return _PreBackward.wrap(self, [(u, a) for u, _, a in uses], out)


@contextlib.contextmanager
def _swapped(owner: dict, uses):
    """Each used unit's leaves read as its whole tensors in the body (the
    owning modules' `_parameters` entries swapped, then put back)."""
    saved = []
    for unit, whole, _ in uses:
        for k, t in zip(unit.keys, whole):
            module, attr = owner[k]
            saved.append((module, attr, module._parameters[attr]))
            module._parameters[attr] = t
    try:
        yield
    finally:
        for module, attr, p in saved:
            module._parameters[attr] = p


class _Gather(torch.autograd.Function):
    """blocks -> the unit's whole leaves (gathered); backward: the whole
    gradients summed into this rank's blocks, the storage dropped."""

    @staticmethod
    def forward(ctx, owner: DenseBlocks, unit: _Unit, *blocks):
        whole = owner._gather(unit, "forward")
        ctx.owner, ctx.unit = owner, unit
        ctx.aliases = [t.data for t in whole]
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        owner, unit = ctx.owner, ctx.unit
        owner._release(unit, ctx.aliases, "backward")
        owner._live.pop(unit.name, None)
        return (None, None, *owner._sum_blocks(unit, grads))


class _PreBackward(torch.autograd.Function):
    """The identity on a unit call's outputs; backward: gather the units
    the call used again (unless held) before their backward runs."""

    @staticmethod
    def forward(ctx, owner: DenseBlocks, uses, *xs):
        ctx.owner, ctx.uses = owner, uses
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        for unit, aliases in ctx.uses:
            if unit.name not in ctx.owner._held:
                ctx.owner._regather(unit, aliases, "backward")
        return (None, None, *grads)

    @staticmethod
    def wrap(owner: DenseBlocks, uses, out):
        """`out` (a tensor or nested tuples of them) with every tensor
        that requires grad passed through the identity."""
        found: list[torch.Tensor] = []

        def collect(o):
            if isinstance(o, torch.Tensor):
                if o.requires_grad:
                    found.append(o)
            elif isinstance(o, (tuple, list)):
                for x in o:
                    collect(x)

        collect(out)
        if not found:
            return out
        done = iter(_PreBackward.apply(owner, uses, *found))

        def rebuild(o):
            if isinstance(o, torch.Tensor):
                return next(done) if o.requires_grad else o
            if isinstance(o, (tuple, list)):
                return type(o)(rebuild(x) for x in o)
            return o

        return rebuild(out)


def dense_blocks(model: nn.Module) -> Optional[DenseBlocks]:
    """The model's `DenseBlocks` (None: every dense leaf is whole)."""
    return getattr(model, "placement", None)


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Run the body's forwards with the model's dense leaves gathered one
    unit at a time (a collective on a mesh: every rank must enter it and
    run the same forwards); a no-op for a model without blocks."""
    blocks = dense_blocks(model)
    if blocks is None:
        yield
        return
    with blocks.gathered():
        yield


def all_gather_block(block: torch.Tensor, mesh, spec: tuple
                     ) -> torch.Tensor:
    """The global value of a leaf split by `spec` on every rank, from
    this rank's `block` (an all-gather over the spec's axes)."""
    axes = mesh.axes_key(spec_axes(spec))
    parts = collectives.all_gather_blocks(block, mesh.group(axes))
    shape = global_shape(block.shape, spec, mesh)
    out = block.new_empty(shape)
    for j, part in enumerate(parts):
        out[block_index(shape, spec, mesh,
                        _member_coords(mesh, axes, j))] = part
    return out


# ---------------------------------------------------------------------------
# the batch, the tables, the placement
# ---------------------------------------------------------------------------

def batch_spec(mesh) -> tuple:
    """Input batches: the global batch over (pod?, data) (the reference's
    `batch_pspec`), a spec of one entry in `param_specs`' convention."""
    ax = MeshAxes.for_mesh(mesh)
    return (ax.fsdp if len(ax.fsdp) > 1 else ax.fsdp[0],)


def batch_slice(mesh, batch: dict) -> dict:
    """This data rank's rows of the global batch (`batch_spec`: the batch
    axis over ``data``, or ("pod", "data"), row-major, pod first), each
    leaf sliced along its batch axis: dim 0, but dim 1 of a VLM's (3, B,
    S) M-RoPE positions; the batch itself without a mesh or a data
    axis."""
    if mesh is None or "data" not in mesh.axis_names:
        return batch
    axes = _axes(batch_spec(mesh)[0])
    d, n = mesh.index(axes), mesh.size(axes)
    out = {}
    for key, v in batch.items():
        dim = 1 if key == "positions" and v.ndim == 3 else 0
        if v.shape[dim] % n:
            raise ValueError(f"batch[{key!r}] has {v.shape[dim]} rows, not "
                             f"divisible by the {n} data ranks")
        size = v.shape[dim] // n
        out[key] = v.narrow(dim, d * size, size)
    return out


def _shard_dim(dim: int, axis: str, mesh):
    return axis if dim % mesh.shape[axis] == 0 else None


def cache_pspecs(cache_shapes, cfg, mesh) -> dict:
    """Decode-cache placement (the reference's `cache_pspecs`), spec
    tuples in `param_specs`' convention, with divisibility fallbacks,
    keyed by the cache-entry name (structural, not shape-guessing):

      k/v/ck/cv  (..., B, T, Kh, D): B->data when divisible (else T->data,
                 the long_500k B=1 case); Kh->model, else D->model (low-kv
                 GQA archs: kv=2 cannot split 16 ways, head_dim=128 can).
      ssm        (..., B, H, N, P): B->data, H->model.
      conv       (..., B, W, C):    B->data, C->model.

    `cache_shapes` is `transformer.cache_shapes`' nested dict (leaves
    (shape, dtype)) or a cache of tensors; `mesh` anything with `shape`
    (a dict of axis sizes) and `axis_names`."""
    del cfg
    ax = MeshAxes.for_mesh(mesh)
    data_ax = ax.fsdp[-1]
    out = {}
    for seg, leaves in cache_shapes.items():
        out[seg] = {}
        for name, leaf in leaves.items():
            shape = tuple(leaf.shape if torch.is_tensor(leaf) else leaf[0])
            nd = len(shape)
            if name in ("k", "v", "ck", "cv"):
                b, t, kh, d = shape[-4:]
                sb = _shard_dim(b, data_ax, mesh)
                st = _shard_dim(t, data_ax, mesh) if sb is None else None
                skh = _shard_dim(kh, ax.tp, mesh)
                sd = None if skh else _shard_dim(d, ax.tp, mesh)
                spec = (None,) * (nd - 4) + (sb, st, skh, sd)
            elif name == "ssm":
                b, h = shape[-4], shape[-3]
                spec = (None,) * (nd - 4) + (
                    _shard_dim(b, data_ax, mesh),
                    _shard_dim(h, ax.tp, mesh), None, None)
            elif name == "conv":
                b, c = shape[-3], shape[-1]
                spec = (None,) * (nd - 3) + (
                    _shard_dim(b, data_ax, mesh), None,
                    _shard_dim(c, ax.tp, mesh))
            else:
                spec = ()
            out[seg][name] = spec
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
      `DenseBlocks`) gathers them a unit at a time for a forward
      (`transformer.dense_units`).  Another module (a memory layer
      alone) keeps its dense leaves whole."""
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
            model.placement = DenseBlocks(model, mesh, specs,
                                          dense_units(model))
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
