"""Model-parallel LRAM lookups: the `sharded` and `sharded-tiered`
placements of the lookup-plan registry (torch counterpart of
`repro.distributed.sharded_lram`).

The value table's rows are split over the ``model`` axis of the ambient
mesh: the rank at coordinate i holds rows [i * R, (i + 1) * R), R = N / S.
Instead of reading rows across ranks, every rank of a model group

  1. holds the same queries (the activations are the same on the ranks of
     a model group; they differ only across the ``data`` axis),
  2. gathers only the indices that fall in its rows (the others add
     nothing: the range gather, `repro_torch.kernels.sharded_gather`),
  3. joins the partial outputs with one all-reduce over ``model``.

The traffic is O(tokens * heads * m), independent of N; no table row
crosses ranks.  The backward (the range backward, `ops.lookup_bwd_range`)
scatters into the rank's own rows, and the query's partial gradient (dq,
or dw in the plain cell) is summed over ``model``: the conjugate of the
forward's all-reduce, since everything downstream of the memory layer is
computed alike on the ranks of a model group (`collectives`).

Cells: ``pallas`` (the CUDA kernels; their plain versions on CPU tensors)
looks up through one autograd Function, K2 then the range gather then the
all-reduce, with the range backward and the dq all-reduce behind it (its
interp hook alone is forward only on the card); ``reference`` is plain
autograd over the reference's formulation, for CPU tables only.  fp32 tables train by autodiff (each rank steps its own
rows); int8 / fp8 tables (`QuantizedTable` shards) are frozen.  The plan
builds the whole table from the init-time draw, as every plan does;
`repro_torch.distributed.sharding.shard_params` then keeps the rank's
rows.  Growth is not ported (ROADMAP A10) and would need a relaunch here,
as in the reference.

`ShardedTieredStore` (the ``sharded-tiered`` placement) composes the row
ranges with the tiered store: `num_ranges` `TieredValueStore`s, each
owning N / num_ranges consecutive rows with its own device cache, all in
one process (as the reference's: ranges on separate hosts are its
future, not its code).  Every rank of a mesh holds the whole store, as it
holds a tiered one (`table_rows_axis` is None); the batch's indices are
gathered over ``data`` first (C3).  Its checkpoint streams shards under
global ids, so it is a tiered store's byte for byte.  Not ported: growth
and row statistics (ROADMAP A10), overlays (A11), `mmap` backing and its
directory a range (A8).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch import nn

from repro_torch.core import lookup
from repro_torch.distributed import collectives
from repro_torch.kernels import e8_lookup, ops, sharded_gather
from repro_torch.memstore import interp as tiered
from repro_torch.memstore.store import (TieredSpec, TieredValueStore,
                                        global_indices, global_update)
from repro_torch.quant import QuantizedTable

AXIS = "model"


def _partial(table, scale, idx, w, base):
    if scale is None:
        return sharded_gather.sharded_gather(table, idx, w, base)
    return sharded_gather.sharded_gather_quant(table, scale, idx, w, base)


class _ShardedLookup(torch.autograd.Function):
    """K2 on the rank's queries, the range gather, the sum over the model
    group (idx and w returned, not differentiable); backward: the range
    backward with dq (the shard's dvalues for an fp32 table, the partial
    dq), then the sum of dq over the group."""

    @staticmethod
    def forward(ctx, table, q, scale, spec, top_k, base, group):
        idx, w = e8_lookup.lram_query(q, spec, top_k)
        out = collectives.all_reduce_(_partial(table, scale, idx, w, base),
                                      group)
        ctx.save_for_backward(table, q, scale, idx, w)
        ctx.spec, ctx.base, ctx.group = spec, base, group
        ctx.mark_non_differentiable(idx, w)
        return out, idx, w

    @staticmethod
    def backward(ctx, g, _g_idx, _g_w):
        table, q, scale, idx, w = ctx.saved_tensors
        dvalues, dq = ops.lookup_bwd_range(table, idx, w,
                                           g.float().contiguous(), ctx.base,
                                           scale=scale, q=q, spec=ctx.spec)
        collectives.all_reduce_(dq, ctx.group)
        return (dvalues if ctx.needs_input_grad[0] else None,
                dq.to(q.dtype), None, None, None, None, None)


def sharded_gather_interp(mesh, *, axis: str = AXIS,
                          kernel: str = "pallas"):
    """The interp hook (values, idx, w) -> out of the sharded cells.

    `values` is this rank's shard: an fp32 tensor (R, m) or a
    `QuantizedTable` of R rows, the rows [i * R, (i + 1) * R) of the table
    with i the rank's coordinate along `axis`; idx (..., k) int32 indices
    of the whole table and w (..., k), alike on the ranks of `axis`.  The
    output is the whole gather on every rank.  On CPU tables both cells
    run the range gather's plain version, differentiable in w and in an
    fp32 shard.  On the card the ``pallas`` cell launches the range
    gather, forward only (it raises under grad, as every forward kernel
    does: training goes through the plan's `lookup`), and the
    ``reference`` cell refuses.
    """
    if kernel not in ("reference", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r}")
    group, index = mesh.group(axis), mesh.index(axis)

    def interp(values, idx, w):
        quantized = isinstance(values, QuantizedTable)
        table = values.q if quantized else values
        scale = values.scale if quantized else None
        base = index * table.shape[0]
        if kernel == "reference" and table.is_cuda:
            raise lookup.LookupPlanError(
                "sharded", "?", kernel, "the plain reference path is for "
                "CPU tables; on the card use the pallas cell")
        w = collectives.copy_to(w, group)
        return collectives.reduce_from(_partial(table, scale, idx, w, base),
                                       group)

    return interp


def sharded_plan(cfg, storage: str, kernel: str, mesh) -> lookup.LookupPlan:
    """The `sharded` cell of (storage, kernel) on `mesh` (the reference's
    `_sharded_factory`): raises without an ambient mesh that has a
    ``model`` axis."""
    cell = ("sharded", storage, kernel)
    if mesh is None or AXIS not in mesh.axis_names:
        raise lookup.LookupPlanError(
            *cell, f"needs an ambient mesh with a {AXIS!r} axis: call "
            f"repro_torch.distributed.set_mesh(mesh) (under torchrun: "
            f"repro_torch.launch.mesh.init_mesh) before resolving")
    n_shards = mesh.size(AXIS)
    if cfg.num_locations % n_shards:
        raise lookup.LookupPlanError(
            *cell, f"num_locations={cfg.num_locations} not divisible by the "
            f"{AXIS!r} axis size {n_shards}")
    rows = cfg.num_locations // n_shards
    base, group = mesh.index(AXIS) * rows, mesh.group(AXIS)
    hook = sharded_gather_interp(mesh, axis=AXIS, kernel=kernel)
    quantized = storage != "fp32"

    def check_shard(values):
        if quantized != isinstance(values, QuantizedTable) or not (
                quantized or isinstance(values, torch.Tensor)):
            raise lookup.LookupPlanError(
                *cell, f"expected {'a QuantizedTable' if quantized else 'an '
                'fp32 tensor'} shard, got {type(values).__name__}")
        have = values.num_rows if quantized else values.shape[0]
        if have != rows:
            raise lookup.LookupPlanError(
                *cell, f"the table has {have} rows; this rank's shard of "
                f"the {n_shards}-way {AXIS!r} axis has {rows}: keep the "
                f"rank's rows with repro_torch.distributed.sharding."
                f"shard_params")

    def interp(values, idx, w):
        check_shard(values)
        return hook(values, idx, w)

    lookup_fn = None
    if kernel == "pallas":
        def lookup_fn(values, q, spec, top_k):
            check_shard(values)
            table, scale = ((values.q, values.scale) if quantized
                            else (values, None))
            return _ShardedLookup.apply(table, q, scale, spec, top_k, base,
                                        group)

    common = dict(query=lookup.query_fn(kernel), interp=interp,
                  lookup=lookup_fn, requires_mesh=True,
                  table_rows_axis=AXIS)
    if not quantized:
        return lookup.LookupPlan(
            *cell, build_table=lambda dense: nn.Parameter(dense), **common)
    return lookup.LookupPlan(
        *cell,
        build_table=lambda dense: QuantizedTable.from_dense(
            dense.detach().cpu().numpy(), storage),
        table_from_payload=lambda q, scale: QuantizedTable.from_payload(
            q, scale, storage),
        table_update="frozen", **common)


# ---------------------------------------------------------------------------
# sharded x tiered: row ranges, each a tiered store with its own cache
# ---------------------------------------------------------------------------

class ShardedTieredStore(nn.Module):
    """A row-range-sharded tiered table: `num_ranges` `TieredValueStore`
    parts, part r owning rows [r * R, (r + 1) * R), R = N / num_ranges,
    each with its own host tier and device cache (the reference's
    `ShardedTieredStore`).

    The surface is the tiered store's wherever the rest of the port reads
    one: `gather` (serving and eval), `lookup_rows` / `writeback` (the
    differentiable route, `memstore.interp`), `apply_writeback`,
    `prefetch*` / `warm` / `flush` / stats for the engine and the
    trainer, and the checkpoint's shard stream under global shard ids
    (shard i lives in part i // shards a range).  An `nn.Module` whose
    parts are its children: `.to(device)` moves every part's cache.
    """

    def __init__(self, num_rows: int, m: int, spec: TieredSpec,
                 num_ranges: int):
        super().__init__()
        if num_ranges < 1:
            raise ValueError("need at least one row range")
        if num_rows % num_ranges:
            raise ValueError(f"num_rows={num_rows} not divisible by "
                             f"num_ranges={num_ranges}")
        rows_local = num_rows // num_ranges
        if rows_local % spec.shard_rows:
            raise ValueError(f"range size {rows_local} not divisible by "
                             f"shard_rows={spec.shard_rows}")
        self.spec = spec
        self.num_rows = num_rows
        self.m = m
        self.num_ranges = num_ranges
        self.rows_local = rows_local
        self.quant = spec.quant
        self.shard_rows = spec.shard_rows
        self.parts = nn.ModuleList(
            TieredValueStore(rows_local, m, spec) for _ in range(num_ranges))
        self._shards_per_range = self.parts[0].num_shards
        self.num_shards = num_ranges * self._shards_per_range

    @classmethod
    def from_dense(cls, values, spec: TieredSpec,
                   num_ranges: int) -> "ShardedTieredStore":
        """A store holding fp32 `values` (N, m), each range quantized
        (nearest) on the way in if the spec is quantized."""
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        values = np.asarray(values, np.float32)
        store = cls(values.shape[0], values.shape[1], spec, num_ranges)
        store.load_dense(values)
        return store

    @classmethod
    def from_payload(cls, q: np.ndarray, scale: np.ndarray, spec: TieredSpec,
                     num_ranges: int) -> "ShardedTieredStore":
        """A quantized store holding exactly this (N, m) payload and these
        (N,) scales, bit for bit."""
        q = np.asarray(q)
        store = cls(q.shape[0], q.shape[1], spec, num_ranges)
        r = store.rows_local
        for i, part in enumerate(store.parts):
            part.load_payload(q[i * r:(i + 1) * r], scale[i * r:(i + 1) * r])
        return store

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    # ------------------------------------------------------------- routing

    def _route(self, flat_idx: np.ndarray):
        """(part, selection mask, local row ids) for every range the flat
        global ids touch, in range order."""
        for r, part in enumerate(self.parts):
            lo = r * self.rows_local
            sel = (flat_idx >= lo) & (flat_idx < lo + self.rows_local)
            if sel.any():
                yield part, sel, (flat_idx[sel] - lo).astype(np.int64)

    # ------------------------------------------------------------- lookups

    def gather(self, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """sum_k w[..., k] * values[idx[..., k]] -> (..., m) float32 on the
        store's device, not differentiable: the reference's sum of masked
        partials.  Each range the indices name maps the elements routed
        to it through its own cache (stats, fills and LRU see those
        alone), then gathers all k of every token in one call (B5 / B6
        when its mapped rows are all resident, else K1 / B4 over its flat
        route), the other ranges' elements reading its first routed row
        with weight 0.  The partials are added in range order, so the
        result is the same run to run; it differs from a one-table
        gather by the float rounding of that grouping.  No shard the
        indices do not name is touched."""
        lead, top_k = idx.shape[:-1], idx.shape[-1]
        flat = idx.reshape(-1).cpu().numpy()
        w2 = w.reshape(-1, top_k).float()
        out = None
        for part, sel, local in self._route(flat):
            keep = torch.from_numpy(sel.reshape(w2.shape)).to(self.device)
            partial = part._gather_mapped(
                part._map(local),
                torch.where(keep, w2, 0.0).contiguous(), sel=sel)
            out = partial if out is None else out.add_(partial)
        if out is None:  # no index at all
            out = torch.zeros((flat.size // top_k, self.m),
                              dtype=torch.float32, device=self.device)
        return out.reshape(*lead, self.m)

    def lookup_rows(self, idx: torch.Tensor):
        """(table, scales or None, rows), the tiered store's contract
        (`ops.RowSource`): the global idx (gathered over ``data`` once)
        is mapped range by range through each part's cache, the parts'
        flat tables (cache + overflow rows, and scales for 1-byte parts)
        are concatenated in range order, each part's rows offset by the
        rows before it, and this rank's rows are returned."""
        raw, scale, rows = self._flat_rows(*global_indices(idx))
        return self.parts[0]._payload(raw), scale, \
            self.parts[0]._device_rows(rows).reshape(idx.shape)

    def _flat_rows(self, flat_idx: np.ndarray, keep=None):
        keep = np.ones(flat_idx.size, bool) if keep is None else keep
        rows = np.zeros(flat_idx.size, np.int64)
        tables, scales, offset = [], [], 0
        for part, sel, local in self._route(flat_idx):
            table, scale, part_rows = part._flat_rows(local, keep[sel])
            rows[sel & keep] = part_rows + offset
            offset += table.shape[0]
            tables.append(table)
            scales.append(scale)
        if len(tables) == 1:
            return tables[0], scales[0], rows[keep]
        return (torch.cat(tables),
                None if self.quant == "none" else torch.cat(scales),
                rows[keep])

    # ------------------------------------------------------------ training

    @property
    def writeback_lr(self) -> float:
        return self.parts[0].writeback_lr

    @writeback_lr.setter
    def writeback_lr(self, lr: float) -> None:
        for part in self.parts:
            part.writeback_lr = lr

    def writeback(self, idx: torch.Tensor, w: torch.Tensor,
                  g: torch.Tensor) -> None:
        """The table's gradient from a differentiable lookup: (idx, w, g)
        gathered over ``data`` once, then routed (`apply_writeback`).  A
        no-op while `writeback_lr` is 0."""
        if self.writeback_lr > 0.0:
            self.apply_writeback(*global_update(idx, w, g))

    def apply_writeback(self, idx, wg) -> None:
        """Sparse SGD write-back, routed: each range applies the updates
        of the rows it owns, in range order (each part's int8 rounding
        draws from its own generator, as the reference's)."""
        flat = np.asarray(idx).reshape(-1)
        upd = np.asarray(wg, np.float32).reshape(-1, self.m)
        for part, sel, local in self._route(flat):
            part.apply_writeback(local, upd[sel])

    # ---------------------------------------------------- cache management

    def prefetch(self, idx, *, sync_device: bool = True) -> None:
        flat = np.asarray(idx).reshape(-1)
        for part, _, local in self._route(flat):
            part.prefetch(local, sync_device=sync_device)

    def prefetch_last(self, *, sync_device: bool = False) -> None:
        for part in self.parts:
            part.prefetch_last(sync_device=sync_device)

    def warm(self, shards: Iterable[int] | None = None) -> None:
        """Fill the caches ahead of serving: every range's lowest shards,
        or the given global shard ids."""
        if shards is None:
            for part in self.parts:
                part.warm()
            return
        per = self._shards_per_range
        for i in shards:
            self.parts[i // per].warm([i % per])

    def flush(self) -> None:
        for part in self.parts:
            part.flush()

    # --------------------------------------------------------------- stats

    @property
    def stats(self) -> dict:
        """Every part's stats, summed."""
        agg: dict = {}
        for part in self.parts:
            for k, v in part.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def reset_stats(self) -> None:
        for part in self.parts:
            part.reset_stats()

    def hit_rate(self) -> float:
        s = self.stats
        total = s["hits"] + s["misses"] + s["uncached"]
        return s["hits"] / total if total else 0.0

    def bytes_per_entry(self) -> int:
        return self.parts[0].bytes_per_entry()

    def resident_shards(self) -> list[int]:
        """Global ids of the cached shards, range by range."""
        per = self._shards_per_range
        return [r * per + s for r, part in enumerate(self.parts)
                for s in part.resident_shards()]

    # ---------------------------------------------------------- checkpoint

    def shard_host(self, i: int) -> np.ndarray:
        per = self._shards_per_range
        return self.parts[i // per].shard_host(i % per)

    def shard_scale_host(self, i: int) -> np.ndarray:
        per = self._shards_per_range
        return self.parts[i // per].shard_scale_host(i % per)

    def load_shard(self, i: int, arr: np.ndarray,
                   scale: np.ndarray | None = None) -> None:
        per = self._shards_per_range
        self.parts[i // per].load_shard(i % per, arr, scale)

    def load_dense(self, values) -> None:
        values = np.asarray(values)
        if values.shape != (self.num_rows, self.m):
            raise ValueError(f"shape {values.shape} != "
                             f"{(self.num_rows, self.m)}")
        r = self.rows_local
        for i, part in enumerate(self.parts):
            part.load_dense(values[i * r:(i + 1) * r])

    def to_dense(self) -> np.ndarray:
        """Flush and return the whole (dequantized) (N, m) fp32 table."""
        return np.concatenate([part.to_dense() for part in self.parts])

    def extra_repr(self) -> str:
        return (f"rows={self.num_rows}, m={self.m}, ranges="
                f"{self.num_ranges}x{self.rows_local}, quant={self.quant!r}")


def sharded_tiered_plan(cfg, storage: str, kernel: str,
                        mesh) -> lookup.LookupPlan:
    """The `sharded-tiered` cell (the reference's
    `_sharded_tiered_factory`): `cfg.model_shards` ranges, or the
    mesh's ``model`` size, or 1.  The table is a `ShardedTieredStore`
    trained by write-back and prefetched by the serve engine, through the
    tiered plan's lookups (`memstore.interp.store_plan`)."""
    cell = ("sharded-tiered", storage, kernel)
    spec = lookup.merged_tiered_spec(cfg, storage, kernel)
    num_ranges = cfg.model_shards
    if num_ranges <= 0:
        num_ranges = (mesh.size(AXIS)
                      if mesh is not None and AXIS in mesh.axis_names else 1)
    if cfg.num_locations % num_ranges:
        raise lookup.LookupPlanError(
            *cell, f"num_locations={cfg.num_locations} not divisible by "
            f"model_shards={num_ranges}")
    tiered.check_spec(cell, spec, cfg.num_locations // num_ranges)
    return tiered.store_plan(
        cell, ShardedTieredStore, "sharded-tiered",
        build_table=lambda dense: ShardedTieredStore.from_dense(
            dense, spec, num_ranges),
        table_from_payload=lambda q, scale: ShardedTieredStore.from_payload(
            q, scale, spec, num_ranges))
