"""The tiered placement of the lookup registry (torch counterpart of
`repro.memstore.interp`).

`tiered_plan` builds the plan whose table is a `TieredValueStore`, and
`store_plan` the same plan over any store of that surface (the
sharded-tiered placement's `ShardedTieredStore` too); its table trains
through the store's write-back (``table_update = "writeback"``).  Two
differentiable entry points, the counterparts of the reference's traced
VJP, both one autograd Function of `ops` over the store
as a `RowSource` (its flat route `lookup_rows`: the cache with the
overflow rows appended, then K1 or B4; its write-back as the sink):

  * `tiered_interp(store, idx, w)`: the weighted gather, differentiable in
    w (`ops.source_gather`); backward dw by `ops.lookup_bwd_rows` /
    `ops.lookup_bwd_quant` on the table and rows the forward read, then
    w (x) g to the store's write-back.
  * the plan's `lookup(store, q, spec, top_k)`: `ops.lram_lookup`, K2 then
    the same flat route; backward dq from the rows the forward read, then
    the write-back.

Both read the flat route even when every shard is resident: B5 and B6 have
no VJP in the reference and stay serve-only.  Without a gradient to take
(grad mode off, as in serving and `evaluate`, or an input that needs none)
both are the store's eager gather, B5/B6 included, and nothing is written
back.  The write-back runs once per backward; the tiered configs run no
recomputation of the forward.  Torch runs eagerly, so the reference's
`io_callback` machinery and its few-core dispatch workaround have no
counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.core import lookup
from repro_torch.kernels import ops
from repro_torch.memstore.store import TieredValueStore


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def tiered_interp(store, idx, w):
    """sum_k w[..., k] * store[idx[..., k]] -> (..., m), differentiable in
    w; the table's gradient w (x) g goes to the store's write-back.
    `store` is a `TieredValueStore` or a `ShardedTieredStore` (the same
    `gather` / `lookup_rows` / `writeback` surface)."""
    if _needs_grad(w):
        return ops.source_gather(_row_source(store), idx, w)
    return store.gather(idx, w)


def _row_source(store) -> ops.RowSource:
    """The store's flat route as the joined lookup reads it, its
    write-back as the sink."""
    return ops.RowSource(store.lookup_rows, store.writeback)


def tiered_plan(cfg, storage: str, kernel: str) -> lookup.LookupPlan:
    cell = ("tiered", storage, kernel)
    spec = lookup.merged_tiered_spec(cfg, storage, kernel)
    check_spec(cell, spec, cfg.num_locations)
    return store_plan(
        cell, TieredValueStore, "tiered",
        build_table=lambda dense: TieredValueStore.from_dense(dense, spec),
        table_from_payload=lambda q, scale: TieredValueStore.from_payload(
            q, scale, spec),
        build_empty=lambda: TieredValueStore(cfg.num_locations, cfg.m, spec,
                                             cfg.torch_table_dtype))


def check_spec(cell, spec, rows: int) -> None:
    """Raise for a spec the port cannot build: a store of `rows` rows (the
    table, or one row range of it) not a multiple of the shard size."""
    if rows % spec.shard_rows:
        raise lookup.LookupPlanError(
            *cell, f"a store of {rows} rows is not divisible by "
            f"TieredSpec.shard_rows={spec.shard_rows}",
        )


def store_plan(cell, store_type: type, impl: str, *, build_table,
               table_from_payload, build_empty) -> lookup.LookupPlan:
    """The plan of a placement whose table is a store of `store_type` (a
    `TieredValueStore` or a `ShardedTieredStore`): `tiered_interp` and the
    joined lookup over the store as a `RowSource`, trained by its
    write-back, prefetched by the serve engine, grown in place and
    counted a shard (`repro_torch.memctl`), its base rows host-readable
    for per-tenant overlays.  `impl` is the `interp_impl`
    that builds such a table; `build_empty` a zero store of the plan's
    layout."""
    storage, kernel = cell[1], cell[2]
    query = lookup.query_fn(kernel)

    def check_store(values):
        if not isinstance(values, store_type):
            raise lookup.LookupPlanError(
                *cell, f"the table must be a {store_type.__name__}: init "
                f"the layer with LRAMConfig(interp_impl={impl!r})",
            )
        if kernel == "reference" and values.device.type != "cpu":
            raise lookup.LookupPlanError(
                *cell, "the plain reference path is for CPU tables; on the "
                "card use the pallas cell (the CUDA kernels)",
            )

    def interp(values, idx, w):
        check_store(values)
        return tiered_interp(values, idx, w)

    def lookup_fn(values, q, spec, top_k):
        check_store(values)
        if _needs_grad(q):
            out, (idx, w) = ops.lram_lookup(_row_source(values), q, spec,
                                            top_k, return_access=True)
            return out, idx, w
        idx, w = query(q, spec, top_k)
        return values.gather(idx, w), idx, w

    return lookup.LookupPlan(
        *cell, query=query, build_table=build_table,
        interp=interp, lookup=lookup_fn,
        table_from_payload=None if storage == "fp32" else table_from_payload,
        supports_prefetch=True, table_update="writeback",
        supports_growth=True, row_stats=True, build_empty=build_empty,
        supports_overlay=True,
    )
