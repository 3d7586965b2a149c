"""The tiered placement of the lookup registry (torch counterpart of
`repro.memstore.interp`).

`tiered_plan` builds the plan whose table is a `TieredValueStore` and whose
interp is `tiered_interp`: the store's eager gather.  Torch runs eagerly,
so the reference's `io_callback` machinery (the traced lookup inside jit)
and its few-core dispatch workaround have no counterpart here.  The
write-back of training is not ported yet (ROADMAP A8).
"""

from __future__ import annotations

from repro_torch.core import lookup
from repro_torch.memstore.store import TieredValueStore


def tiered_interp(store: TieredValueStore, idx, w):
    """sum_k w[..., k] * store[idx[..., k]] -> (..., m), not differentiable
    (serving only)."""
    return store.gather(idx, w)


def tiered_plan(cfg, storage: str, kernel: str) -> lookup.LookupPlan:
    cell = ("tiered", storage, kernel)
    spec = lookup.merged_tiered_spec(cfg, storage, kernel)
    if spec.backing != "ram":
        raise lookup.LookupPlanError(
            *cell, f"backing={spec.backing!r} is not ported to torch yet: "
            f"ROADMAP A8 (tiered store, mmap backing)",
        )
    if cfg.num_locations % spec.shard_rows:
        raise lookup.LookupPlanError(
            *cell, f"num_locations={cfg.num_locations} not divisible by "
            f"TieredSpec.shard_rows={spec.shard_rows}",
        )

    def interp(values, idx, w):
        if not isinstance(values, TieredValueStore):
            raise lookup.LookupPlanError(
                *cell, "the table must be a TieredValueStore: init the "
                "layer with LRAMConfig(interp_impl='tiered')",
            )
        return tiered_interp(values, idx, w)

    return lookup.LookupPlan(
        *cell, query=lookup.query_fn(kernel),
        build_table=lambda dense: TieredValueStore.from_dense(dense, spec),
        interp=interp,
        table_from_payload=(
            None if storage == "fp32" else
            lambda q, scale: TieredValueStore.from_payload(q, scale, spec)),
        supports_prefetch=True,
    )
