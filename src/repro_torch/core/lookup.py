"""Lookup-plan registry: placement × storage × kernel (torch counterpart of
`repro.core.lookup`).

A config resolves once into a :class:`LookupPlan` that owns the memory
read: how the table is built (`build_table` from the init-time fp32 draw,
`table_from_payload` from a 1-byte payload and its scales), the top-k
`query`, and the weighted `interp` gather.  Axes:

* **placement** — ``dense`` (one tensor on the device) | ``tiered`` (host
  shards + a device hot cache, `repro_torch.memstore`) | ``sharded`` (the
  table's rows split over the ``model`` axis of the ambient mesh,
  `repro_torch.distributed.sharded_lram`) | ``sharded-tiered`` (the rows
  split into ranges, each a tiered store of its own, all in one process:
  `sharded_lram.ShardedTieredStore`).
* **storage** — ``fp32`` | ``int8`` | ``fp8`` (1-byte payload + per-row
  fp32 scales, `repro_torch.quant`).
* **kernel** — the reference's names, so configs and CLI flags carry over:
  ``pallas`` is the port's hand-written CUDA kernels (their plain versions
  on CPU tensors), differentiable through the backward kernel (the plan's
  `lookup` = `kernels.ops.lram_lookup`: in the table and q on a dense fp32
  table, in q on the others);
  ``reference`` is the plain torch functions (plain autograd), for CPU
  tables only: on a CUDA table it raises, so no run on the card silently
  skips the kernels.  ``auto`` resolves to ``pallas`` for the tiered,
  sharded and sharded-tiered placements (the reference picks
  ``reference`` there only because its Pallas kernels run interpreted
  off a TPU).

Unsupported cells raise :class:`LookupPlanError` at resolve time.  The
serve engine reads the plan's ``supports_prefetch`` flag to find the
tiered stores it warms and prefetches; the trainer reads ``table_update``
to find the stores whose write-back it binds.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any, Callable

import torch
from torch import nn

STORAGES = ("fp32", "int8", "fp8")
KERNELS = ("reference", "pallas")

# interp_impl string -> placement (the reference's aliases)
IMPL_PLACEMENT = {
    "reference": "dense",
    "dense": "dense",
    "pallas": "dense",
    "tiered": "tiered",
    "sharded": "sharded",
    "sharded-tiered": "sharded-tiered",
}

# (kernel, storage class) -> (module, function).  The storage class names a
# calling convention: "fp32" (values, idx, w), "quant" (q, scale, idx, w),
# "tiered" / "tiered-quant" (the cache-indirected gathers of
# repro_torch.kernels.tiered_gather).
_KERNEL_IMPLS = {
    ("pallas", "fp32"): ("gather_interp", "gather_interp"),
    ("pallas", "quant"): ("gather_interp", "gather_interp_quant"),
    ("pallas", "tiered"): ("tiered_gather", "tiered_gather"),
    ("pallas", "tiered-quant"): ("tiered_gather", "tiered_gather_quant"),
    ("reference", "fp32"): ("gather_interp", "gather_interp_plain"),
    ("reference", "quant"): ("gather_interp", "gather_interp_quant_plain"),
}


class LookupPlanError(ValueError):
    """A (placement, storage, kernel) cell that cannot be built."""

    def __init__(self, placement, storage, kernel, reason: str):
        self.cell = (placement, storage, kernel)
        super().__init__(
            f"lookup plan ({placement} × {storage} × {kernel}): {reason}"
        )


@dataclasses.dataclass(frozen=True)
class LookupPlan:
    """A resolved lookup backend.

    ``query(q, spec, top_k) -> (idx, w)`` and ``interp(table, idx, w)``
    together are one memory read; ``lookup(table, q, spec, top_k) ->
    (out, idx, w)`` is that read as the one call `lram_apply` makes:
    `query` then `interp` unless the plan sets it (the dense fp32
    ``pallas`` cell: `kernels.ops.lram_lookup`, differentiable in the
    table and q through the backward kernel).  ``build_table(dense)``
    turns the fp32 draw (N, m) into the table object an LRAM layer holds (an fp32
    `Parameter`, a `QuantizedTable` or a `TieredValueStore`);
    ``table_from_payload(q, scale)`` builds it from a quantized payload
    carried bit for bit (quantized storages only).

    ``table_update`` says how the table trains: ``autodiff`` (a dense fp32
    `Parameter`: its gradient is the scatter-add of the backward, and the
    optimizer steps it), ``writeback`` (the tiered store applies its own
    sparse SGD step, `TieredValueStore.writeback_lr`) or ``frozen`` (a
    dense 1-byte table: nothing trains it; only the query's gradient
    flows).

    ``requires_mesh``: the plan reads the ambient mesh
    (`repro_torch.distributed.context`); ``table_rows_axis`` names the
    mesh axis the table's rows are split over (None: every rank holds the
    whole table), which `repro_torch.distributed.sharding.shard_params`
    and the trainer read.
    """

    placement: str
    storage: str
    kernel: str
    query: Callable
    build_table: Callable[[torch.Tensor], Any]
    interp: Callable
    table_from_payload: Callable | None = None
    supports_prefetch: bool = False
    lookup: Callable | None = None
    table_update: str = "autodiff"  # autodiff | writeback | frozen
    requires_mesh: bool = False
    table_rows_axis: str | None = None

    def __post_init__(self):
        if self.lookup is None:
            query, interp = self.query, self.interp

            def query_then_interp(table, q, spec, top_k):
                idx, w = query(q, spec, top_k)
                return interp(table, idx, w), idx, w

            object.__setattr__(self, "lookup", query_then_interp)

    @property
    def cell(self) -> tuple[str, str, str]:
        return (self.placement, self.storage, self.kernel)


def _cpu_only(fn: Callable, cell) -> Callable:
    @functools.wraps(fn)
    def run(x, *args, **kw):
        if x.is_cuda:
            raise LookupPlanError(
                *cell, "the plain reference path is for CPU tables; on the "
                "card use the pallas cell (the CUDA kernels)",
            )
        return fn(x, *args, **kw)
    return run


def kernel_gather(kernel: str, storage_class: str) -> Callable:
    """The gather for (kernel, storage class): a CUDA kernel's wrapper for
    ``pallas``, a CPU-only plain version for ``reference``."""
    key = (kernel, storage_class)
    if key not in _KERNEL_IMPLS:
        raise KeyError(f"no kernel registered for {key}")
    module, name = _KERNEL_IMPLS[key]
    fn = getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                 name)
    return fn if kernel == "pallas" else _cpu_only(fn, ("?", storage_class,
                                                        kernel))


def query_fn(kernel: str) -> Callable:
    """The top-k query of a kernel cell: K2, or its plain version (CPU)."""
    from repro_torch.kernels import e8_lookup

    if kernel == "pallas":
        return e8_lookup.lram_query
    return _cpu_only(e8_lookup.lram_query_plain, ("?", "?", kernel))


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

def resolve(cfg, override: str | None = None) -> LookupPlan:
    """Resolve an `LRAMConfig` (plus an optional per-call placement
    override, `lram_apply`'s `interp_impl`) into a plan, once per
    (config, impl)."""
    from repro_torch.distributed import context

    impl = override if override is not None else cfg.interp_impl
    return _resolve_cached(cfg, impl, context.get_mesh())


@functools.lru_cache(maxsize=None)
def _resolve_cached(cfg, impl: str, mesh) -> LookupPlan:
    """One plan per (config, impl, ambient mesh): the sharded plan is
    bound to the mesh it was resolved under."""
    placement = IMPL_PLACEMENT.get(impl)
    if placement is None:
        raise LookupPlanError(
            impl, "?", "?",
            f"unknown interp_impl {impl!r}; known: {sorted(IMPL_PLACEMENT)}",
        )
    storage = _resolve_storage(cfg, placement)
    kernel = _resolve_kernel(cfg, placement, impl)
    if placement == "tiered":
        from repro_torch.memstore import interp

        return interp.tiered_plan(cfg, storage, kernel)
    if placement == "sharded":
        from repro_torch.distributed import sharded_lram

        return sharded_lram.sharded_plan(cfg, storage, kernel, mesh)
    if placement == "sharded-tiered":
        from repro_torch.distributed import sharded_lram

        return sharded_lram.sharded_tiered_plan(cfg, storage, kernel, mesh)
    return _dense_plan(storage, kernel)


def _resolve_storage(cfg, placement: str) -> str:
    storage = "fp32" if cfg.table_quant in (None, "none") else cfg.table_quant
    spec = cfg.tiered
    if placement in ("tiered", "sharded-tiered") and spec is not None \
            and spec.quant != "none":
        if storage not in ("fp32", spec.quant):
            raise LookupPlanError(
                placement, storage, "?",
                f"LRAMConfig.table_quant={storage!r} conflicts with "
                f"TieredSpec.quant={spec.quant!r}",
            )
        storage = spec.quant
    if storage not in STORAGES:
        raise LookupPlanError(placement, storage, "?",
                              f"unknown storage {storage!r}; known: "
                              f"{STORAGES}")
    return storage


def _resolve_kernel(cfg, placement: str, impl: str) -> str:
    kernel = cfg.lookup_kernel
    if kernel == "auto":
        if placement == "dense":
            kernel = "pallas" if impl == "pallas" else "reference"
        elif placement in ("tiered", "sharded", "sharded-tiered"):
            kernel = "pallas"
        else:
            kernel = "reference"
    if kernel not in KERNELS:
        raise LookupPlanError(placement, "?", kernel,
                              f"unknown kernel {kernel!r}; known: {KERNELS}")
    return kernel


def model_plans(model_cfg) -> list[LookupPlan]:
    """The plans a model config implies ([] without a memory layer): how
    the serve engine discovers capabilities."""
    if model_cfg.lram is None or not model_cfg.lram_layers:
        return []
    return [resolve(model_cfg.lram)]


# ---------------------------------------------------------------------------
# the dense placement
# ---------------------------------------------------------------------------

def _dense_plan(storage: str, kernel: str) -> LookupPlan:
    from repro_torch import quant

    cell = ("dense", storage, kernel)
    if storage == "fp32":
        gather = kernel_gather(kernel, "fp32")

        def check_table(values):
            if not isinstance(values, torch.Tensor):
                raise LookupPlanError(
                    *cell, f"the table is a {type(values).__name__}, not an "
                    f"fp32 tensor: init and apply must use the same plan",
                )

        def interp(values, idx, w):
            check_table(values)
            return gather(values, idx, w)

        lookup_fn = None
        if kernel == "pallas":
            from repro_torch.kernels import ops

            def lookup_fn(values, q, spec, top_k):
                check_table(values)
                out, (idx, w) = ops.lram_lookup(values, q, spec, top_k,
                                                return_access=True)
                return out, idx, w

        return LookupPlan(*cell, query=query_fn(kernel),
                          build_table=lambda dense: nn.Parameter(dense),
                          interp=interp, lookup=lookup_fn)

    gather = kernel_gather(kernel, "quant")

    def check_quant(table):
        if not isinstance(table, quant.QuantizedTable):
            raise LookupPlanError(
                *cell, f"the table must be a QuantizedTable for "
                f"storage={storage!r}; got {type(table).__name__}",
            )

    def interp_quant(table, idx, w):
        check_quant(table)
        return gather(table.q, table.scale, idx, w)

    lookup_quant = None
    if kernel == "pallas":
        from repro_torch.kernels import ops

        def lookup_quant(table, q, spec, top_k):
            # frozen: the rows are the table's own, no sink takes w (x) g
            check_quant(table)
            source = ops.RowSource(lambda idx: (table.q, table.scale, idx))
            out, (idx, w) = ops.lram_lookup(source, q, spec, top_k,
                                            return_access=True)
            return out, idx, w

    return LookupPlan(
        *cell, query=query_fn(kernel),
        build_table=lambda dense: quant.QuantizedTable.from_dense(
            dense.detach().cpu().numpy(), storage),
        interp=interp_quant, lookup=lookup_quant,
        table_from_payload=lambda q, scale: quant.QuantizedTable.from_payload(
            q, scale, storage),
        table_update="frozen",
    )


def merged_tiered_spec(cfg, storage: str, kernel: str):
    """The TieredSpec a tiered plan builds: the config's spec (or the
    defaults) with the resolved storage and kernel axes folded in."""
    from repro_torch.memstore import TieredSpec

    spec = cfg.tiered or TieredSpec()
    quant_kind = "none" if storage == "fp32" else storage
    if spec.quant != quant_kind or spec.use_pallas != (kernel == "pallas"):
        spec = dataclasses.replace(
            spec, quant=quant_kind, use_pallas=(kernel == "pallas")
        )
    return spec


def is_store(x) -> bool:
    """A tiered value store (the tables the engine warms and prefetches):
    a `TieredValueStore` or a `ShardedTieredStore`."""
    from repro_torch.distributed.sharded_lram import ShardedTieredStore
    from repro_torch.memstore import TieredValueStore

    return isinstance(x, (TieredValueStore, ShardedTieredStore))


def find_stores(model: nn.Module) -> list[tuple[str, Any]]:
    """(name, store) for every distinct tiered store in a model; the
    range stores inside a `ShardedTieredStore` are its own, not listed."""
    out = []
    for name, mod in model.named_modules():
        if is_store(mod) and not any(n == "" or name.startswith(f"{n}.")
                                     for n, _ in out):
            out.append((name, mod))
    return out
