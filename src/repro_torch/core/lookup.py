"""Lookup-plan registry: placement × storage × kernel (torch counterpart of
`repro.core.lookup`).

A config resolves once into a :class:`LookupPlan` that owns the memory
read's two steps: the top-k `query` and the weighted `interp` gather.
This slice ports the dense fp32 placement only.  The kernel axis keeps
the reference's names so configs and CLI flags carry over:

* ``pallas`` — the port's hand-written CUDA kernels (`lram_query`, K2, and
  `gather_interp`, K1); on CPU tensors their plain versions.
* ``reference`` — the plain torch functions, for CPU tensors only: on a
  CUDA table it raises, so no run on the card silently skips the kernels.

Every other cell raises :class:`LookupPlanError` naming the ROADMAP item
that will port it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

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

# cells not ported yet -> the ROADMAP item that ports them
_NOT_PORTED = {
    "tiered": "ROADMAP A8 (tiered store) with kernels B5/B6",
    "sharded": "ROADMAP A12 (distribution)",
    "sharded-tiered": "ROADMAP A12 (distribution) after A8",
    "int8": "ROADMAP A6 (quantized storage) with kernel B4",
    "fp8": "ROADMAP A6 (quantized storage) with kernel B4",
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

    ``query(q, spec, top_k) -> (idx, w)`` and ``interp(values, idx, w)``
    together are one memory read.
    """

    placement: str
    storage: str
    kernel: str
    query: Callable
    interp: Callable

    @property
    def cell(self) -> tuple[str, str, str]:
        return (self.placement, self.storage, self.kernel)


def resolve(cfg, override: str | None = None) -> LookupPlan:
    """Resolve an `LRAMConfig` (plus an optional per-call placement
    override, `lram_apply`'s `interp_impl`) into a plan."""
    impl = override if override is not None else cfg.interp_impl
    return _resolve_cached(impl, cfg.table_quant, cfg.lookup_kernel)


@functools.lru_cache(maxsize=None)
def _resolve_cached(impl: str, table_quant: str,
                    lookup_kernel: str) -> LookupPlan:
    placement = IMPL_PLACEMENT.get(impl)
    if placement is None:
        raise LookupPlanError(
            impl, "?", "?",
            f"unknown interp_impl {impl!r}; known: {sorted(IMPL_PLACEMENT)}",
        )
    storage = "fp32" if table_quant in (None, "none") else table_quant
    if storage not in STORAGES:
        raise LookupPlanError(placement, storage, "?",
                              f"unknown storage {storage!r}; known: "
                              f"{STORAGES}")
    kernel = lookup_kernel
    if kernel == "auto":
        kernel = "pallas" if impl == "pallas" else "reference"
    if kernel not in KERNELS:
        raise LookupPlanError(placement, storage, kernel,
                              f"unknown kernel {kernel!r}; known: {KERNELS}")
    for axis in (placement, storage):
        if axis in _NOT_PORTED:
            raise LookupPlanError(
                placement, storage, kernel,
                f"{axis!r} is not ported to torch yet: "
                f"{_NOT_PORTED[axis]}",
            )
    return _dense_fp32(kernel)


def _dense_fp32(kernel: str) -> LookupPlan:
    from repro_torch.kernels import e8_lookup, gather_interp

    if kernel == "pallas":
        return LookupPlan("dense", "fp32", kernel,
                          query=e8_lookup.lram_query,
                          interp=gather_interp.gather_interp)

    def cpu_only(fn):
        @functools.wraps(fn)
        def run(x, *args):
            if x.is_cuda:
                raise LookupPlanError(
                    "dense", "fp32", "reference",
                    "the plain reference path is for CPU tensors; on the "
                    "card use --placement pallas (the CUDA kernels)",
                )
            return fn(x, *args)
        return run

    return LookupPlan("dense", "fp32", kernel,
                      query=cpu_only(e8_lookup.lram_query_plain),
                      interp=cpu_only(gather_interp.gather_interp_plain))
