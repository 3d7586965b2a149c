"""Tiered memory store: a host-resident value table + a device hot cache
(torch counterpart of `repro.memstore`).

Public surface: `TieredSpec` (static layout), `TieredValueStore` (the
store) and `tiered_interp` (the tiered placement's lookup).
`repro_torch.memstore.interp` builds the `tiered` plan of the lookup
registry (`repro_torch.core.lookup`).
"""

from repro_torch.memstore.store import TieredSpec, TieredValueStore  # noqa: F401
from repro_torch.memstore.interp import tiered_interp  # noqa: F401
