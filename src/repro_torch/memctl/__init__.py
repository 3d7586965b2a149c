"""The memory lifecycle manager: telemetry, online growth, live migration
(torch counterpart of `repro.memctl`).

* `telemetry`: counters of the rows the lookups read, on the device
  (`index_add_` over the lookup's indices, carried like optimizer state)
  and a store's own per-shard counts, reported as dead / hot / cold
  shares.
* `growth`: `grow` / `grow_model` enlarge a table in place, append-only,
  the new rows copies of their coarse-lattice parents, so lookups at
  pre-growth points read the same values in every storage kind.
* `migrate`: `migrate` / `migrate_model` move a live model between
  placement cells (dense, tiered, sharded-tiered; any storage pair) by
  streaming the checkpoint's shard layout in memory; the same storage
  moves payload-exact.
* `controller`: `MemoryController`, the policy loop the trainer calls on
  a step schedule (`launch/train.py --grow-at`) and the serve engine
  between decode ticks (a dense table spilled to the tiered store with
  requests in flight).
"""

from repro_torch.memctl.controller import (  # noqa: F401
    LifecyclePolicy,
    MemoryController,
    parse_grow_at,
)
from repro_torch.memctl.growth import grow, grow_model, grown_cfg  # noqa: F401
from repro_torch.memctl.migrate import migrate, migrate_model  # noqa: F401
from repro_torch.memctl.telemetry import (  # noqa: F401
    grow_telemetry,
    store_telemetry,
    telemetry_init,
    telemetry_update,
    utilisation_report,
    utilisation_summary,
)
