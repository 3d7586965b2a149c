"""Usage telemetry: which memory rows the lookups read, and how recently
(torch counterpart of `repro.memctl.telemetry`).

* **Counters on the device** (`telemetry_init` / `telemetry_update`): a
  dict of per-bin hit counts and their exponential moving average, updated
  by one `index_add_` of the lookup's indices (no host sync).  The train
  step carries it beside Adam's state; `rows_per_bin` coarsens it for
  large tables.
* **Store counters** (`store_telemetry`): a tiered or sharded-tiered
  store counts its accesses a host shard (`row_stats`, plans with
  ``row_stats``), one bin a shard.
* **Reports** (`utilisation_summary`, `utilisation_report`): the dead,
  hot and cold shares of the bins, as numbers and as the reference's
  benchmark rows ``[name, us_per_call, derived]``.

`grow_telemetry` follows `memctl.grow`: the appended rows' bins start at
zero (dead).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Telemetry = dict[str, Any]


def telemetry_init(num_rows: int, *, rows_per_bin: int = 1,
                   device=None) -> Telemetry:
    """Zeroed counters for a table of `num_rows`, one bin a `rows_per_bin`
    consecutive rows (it must divide `num_rows`), on `device`."""
    if num_rows % rows_per_bin:
        raise ValueError(
            f"rows_per_bin={rows_per_bin} must divide num_rows={num_rows}")
    bins = num_rows // rows_per_bin
    return {
        "counts": torch.zeros(bins, dtype=torch.float32, device=device),
        "ema": torch.zeros(bins, dtype=torch.float32, device=device),
        "steps": torch.zeros((), dtype=torch.int32, device=device),
        "rows_per_bin": rows_per_bin,
    }


@torch.no_grad()
def telemetry_update(tel: Telemetry, idx: torch.Tensor, *,
                     decay: float = 0.95) -> Telemetry:
    """One observation: every element of the integer tensor `idx` (flat
    row ids, e.g. a lookup's (..., top_k) indices) adds 1 to its bin, and
    the EMA moves toward this step's hits.  Returns a new dict."""
    flat = idx.reshape(-1).long() // tel["rows_per_bin"]
    counts = tel["counts"]
    hits = torch.zeros_like(counts).index_add_(
        0, flat.to(counts.device),
        torch.ones(flat.numel(), dtype=counts.dtype, device=counts.device))
    return {
        "counts": counts + hits,
        "ema": decay * tel["ema"] + (1.0 - decay) * hits,
        "steps": tel["steps"] + 1,
        "rows_per_bin": tel["rows_per_bin"],
    }


def store_telemetry(store) -> Telemetry:
    """A snapshot from a store's own counters a shard (lifetime counts:
    `ema` mirrors `counts`, `steps` is the store's lookup count)."""
    counts, rows_per_bin = store.row_stats()
    counts = torch.from_numpy(np.asarray(counts, np.float32))
    return {
        "counts": counts,
        "ema": counts,
        "steps": torch.tensor(int(store.stats["lookups"]), dtype=torch.int32),
        "rows_per_bin": int(rows_per_bin),
    }


def grow_telemetry(tel: Telemetry, new_num_rows: int) -> Telemetry:
    """The counters of a grown table: the appended bins start dead."""
    rpb = int(tel["rows_per_bin"])
    if new_num_rows % rpb:
        raise ValueError(f"new_num_rows={new_num_rows} not divisible by "
                         f"rows_per_bin={rpb}")
    extra = new_num_rows // rpb - tel["counts"].shape[0]
    if extra < 0:
        raise ValueError("telemetry cannot shrink")
    pad = tel["counts"].new_zeros(extra)
    return {
        "counts": torch.cat([tel["counts"], pad]),
        "ema": torch.cat([tel["ema"], pad]),
        "steps": tel["steps"],
        "rows_per_bin": tel["rows_per_bin"],
    }


def utilisation_summary(tel: Telemetry, *, hot_frac: float = 0.1,
                        cold_quantile: float = 0.5) -> dict[str, Any]:
    """Dead, hot and cold shares of the bins, as plain numbers:

    * dead: bins never counted (`counts == 0`);
    * hot mass: the share of recent traffic (`ema`) on the hottest
      `hot_frac` of the bins;
    * cold: live bins whose `ema` is below `cold_quantile` times the live
      bins' median.
    """
    counts = tel["counts"].detach().cpu().numpy().astype(np.float64)
    ema = tel["ema"].detach().cpu().numpy().astype(np.float64)
    bins = counts.size
    dead = counts == 0
    dead_frac = float(dead.mean()) if bins else 0.0
    total = float(ema.sum())
    k = max(1, int(round(bins * hot_frac)))
    hot_mass = (float(np.sort(ema)[-k:].sum()) / total) if total > 0 else 0.0
    live = ema[~dead]
    if live.size:
        thresh = cold_quantile * float(np.median(live))
        cold_frac = float((live < thresh).mean())
    else:
        cold_frac = 0.0
    return {
        "bins": bins,
        "rows_per_bin": int(tel["rows_per_bin"]),
        "steps": int(tel["steps"]),
        "dead_frac": round(dead_frac, 4),
        "hot_frac": hot_frac,
        "hot_mass": round(hot_mass, 4),
        "cold_frac": round(cold_frac, 4),
    }


def utilisation_report(tel: Telemetry, *, prefix: str = "util",
                       hot_frac: float = 0.1,
                       cold_quantile: float = 0.5) -> list[list[Any]]:
    """`utilisation_summary` as benchmark rows (`us_per_call` 0.0: the
    rows are derived, not timed)."""
    s = utilisation_summary(tel, hot_frac=hot_frac,
                            cold_quantile=cold_quantile)
    meta = (f"bins={s['bins']} rows_per_bin={s['rows_per_bin']} "
            f"steps={s['steps']}")
    return [
        [f"{prefix}_dead_frac", 0.0, f"{s['dead_frac']:.4f} {meta}"],
        [f"{prefix}_hot{int(round(hot_frac * 100))}_mass", 0.0,
         f"{s['hot_mass']:.4f} {meta}"],
        [f"{prefix}_cold_frac", 0.0, f"{s['cold_frac']:.4f} {meta}"],
    ]
