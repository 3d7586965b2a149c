"""Per-tenant copy-on-write memory overlays over one shared base table
(torch counterpart of `repro.serving.overlay`; host-side numpy, as the
reference's).

Serving many users from one lattice table means each tenant needs their
own view of that table without a copy of it.  A `TenantOverlay` is that
view: a small sparse set of rows per memory layer, stored in the base
table's storage kind (fp32 rows, or a 1-byte payload and a per-row scale
through `repro_torch.quant`: the base table's rounding, so overlay reads
compose with the dense, tiered and sharded-tiered placements in fp32,
int8 and fp8 alike).  A row in the overlay shadows the base row; the
others read through to the base.

`OverlayManager` is the serve engine's side:

  * **attach / detach**: the engine binds a tenant to a decode slot at
    admission and releases it at retirement.  The manager keeps
    fixed-shape per-slot packs (`ids` (L, B, C) int32, `deltas` (L, B, C,
    m) fp32, ``delta = dequant(overlay row) - base row``) that the model
    reads through `repro_torch.core.overlay`; they change in place on the
    host, never in shape, so attaching never rebuilds the engine's decode
    graph.  An overlay holds at most C (the pack's capacity) rows a
    layer, so the pack covers the whole overlay.
  * **writeback**: after each decode tick the engine hands back the
    tick's lattice accesses, and the manager applies the Hebbian update
    ``row <- row + lr * Σ w_k · y_head`` to each accessed row of the
    slot's tenant (copy-on-write: the base row is read once, then the
    tenant owns the copy).  Memory at inference time, not SGD.
  * **lifecycle**: `enforce` (driven by `repro_torch.memctl` on the
    engine's tick) expires idle tenants past their TTL and spills the
    least recently used to ``.npz`` files when the byte budget is
    exceeded; a spilled tenant is restored on its next attach.  Attached
    tenants are never touched, so requests in flight ride through.
  * **persistence**: `save_all` / `load_all` park every overlay beside
    the base table's checkpoint, so tenant memory survives a restart.

The files are the reference's: one ``overlay_<tenant>.npz`` a tenant,
1-byte payloads as ``uint8`` views, so a file either package writes loads
in the other.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np

from repro_torch import quant

def _safe(tenant_id: str) -> str:
    """Filesystem-safe tenant-id encoding (alnum/dash/underscore kept)."""
    return "".join(
        c if (c.isalnum() or c in "-_") else f"-{ord(c):02x}"
        for c in str(tenant_id)
    )


class TenantOverlay:
    """One tenant's sparse row view: per-layer ``row -> stored row`` in
    the base table's storage form, with insertion-ordered recency (a
    rewrite moves the row to newest; beyond ``max_rows`` the oldest row
    falls back to the base — copy-on-write in both directions)."""

    def __init__(self, tenant_id: str, *, num_layers: int, m: int,
                 storage: str = "fp32", max_rows: int = 64):
        if storage != "fp32":
            quant.check_kind(storage)
        self.tenant_id = tenant_id
        self.num_layers = num_layers
        self.m = m
        self.storage = storage
        self.max_rows = max_rows
        # layer -> {row_id: (payload (m,), scale | None)}; dict order is
        # recency (oldest first)
        self.rows: list[dict[int, tuple[np.ndarray, Any]]] = [
            {} for _ in range(num_layers)
        ]
        self.last_used_tick = 0
        self.writes = 0
        self.spilled_path: str | None = None

    # ------------------------------------------------------------ row ops

    def write(self, layer: int, row: int, values) -> None:
        """Store fp32 ``values`` as this tenant's row (storage-form
        round trip, same grid as the base table)."""
        d = self.rows[layer]
        d.pop(row, None)
        v = np.asarray(values, np.float32).reshape(self.m)
        if self.storage == "fp32":
            d[row] = (v.copy(), None)
        else:
            q, scale = quant.quantize_rows_np(v, self.storage)
            d[row] = (q, np.float32(scale))
        while len(d) > self.max_rows:
            d.pop(next(iter(d)))  # oldest falls back to the base row
        self.writes += 1

    def read(self, layer: int, row: int) -> np.ndarray | None:
        """Dequantized fp32 row, or None when the base row shows through."""
        entry = self.rows[layer].get(row)
        if entry is None:
            return None
        payload, scale = entry
        if scale is None:
            return payload.astype(np.float32)
        return quant.dequantize_rows_np(
            payload[None], np.asarray([scale], np.float32)
        )[0]

    def evict(self, layer: int, row: int) -> bool:
        return self.rows[layer].pop(row, None) is not None

    def clear(self) -> None:
        for d in self.rows:
            d.clear()

    def touch(self, tick: int) -> None:
        self.last_used_tick = max(self.last_used_tick, tick)

    @property
    def num_rows(self) -> int:
        return sum(len(d) for d in self.rows)

    @property
    def nbytes(self) -> int:
        kind = None if self.storage == "fp32" else self.storage
        return self.num_rows * quant.bytes_per_entry(self.m, kind)

    def packed_rows(self, layer: int) -> list[int]:
        """Row ids in recency order (oldest first) — at most max_rows, so
        a pack of that capacity always covers the whole overlay."""
        return list(self.rows[layer])

    # ------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        """One ``.npz`` per tenant, storage-form payloads (fp8 riding as
        a uint8 view so npz needs no custom dtypes)."""
        arrays: dict[str, np.ndarray] = {
            "tenant": np.asarray(str(self.tenant_id)),
            "storage": np.asarray(self.storage),
            "layers": np.asarray(self.num_layers, np.int64),
            "last_used_tick": np.asarray(self.last_used_tick, np.int64),
            "writes": np.asarray(self.writes, np.int64),
        }
        for layer, d in enumerate(self.rows):
            ids = np.asarray(list(d), np.int64)
            arrays[f"ids{layer}"] = ids
            if not len(d):
                continue
            payload = np.stack([d[r][0] for r in d])
            if self.storage == "fp32":
                arrays[f"payload{layer}"] = payload
            else:
                arrays[f"payload{layer}"] = payload.view(np.uint8)
                arrays[f"scale{layer}"] = np.asarray(
                    [d[r][1] for r in d], np.float32
                )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, *, m: int) -> "TenantOverlay":
        with np.load(path) as z:
            ov = cls(
                str(z["tenant"]),
                num_layers=int(z["layers"]),
                m=m,
                storage=str(z["storage"]),
            )
            ov.last_used_tick = int(z["last_used_tick"])
            ov.writes = int(z["writes"])
            for layer in range(ov.num_layers):
                ids = z[f"ids{layer}"]
                if not len(ids):
                    continue
                payload = z[f"payload{layer}"]
                if ov.storage != "fp32":
                    payload = payload.view(quant.storage_dtype(ov.storage))
                    scales = z[f"scale{layer}"]
                    for i, r in enumerate(ids.tolist()):
                        ov.rows[layer][r] = (payload[i],
                                             np.float32(scales[i]))
                else:
                    for i, r in enumerate(ids.tolist()):
                        ov.rows[layer][r] = (
                            np.asarray(payload[i], np.float32), None
                        )
        return ov

    def restore_into(self, path: str) -> None:
        """Refill this (empty) overlay from a spill file in place."""
        loaded = TenantOverlay.load(path, m=self.m)
        if loaded.storage != self.storage:
            raise ValueError(
                f"overlay {self.tenant_id!r}: spill file stores "
                f"{loaded.storage}, manager expects {self.storage}"
            )
        self.rows = loaded.rows[:self.num_layers]
        while len(self.rows) < self.num_layers:
            self.rows.append({})
        self.last_used_tick = loaded.last_used_tick
        self.writes = loaded.writes


class OverlayManager:
    """Tenant registry + fixed-shape per-slot packs for `ServeEngine`.

    ``base_reader(layer, rows) -> (n, m) fp32`` is bound by the engine
    (and re-bound on `swap_model`, so a live dense -> tiered migration
    keeps the deltas consistent with wherever the base rows live)."""

    def __init__(self, *, num_layers: int, m: int, storage: str,
                 slots: int, rows: int, write_lr: float = 0.1,
                 spill_dir: str | None = None):
        if rows < 1:
            raise ValueError("overlay needs at least one row per slot")
        self.num_layers = num_layers
        self.m = m
        self.storage = storage
        self.capacity = rows
        self.write_lr = float(write_lr)
        self.spill_dir = spill_dir
        self.overlays: dict[str, TenantOverlay] = {}
        self.slot_tenant: list[str | None] = [None] * slots
        # the packs the model reads (repro_torch.core.overlay): changed in
        # place between ticks, never reshaped: one decode graph serves all
        self.ids = np.full((num_layers, slots, rows), -1, np.int32)
        self.deltas = np.zeros((num_layers, slots, rows, m), np.float32)
        self.stats: dict[str, int] = dict.fromkeys(
            ("attaches", "detaches", "writebacks", "overlay_hits",
             "overlay_lookups", "spills", "restores", "drops"), 0,
        )
        self._base_reader: Callable[[int, np.ndarray], np.ndarray] | None \
            = None

    # ------------------------------------------------------------- wiring

    def set_base_reader(
        self, fn: Callable[[int, np.ndarray], np.ndarray]
    ) -> None:
        self._base_reader = fn
        for b, tid in enumerate(self.slot_tenant):
            if tid is not None:
                self._refresh_slot(b)

    def get(self, tenant_id: str) -> TenantOverlay:
        """The tenant's overlay, created empty (or restored from its
        spill file) on first touch."""
        ov = self.overlays.get(tenant_id)
        if ov is None:
            ov = TenantOverlay(
                tenant_id, num_layers=self.num_layers, m=self.m,
                storage=self.storage, max_rows=self.capacity,
            )
            self.overlays[tenant_id] = ov
        if ov.spilled_path is not None and ov.num_rows == 0:
            if os.path.exists(ov.spilled_path):
                ov.restore_into(ov.spilled_path)
                self.stats["restores"] += 1
            ov.spilled_path = None
        return ov

    # ------------------------------------------------------ attach/detach

    def attach(self, slot: int, tenant_id: str | None, *,
               tick: int = 0) -> None:
        """Bind a tenant to a decode slot (None = anonymous request:
        the slot serves the pristine base table)."""
        self.detach(slot)
        if tenant_id is None:
            return
        ov = self.get(tenant_id)
        ov.touch(tick)
        self.slot_tenant[slot] = tenant_id
        self.stats["attaches"] += 1
        self._refresh_slot(slot)

    def detach(self, slot: int) -> None:
        if self.slot_tenant[slot] is None:
            return
        self.slot_tenant[slot] = None
        self.stats["detaches"] += 1
        self.ids[:, slot, :] = -1
        self.deltas[:, slot, :, :] = 0.0

    @property
    def attached(self) -> int:
        return sum(1 for t in self.slot_tenant if t is not None)

    def _refresh_slot(self, slot: int) -> None:
        """Re-resolve one slot's pack from its tenant's overlay rows:
        ``delta = dequant(overlay_row) - base_row`` per packed id."""
        tid = self.slot_tenant[slot]
        self.ids[:, slot, :] = -1
        self.deltas[:, slot, :, :] = 0.0
        if tid is None or self._base_reader is None:
            return
        ov = self.overlays[tid]
        for layer in range(self.num_layers):
            packed = ov.packed_rows(layer)
            if not packed:
                continue
            row_ids = np.asarray(packed, np.int64)
            base = np.asarray(
                self._base_reader(layer, row_ids), np.float32
            ).reshape(len(packed), self.m)
            eff = np.stack([ov.read(layer, r) for r in packed])
            self.ids[layer, slot, :len(packed)] = row_ids
            self.deltas[layer, slot, :len(packed)] = eff - base

    # ---------------------------------------------------------- writeback

    def writeback(self, slot: int, idx, w, y, *, tick: int = 0) -> None:
        """Fold one decode tick's lattice accesses of `slot` into its
        tenant's overlay: Hebbian ``row += lr * Σ_{hk: idx=row} w · y_h``
        on the *effective* (overlay-before-base) row value.

        idx/w: (L, H, K); y: (L, H, m) — the post-scale per-head outputs
        collected by `repro_torch.core.overlay`."""
        tid = self.slot_tenant[slot]
        if tid is None or self.write_lr == 0.0:
            return
        if self._base_reader is None:
            raise RuntimeError("OverlayManager has no base reader bound")
        ov = self.overlays[tid]
        idx = np.asarray(idx)
        w = np.asarray(w, np.float32)
        y = np.asarray(y, np.float32)
        for layer in range(self.num_layers):
            flat_r = idx[layer].reshape(-1)                  # (H*K,)
            top_k = idx[layer].shape[-1]
            contrib = (w[layer].reshape(-1)[:, None]
                       * np.repeat(y[layer], top_k, axis=0))  # (H*K, m)
            known = ov.rows[layer]
            self.stats["overlay_lookups"] += flat_r.size
            self.stats["overlay_hits"] += sum(
                1 for r in flat_r.tolist() if r in known
            )
            uniq, inv = np.unique(flat_r, return_inverse=True)
            agg = np.zeros((len(uniq), self.m), np.float32)
            np.add.at(agg, inv, contrib)
            base = np.asarray(
                self._base_reader(layer, uniq), np.float32
            ).reshape(len(uniq), self.m)
            for i, r in enumerate(uniq.tolist()):
                eff = ov.read(layer, r)
                if eff is None:
                    eff = base[i]                  # copy-on-write
                ov.write(layer, r, eff + self.write_lr * agg[i])
        ov.touch(tick)
        self.stats["writebacks"] += 1
        for b, t in enumerate(self.slot_tenant):
            if t == tid:
                self._refresh_slot(b)

    # ---------------------------------------------------------- lifecycle

    def total_bytes(self) -> int:
        return sum(ov.nbytes for ov in self.overlays.values())

    def enforce(self, *, tick: int, ttl_ticks: int | None = None,
                budget_bytes: int | None = None,
                spill_dir: str | None = None) -> list[dict[str, Any]]:
        """Apply TTL + byte-budget policy (called by
        `repro_torch.memctl.MemoryController.on_tick`).  Only *detached*
        tenants are expired/spilled — in-flight requests never lose
        their overlay mid-generation.  Returns lifecycle events in the
        controller's telemetry schema."""
        spill_dir = spill_dir or self.spill_dir
        attached = {t for t in self.slot_tenant if t is not None}
        events = []
        if ttl_ticks is not None:
            for tid, ov in list(self.overlays.items()):
                if tid in attached or ov.num_rows == 0:
                    continue
                if tick - ov.last_used_tick >= ttl_ticks:
                    events.append(self._offload(
                        tid, tick, spill_dir, "overlay_expire"
                    ))
        if budget_bytes is not None and self.total_bytes() > budget_bytes:
            lru = sorted(
                (ov.last_used_tick, tid)
                for tid, ov in self.overlays.items()
                if tid not in attached and ov.num_rows > 0
            )
            for _, tid in lru:
                if self.total_bytes() <= budget_bytes:
                    break
                events.append(self._offload(
                    tid, tick, spill_dir, "overlay_spill"
                ))
        return events

    def _offload(self, tenant_id: str, tick: int, spill_dir: str | None,
                 event: str) -> dict[str, Any]:
        ov = self.overlays[tenant_id]
        nbytes = ov.nbytes
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            path = os.path.join(
                spill_dir, f"overlay_{_safe(tenant_id)}.npz"
            )
            ov.save(path)
            ov.spilled_path = path
            self.stats["spills"] += 1
            action = "spill"
        else:
            self.stats["drops"] += 1
            action = "drop"
        ov.clear()
        return {"event": event, "tenant": tenant_id, "tick": tick,
                "bytes": nbytes, "action": action}

    # -------------------------------------------------------- persistence

    def save_all(self, dirpath: str) -> int:
        """Persist every non-empty overlay (one npz per tenant) beside
        the base-table checkpoint; returns the number written."""
        os.makedirs(dirpath, exist_ok=True)
        n = 0
        for tid, ov in self.overlays.items():
            if ov.spilled_path is not None and ov.num_rows == 0:
                self.get(tid)  # restore before persisting elsewhere
            if ov.num_rows == 0:
                continue
            ov.save(os.path.join(dirpath, f"overlay_{_safe(tid)}.npz"))
            n += 1
        return n

    def load_all(self, dirpath: str) -> int:
        """Register every persisted overlay found in `dirpath`."""
        if not os.path.isdir(dirpath):
            return 0
        n = 0
        for fn in sorted(os.listdir(dirpath)):
            if not (fn.startswith("overlay_") and fn.endswith(".npz")):
                continue
            ov = TenantOverlay.load(os.path.join(dirpath, fn), m=self.m)
            if ov.storage != self.storage:
                raise ValueError(
                    f"persisted overlay {ov.tenant_id!r} stores "
                    f"{ov.storage}, manager expects {self.storage}"
                )
            ov.max_rows = self.capacity
            for d in ov.rows:
                while len(d) > ov.max_rows:
                    d.pop(next(iter(d)))
            self.overlays[ov.tenant_id] = ov
            n += 1
        return n

    # ------------------------------------------------------------ reports

    def summary(self) -> dict[str, Any]:
        lookups = self.stats["overlay_lookups"]
        tenants = len(self.overlays)
        total = self.total_bytes()
        return {
            "tenants": tenants,
            "attached": self.attached,
            "rows": sum(ov.num_rows for ov in self.overlays.values()),
            "bytes": total,
            "bytes_per_tenant": round(total / tenants, 1) if tenants
            else 0.0,
            "hit_rate": round(self.stats["overlay_hits"] / lookups, 4)
            if lookups else 0.0,
            **self.stats,
        }
