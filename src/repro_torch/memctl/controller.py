"""The lifecycle policy loop: when to grow, when to spill (torch
counterpart of `repro.memctl.controller`).

`MemoryController` owns the decisions; `growth` and `migrate` the
mechanics.  Two call sites drive it:

* **the trainer** (`launch/train.py --grow-at STEP:LOG2[,...]`):
  `on_train_step` fires each scheduled growth once when its step comes,
  growing the tables and Adam's moments in place; the trainer then
  rebuilds its step.  `catch_up` applies the growths a resumed
  checkpoint's step had already passed, before the restore, so the
  restore target has the grown shape.
* **the serve engine** (`ServeEngine(..., controller=...)`): `on_tick`
  runs between decode ticks.  When the dense table's device bytes exceed
  `hbm_budget_bytes` (or at the tick `spill_at_tick`, for tests and
  demos) it migrates the table to the tiered placement and calls
  `ServeEngine.swap_model`: the slots and the KV cache carry every
  request in flight across the move.  On the same tick it enforces the
  per-tenant overlays' TTL and byte budget against the engine's
  `OverlayManager` (`_overlay_tick`): detached tenants idle past
  `tenant_ttl_ticks` expire, and beyond `tenant_budget_bytes` the least
  recently used detached tenants are offloaded, spilled to
  `overlay_spill_dir` (restored on their next attach) or dropped without
  one; each offload is an ``overlay_expire`` / ``overlay_spill`` event.

Observability (`repro_torch.obs`, the reference's names): a growth is a
`memctl.grow` span and event and sets the gauge `memctl.num_locations`;
a spill is a `memctl.spill` span and event, with the gauge
`memctl.table_device_bytes` before (the dense table) and after (the
tiered caches); each overlay event is a `memctl.overlay` event; with obs
armed every tick refreshes the gauges `memctl.util_dead_frac`,
`util_hot_mass` and `util_cold_frac` from the engine's store (which reads
its per-shard counts).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from repro_torch import obs
from repro_torch.core import lookup
from repro_torch.memctl import growth, migrate, telemetry


def parse_grow_at(arg: str) -> tuple[tuple[int, int], ...]:
    """Parse `--grow-at`: "STEP:NEW_LOG2[,STEP:NEW_LOG2...]"."""
    events = []
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            step_s, log2_s = part.split(":")
            events.append((int(step_s), int(log2_s)))
        except ValueError:
            raise ValueError(f"bad --grow-at entry {part!r}; expected "
                             f"STEP:NEW_LOG2") from None
    events.sort()
    for (s0, l0), (s1, l1) in zip(events, events[1:]):
        if s1 == s0:
            raise ValueError(
                f"--grow-at steps must be distinct: step {s0} appears "
                f"twice (grow straight to 2^{max(l0, l1)} instead)")
        if l1 <= l0:
            raise ValueError(
                f"--grow-at sizes must increase: step {s1} grows to "
                f"2^{l1} after step {s0} grew to 2^{l0}")
    return tuple(events)


@dataclasses.dataclass(frozen=True)
class LifecyclePolicy:
    """What the controller reacts to (every trigger optional)."""

    grow_at: tuple[tuple[int, int], ...] = ()  # (step, new_log2_locations)
    hbm_budget_bytes: int | None = None        # serve: spill dense beyond
    spill_at_tick: int | None = None           # serve: deterministic spill
    spill_tiered: Any = None                   # TieredSpec for the spill
    # per-tenant overlays (repro_torch.serving.overlay), enforced on the
    # same tick: detached tenants idle `tenant_ttl_ticks` expire; beyond
    # `tenant_budget_bytes` of overlays the least recently used detached
    # tenants are offloaded, to `overlay_spill_dir` (.npz, restored on
    # the next attach) or dropped without one
    tenant_ttl_ticks: int | None = None
    tenant_budget_bytes: int | None = None
    overlay_spill_dir: str | None = None


def _default_spill_spec(num_locations: int):
    from repro_torch.memstore import TieredSpec

    # shard_rows must divide N (a power of two); ~32 shards, >= 512 rows
    shard_rows = max(512, min(8192, num_locations // 32))
    while num_locations % shard_rows:
        shard_rows //= 2
    return TieredSpec(shard_rows=shard_rows,
                      cache_slots=max(2, (num_locations // shard_rows) // 4))


class MemoryController:
    """The policy loop over `growth` and `migrate` (the module docstring
    names its two call sites).  `events` lists what it applied."""

    def __init__(self, policy: LifecyclePolicy):
        self.policy = policy
        # grow_at events applied, by (step, log2): shared by on_train_step
        # and catch_up, so a run and its relaunch apply one schedule
        self._grown: set[tuple[int, int]] = set()
        self._spilled = False
        self.events: list[dict[str, Any]] = []

    # ------------------------------------------------------------ training

    def _apply_growth(self, model, opt_state, step: int,
                      new_log2: int) -> None:
        obs.gauge("memctl.num_locations").set(model.cfg.lram.num_locations)
        t0 = time.perf_counter()
        with obs.span("memctl.grow", step=step, new_log2=new_log2):
            growth.grow_model(model, 2**new_log2, opt_state=opt_state)
        pause_s = round(time.perf_counter() - t0, 4)
        self._grown.add((step, new_log2))
        self.events.append({"event": "grow", "step": step,
                            "new_log2": new_log2, "pause_s": pause_s})
        obs.gauge("memctl.num_locations").set(2**new_log2)
        obs.emit_event("memctl.grow", step=step, new_log2=new_log2,
                       pause_s=pause_s)

    def _fire(self, due, model, opt_state) -> bool:
        changed = False
        for ev_step, new_log2 in self.policy.grow_at:
            if due(ev_step) and (ev_step, new_log2) not in self._grown \
                    and 2**new_log2 > model.cfg.lram.num_locations:
                self._apply_growth(model, opt_state, ev_step, new_log2)
                changed = True
        return changed

    def on_train_step(self, step: int, model, opt_state=None) -> bool:
        """Fire the growths scheduled at `step` (model and `opt_state`
        grow in place).  True when the model changed: rebuild the train
        step against it."""
        return self._fire(lambda s: s == step, model, opt_state)

    def catch_up(self, resume_step: int, model, opt_state=None) -> bool:
        """Apply every growth scheduled before `resume_step` (those at it
        the loop fires), so a checkpoint taken after a growth restores
        into the grown shape."""
        return self._fire(lambda s: s < resume_step, model, opt_state)

    # ------------------------------------------------------------- serving

    def _table_device_bytes(self, model_cfg) -> int:
        lram = model_cfg.lram
        return (len(model_cfg.lram_layers)
                * lram.num_locations * lram.table_bytes_per_entry)

    def _spill_due(self, engine) -> bool:
        pol = self.policy
        if pol.spill_at_tick is not None \
                and engine.ticks >= pol.spill_at_tick:
            return True
        return (pol.hbm_budget_bytes is not None
                and self._table_device_bytes(engine.cfg)
                > pol.hbm_budget_bytes)

    def _overlay_tick(self, engine) -> None:
        """Enforce the overlays' TTL and byte budget against the engine's
        `OverlayManager` (attached tenants are never touched); the events
        join `events`."""
        pol = self.policy
        if pol.tenant_ttl_ticks is None and pol.tenant_budget_bytes is None:
            return
        manager = getattr(engine, "overlays", None)
        if manager is None:
            return
        new_events = manager.enforce(
            tick=engine.ticks, ttl_ticks=pol.tenant_ttl_ticks,
            budget_bytes=pol.tenant_budget_bytes,
            spill_dir=pol.overlay_spill_dir)
        self.events.extend(new_events)
        for ev in new_events:
            obs.emit_event("memctl.overlay", **{
                k: (v if isinstance(v, (int, float, str, bool)) else str(v))
                for k, v in ev.items()})

    def _utilisation_gauges(self, engine) -> None:
        """The `memctl.util_*` gauges from the engine's first store's own
        per-shard counts; only with obs armed (the summary reads and
        sorts the counts on the host)."""
        if not obs.enabled():
            return
        for _, store in getattr(engine, "stores", []):
            s = telemetry.utilisation_summary(
                telemetry.store_telemetry(store))
            obs.gauge("memctl.util_dead_frac").set(s["dead_frac"])
            obs.gauge("memctl.util_hot_mass").set(s["hot_mass"])
            obs.gauge("memctl.util_cold_frac").set(s["cold_frac"])
            break  # one memory table a model

    def on_tick(self, engine) -> bool:
        """Between decode ticks: enforce the overlays' lifecycle, and
        spill a dense table that outgrew its budget (or whose tick came)
        to the tiered store.  True when the engine's model was swapped
        (its store-stat baseline is stale)."""
        self._overlay_tick(engine)
        self._utilisation_gauges(engine)
        if self._spilled or engine.cfg.lram is None:
            return False
        if self.policy.hbm_budget_bytes is None \
                and self.policy.spill_at_tick is None:
            return False
        plans = lookup.model_plans(engine.cfg)
        if not plans or plans[0].placement != "dense":
            self._spilled = True  # already off the device: nothing to do
            return False
        if not self._spill_due(engine):
            return False
        lram = engine.cfg.lram
        # an explicit spec, else the config's own TieredSpec (a tiered
        # arch served dense keeps its geometry), else one sized from N
        spec = (self.policy.spill_tiered or lram.tiered
                or _default_spill_spec(lram.num_locations))
        dst = dataclasses.replace(lram, interp_impl="tiered", tiered=spec)
        obs.gauge("memctl.table_device_bytes").set(
            self._table_device_bytes(engine.cfg))
        t0 = time.perf_counter()
        with obs.span("memctl.spill", tick=engine.ticks):
            migrate.migrate_model(engine.model, dst)
            engine.swap_model(engine.model)
            for _, store in engine.stores:
                store.warm()
        pause_s = round(time.perf_counter() - t0, 4)
        # after the spill the device holds the tiered caches, not the table
        obs.gauge("memctl.table_device_bytes").set(sum(
            store.cache_np.nbytes
            for _, store in engine.stores if hasattr(store, "cache_np")))
        self._spilled = True
        self.events.append({"event": "spill", "tick": engine.ticks,
                            "placement": "dense->tiered",
                            "pause_s": pause_s})
        obs.emit_event("memctl.spill", tick=engine.ticks,
                       placement="dense->tiered", pause_s=pause_s)
        return True
