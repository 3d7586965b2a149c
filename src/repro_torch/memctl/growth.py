"""Online capacity growth: enlarge a live value table, append-only (torch
counterpart of `repro.memctl.growth`).

1. **The torus grows index-preservingly** (`indexing.grow_torus`: K_0
   times the power-of-two factor), so every old lattice point keeps its
   flat index and the new points take [old_N, new_N).
2. **Each new row copies its coarse-lattice parent**
   (`indexing.growth_parents`, ``j % old_N`` here): fp32 rows copy, a
   1-byte table copies payload and scale, so the gathered values at
   pre-growth points are bit-identical copies.
3. **Each placement grows in its own layout.**  A dense table becomes a
   new `Parameter` of the grown rows on its device (its Adam `mu` / `nu`
   grow by the same copy); a `QuantizedTable` grows payload and scale; a
   tiered store appends host shards and a sharded-tiered store whole
   ranges, in place, once even where two holders share it.  The
   row-sharded placement (`sharded`) cannot grow (``supports_growth`` is
   false): reshard by relaunch, as in the reference.

The port's layers hold their config: `grow` and `grow_model` update the
LRAM layers' `cfg` and the model's `cfg` in place and return the new one.
The trainer then rebuilds its step (and re-binds the write-back), the
serve engine its binding.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import quant
from repro_torch.core import indexing, lookup
from repro_torch.core.lram import LRAM


def _growth_factor(old_n: int, new_num_rows: int) -> int:
    if new_num_rows <= old_n or new_num_rows % old_n:
        raise ValueError(f"can only grow to a multiple of the current size: "
                         f"{old_n} -> {new_num_rows}")
    factor = new_num_rows // old_n
    if factor & (factor - 1):
        raise ValueError(f"growth factor must be a power of two, got "
                         f"{factor}")
    return factor


def grown_cfg(cfg, new_num_rows: int):
    """The LRAMConfig grown to `new_num_rows`: `log2_locations` raised,
    the index-preserving torus attached and, for the sharded-tiered
    placement, `model_shards` times the factor (the appended ranges)."""
    factor = _growth_factor(cfg.num_locations, new_num_rows)
    kw: dict[str, Any] = {
        "log2_locations": cfg.log2_locations + factor.bit_length() - 1,
        "torus": indexing.grow_torus(cfg.torus_spec, factor),
    }
    if cfg.interp_impl == "sharded-tiered":
        ranges = cfg.model_shards
        if ranges <= 0:
            from repro_torch.distributed import context
            from repro_torch.distributed.sharded_lram import AXIS

            mesh = context.get_mesh()
            ranges = (mesh.size(AXIS)
                      if mesh is not None and AXIS in mesh.axis_names else 1)
        kw["model_shards"] = ranges * factor
    return dataclasses.replace(cfg, **kw)


@torch.no_grad()
def _grow_rows(x: torch.Tensor, parents: np.ndarray) -> torch.Tensor:
    """x with x[parents] appended (1-byte payloads moved as bytes)."""
    raw = x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x
    idx = torch.from_numpy(parents).to(raw.device)
    grown = torch.cat([raw, raw.index_select(0, idx)])
    return grown.view(x.dtype) if raw is not x else grown


def _grow_table(table, new_num_rows: int, parents: np.ndarray,
                seen: set[int]):
    """One table grown: a store in place (once: `seen` holds the ids of
    the stores already grown), a `QuantizedTable` or an fp32 tensor
    anew (a `Parameter` stays one)."""
    if lookup.is_store(table):
        if id(table) not in seen:
            seen.add(id(table))
            table.grow_rows(new_num_rows, parents)
        return table
    if isinstance(table, quant.QuantizedTable):
        return quant.QuantizedTable(_grow_rows(table.q, parents),
                                    _grow_rows(table.scale, parents),
                                    table.kind)
    grown = _grow_rows(table.detach(), parents)
    return nn.Parameter(grown) if isinstance(table, nn.Parameter) else grown


def _refuse(plan, reason: str) -> None:
    if not plan.supports_growth:
        raise lookup.LookupPlanError(plan.placement, plan.storage,
                                     plan.kernel, reason)


def _plan_growth(cfg, new_num_rows: int):
    """(grown config, parent rows of [old_N, new_N))."""
    new_cfg = grown_cfg(cfg, new_num_rows)
    parents = indexing.growth_parents(cfg.torus_spec, new_cfg.torus_spec,
                                      cfg.num_locations, new_num_rows)
    return new_cfg, parents


def grow(layer: LRAM, new_num_rows: int):
    """Grow one LRAM layer's table to `new_num_rows`, IN PLACE (its
    `values` and `cfg`); returns the new LRAMConfig.  A store keeps its
    identity, so handles the engine or trainer hold stay valid."""
    cfg = layer.cfg
    _refuse(lookup.resolve(cfg),
            "placement cannot grow live (mesh-sharded dense tables reshard "
            "by relaunch, or migrate to sharded-tiered first)")
    new_cfg, parents = _plan_growth(cfg, new_num_rows)
    lookup.set_table(layer, _grow_table(layer.values, new_num_rows,
                                        parents, set()))
    layer.cfg = new_cfg
    return new_cfg


def grow_model(model, new_num_rows: int, *, opt_state=None):
    """Grow every memory layer of a `Transformer` to `new_num_rows`
    locations, IN PLACE: the tables, each LRAM layer's `cfg`, the model's
    `cfg` and, with `opt_state`, Adam's `mu` / `nu` of every dense table
    (parent-copied, a warm start like the values).  Returns the new
    ModelConfig."""
    model_cfg = model.cfg
    if model_cfg.lram is None or not model_cfg.lram_layers:
        raise ValueError(f"{model_cfg.name} has no LRAM memory layer")
    _refuse(lookup.resolve(model_cfg.lram), "placement cannot grow live")
    new_lram, parents = _plan_growth(model_cfg.lram, new_num_rows)
    seen: set[int] = set()
    lookup.map_memory_tables(
        model, lambda t: _grow_table(t, new_num_rows, parents, seen))
    for layer in model.modules():
        if isinstance(layer, LRAM):
            layer.cfg = new_lram
    if opt_state is not None:
        for key in ("mu", "nu"):
            lookup.map_memory_tables(
                opt_state[key],
                lambda t: _grow_table(t, new_num_rows, parents, seen))
    model.cfg = dataclasses.replace(model_cfg, lram=new_lram)
    return model.cfg
