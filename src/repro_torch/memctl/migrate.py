"""Live plan-to-plan migration: move a value table between placement ×
storage cells without a restart (torch counterpart of
`repro.memctl.migrate`).

The source table is read in storage form (the 1-byte payload and per-row
scales of a quantized table, bf16 rows as their raw bits, fp16 rows as
numpy float16, fp32 rows otherwise) and streamed into the
target: a store target (`LookupPlan.build_empty`) shard by shard through
`load_shard`, the checkpoint's byte layout in memory; a dense target
whole.  The target lands on the source table's device.

* Same storage: payload-exact (bytes move, nothing is requantized), so
  dense -> tiered -> sharded-tiered -> dense gives the same logits; a
  bf16 or fp16 table keeps its bits (a dense 2-byte table spills into a
  host tier of its dtype, where the reference's spill target is a
  float32 tier: its `build_empty` takes no dtype).
* Quantized -> fp32 dequantizes exactly; fp32 -> quantized rounds to
  nearest, within `quant.max_abs_error_bound`; a quantized pair of other
  kinds requantizes through fp32.

The row-sharded placement (``requires_mesh``) does not migrate live.
`migrate_model` swaps every memory layer's table and config; the serve
engine applies it between decode ticks through `MemoryController` and
`ServeEngine.swap_model`, so in-flight requests keep their slots and KV
cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch import quant
from repro_torch.core import lookup
from repro_torch.core.lram import LRAM


def _device(table) -> torch.device:
    if lookup.is_store(table):
        return table.device
    if isinstance(table, quant.QuantizedTable):
        return table.q.device
    return table.device


def _read_rows(table, lo: int, hi: int):
    """(payload, scales or None) of rows [lo, hi) of any table, in storage
    form (fp8 as its uint8 bytes, bf16 as its uint16 bits), on the host."""
    if lookup.is_store(table):
        return table._read_rows_raw(np.arange(lo, hi, dtype=np.int64))
    if isinstance(table, quant.QuantizedTable):
        q = table.q[lo:hi]
        if q.dtype == torch.float8_e4m3fn:
            q = q.view(torch.uint8)
        return q.cpu().numpy(), table.scale[lo:hi].cpu().numpy()
    if table.dtype == torch.bfloat16:
        return quant.bf16_bits(table[lo:hi]), None
    return table[lo:hi].detach().cpu().numpy(), None


def _to_fp32(payload: np.ndarray, scales) -> np.ndarray:
    if scales is None:
        return quant.host_rows_f32(payload)
    return quant.dequantize_rows_np(payload, scales)


def migrate_table(table, src_cfg, dst_cfg):
    """`dst_cfg`'s table built from `table` (laid out as `src_cfg` says),
    on the same device."""
    dst_plan = lookup.resolve(dst_cfg)
    for plan in (lookup.resolve(src_cfg), dst_plan):
        if plan.requires_mesh:
            raise lookup.LookupPlanError(
                plan.placement, plan.storage, plan.kernel,
                "mesh-sharded dense tables do not migrate live: reshard "
                "by relaunch, or use the sharded-tiered placement")
    if src_cfg.num_locations != dst_cfg.num_locations \
            or src_cfg.m != dst_cfg.m:
        raise ValueError(
            f"migration cannot change the table shape: "
            f"{src_cfg.num_locations}x{src_cfg.m} -> "
            f"{dst_cfg.num_locations}x{dst_cfg.m} (grow first)")
    device = _device(table)
    if dst_plan.build_empty is not None:  # a store: stream its shards
        dst = dst_plan.build_empty()
        rows = dst.shard_rows
        for i in range(dst.num_shards):
            # load_shard converts: the same kind passes bytes through,
            # fp32 rows quantize to nearest, another kind requantizes
            dst.load_shard(i, *_read_rows(table, i * rows, (i + 1) * rows))
        if lookup.is_store(table):
            dst.writeback_lr = table.writeback_lr
        return dst.to(device)

    payload, scales = _read_rows(table, 0, src_cfg.num_locations)
    if dst_plan.storage == "fp32":  # in the target's table dtype
        return nn.Parameter(torch.from_numpy(
            np.ascontiguousarray(_to_fp32(payload, scales))).to(
                device, dst_cfg.torch_table_dtype))
    if scales is None or payload.dtype != quant.storage_dtype(
            dst_plan.storage):
        payload, scales = quant.quantize_rows_np(_to_fp32(payload, scales),
                                                 dst_plan.storage)
    return quant.QuantizedTable.from_payload(payload, scales,
                                             dst_plan.storage).to(device)


def migrate(layer: LRAM, dst_cfg):
    """Migrate one LRAM layer's table to `dst_cfg`'s cell, IN PLACE (its
    `values` and `cfg`; the query norm is placement-free); returns
    `dst_cfg`."""
    lookup.set_table(layer, migrate_table(layer.values, layer.cfg, dst_cfg))
    layer.cfg = dst_cfg
    return dst_cfg


def migrate_model(model, dst_lram_cfg):
    """Migrate every memory layer of a `Transformer` to `dst_lram_cfg`'s
    cell, IN PLACE (tables shared between layers migrate once); returns
    the new ModelConfig, also set as `model.cfg`."""
    model_cfg = model.cfg
    if model_cfg.lram is None or not model_cfg.lram_layers:
        raise ValueError(f"{model_cfg.name} has no LRAM memory layer")
    src_cfg = model_cfg.lram
    done: dict[int, object] = {}

    def _migrate(table):
        if id(table) not in done:
            done[id(table)] = migrate_table(table, src_cfg, dst_lram_cfg)
        return done[id(table)]

    lookup.map_memory_tables(model, _migrate)
    for layer in model.modules():
        if isinstance(layer, LRAM):
            layer.cfg = dst_lram_cfg
    model.cfg = dataclasses.replace(model_cfg, lram=dst_lram_cfg)
    return model.cfg
