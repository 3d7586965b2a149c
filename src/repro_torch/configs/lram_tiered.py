"""The `lram-tiered` arch (torch copy of `repro.configs.lram_tiered`).

The model shape is the reference's, letter for letter: clm, w=512, 6
layers, 8 heads, d_ff 1024, SwiGLU, RMSNorm, RoPE, vocab 30000, and the
memory FFN at layer 3 with 2^20 locations on the tiered placement: the
table (256 MiB fp32) lives in host RAM in 128 shards of 8192 rows, 32 of
them cached on the device (25% resident).  The smoke config (w=64, 2
layers, vocab 256, 2^16 locations) keeps 8 of 32 shards of 2048 rows
resident.  `--placement pallas` serves the same weights from a dense
table on the device.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import lram as lram_mod
from repro_torch.memstore import TieredSpec
from repro_torch.models.config import ModelConfig


def _base(vocab: int, w: int, layers: int) -> ModelConfig:
    return ModelConfig(
        name="lram-tiered",
        family="dense",
        num_layers=layers,
        d_model=w,
        num_heads=max(4, w // 64),
        num_kv_heads=max(4, w // 64),
        d_ff=2 * w,
        vocab_size=vocab,
        objective="clm",
        remat=False,
    )


def _with_tiered(cfg: ModelConfig, log2: int,
                 spec: TieredSpec) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        lram_layers=(cfg.num_layers // 2,),
        lram=lram_mod.memffn_config(
            cfg.d_model, log2, query_norm="batch",
            interp_impl="tiered", tiered=spec,
        ),
    )


def config() -> ModelConfig:
    # 2^20 x 64 f32 = 256 MiB table; cache 32/128 shards = 25% resident
    return _with_tiered(_base(vocab=30000, w=512, layers=6), log2=20,
                        spec=TieredSpec(shard_rows=8192, cache_slots=32))


def smoke_config() -> ModelConfig:
    # 2^16 x 64 f32 = 16 MiB in 32 shards; 8 slots (4 MiB) on the device
    return _with_tiered(_base(vocab=256, w=64, layers=2), log2=16,
                        spec=TieredSpec(shard_rows=2048, cache_slots=8))
