"""The `lram-sharded-tiered` arch (torch copy of
`repro.configs.lram_sharded_tiered`).

`lram-tiered`'s model with its table split into `model_shards`
contiguous row ranges, each a tiered store of its own with its own device
cache (`repro_torch.distributed.sharded_lram.ShardedTieredStore`,
`interp_impl="sharded-tiered"`).  Full: 2^20 rows over 4 ranges, each 32
shards of 8,192 rows with 8 cache slots (25% resident within its range).
Smoke: 2^16 rows over 2 ranges of 16 shards of 2,048 rows, 4 slots a
range.  `--cache-slots N` on the serve CLI resizes every range's cache
(32 makes the whole full-width table resident).  Write-back training,
shard-streaming checkpoints (a plain tiered store's, byte for byte) and
the serve engine's prefetch run through the range stores.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import lram_tiered


def _shard(cfg, ranges: int, cache_slots: int):
    return dataclasses.replace(
        cfg,
        name="lram-sharded-tiered",
        lram=dataclasses.replace(
            cfg.lram, interp_impl="sharded-tiered", model_shards=ranges,
            tiered=dataclasses.replace(cfg.lram.tiered,
                                       cache_slots=cache_slots),
        ),
    )


def config():
    # 2^20 rows over 4 ranges: 32 shards of 8192 rows a range, each range
    # caching 8 slots
    return _shard(lram_tiered.config(), ranges=4, cache_slots=8)


def smoke_config():
    # 2^16 rows over 2 ranges of 16 shards (2048 rows each), 4 cache slots
    # a range: the table still exceeds the device caches together
    return _shard(lram_tiered.smoke_config(), ranges=2, cache_slots=4)
