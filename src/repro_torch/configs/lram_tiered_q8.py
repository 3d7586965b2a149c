"""`lram-tiered-q8` (torch copy of `repro.configs.lram_tiered_q8`): the
`lram-tiered` model and tiering layout with an int8 value table.  Host
shards, the device cache and every fill carry 1-byte rows plus per-row
fp32 scales: 68 B per entry instead of 256 at m=64.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import lram_tiered


def _quantize(cfg):
    spec = dataclasses.replace(cfg.lram.tiered, quant="int8")
    return dataclasses.replace(
        cfg,
        name="lram-tiered-q8",
        lram=dataclasses.replace(cfg.lram, table_quant="int8", tiered=spec),
    )


def config():
    return _quantize(lram_tiered.config())


def smoke_config():
    return _quantize(lram_tiered.smoke_config())
