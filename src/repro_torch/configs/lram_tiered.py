"""The `lram-tiered` arch (torch copy of `repro.configs.lram_tiered`).

The model shape is the reference's, letter for letter: clm, w=512, 6
layers, 8 heads, d_ff 1024, SwiGLU, RMSNorm, RoPE, vocab 30000, and the
memory FFN at layer 3 with 2^20 locations (smoke: w=64, 2 layers, vocab
256, 2^16 locations).  Its default placement stays `tiered`; the tiered
store is not ported yet, so serve it on the dense placement with
`--placement pallas` (the CUDA kernels) or `reference` (plain, CPU only).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import lram as lram_mod
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


def _with_memory(cfg: ModelConfig, log2: int) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        lram_layers=(cfg.num_layers // 2,),
        lram=lram_mod.memffn_config(
            cfg.d_model, log2, query_norm="batch", interp_impl="tiered",
        ),
    )


def config() -> ModelConfig:
    # 2^20 x 64 f32 = 256 MiB table
    return _with_memory(_base(vocab=30000, w=512, layers=6), log2=20)


def smoke_config() -> ModelConfig:
    # 2^16 x 64 f32 = 16 MiB table
    return _with_memory(_base(vocab=256, w=64, layers=2), log2=16)
