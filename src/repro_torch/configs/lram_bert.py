"""The paper's own models (§3), torch copy of `repro.configs.lram_bert`: a
6-layer BERT-style MLM transformer, w=512, 8 heads, d_ff 2048, GELU,
layernorm, learned positions (max_seq 256), vocab 30000, with the 4th
layer's FFN replaced by the memory block dense(w->w) . LRAM(w->4w) .
dense(4w->w), batchnorm query, top-32.

Variants: baseline | pkm (the product-key baseline: 2^16 x 512 table, 8
heads, key dim 64, top-32, batchnorm query) | small (2^18 slots) | medium
(2^20) | large (2^22) — paper Tables 2 & 5.  The smoke configs (w=64, 3
layers, 4 heads, vocab 256, max_seq 64, the memory FFN at layer 1 with
2^16 slots; pkm 16^2 x 64, 2 heads, key dim 16, top-4) are the
reference's letter for letter.
"""

import dataclasses

from repro_torch.core import lram as lram_mod
from repro_torch.core.pkm import PKMConfig
from repro_torch.models.config import ModelConfig

_MEM_LAYER = 3  # "the fourth transformer layer" (0-indexed)

_LOG2 = {"small": 18, "medium": 20, "large": 22}

VARIANTS = ("baseline", "pkm", *_LOG2)


def _base(vocab: int = 30000, w: int = 512) -> ModelConfig:
    return ModelConfig(
        name="lram-bert-baseline",
        family="dense",
        num_layers=6,
        d_model=w,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,           # hidden width 2048, GELU (paper §3.2)
        vocab_size=vocab,
        objective="mlm",
        pos_scheme="learned",
        max_seq=256,
        act="gelu",
        norm="layer",
        remat=False,
    )


def _check(variant: str) -> None:
    if variant not in VARIANTS:
        raise KeyError(f"unknown lram-bert variant {variant!r}; known: "
                       f"{VARIANTS}")


def config(variant: str = "baseline") -> ModelConfig:
    _check(variant)
    cfg = _base()
    if variant == "baseline":
        return cfg
    if variant == "pkm":
        return dataclasses.replace(
            cfg,
            name="lram-bert-pkm",
            pkm_layers=(_MEM_LAYER,),
            pkm=PKMConfig(n_keys=256, heads=8, key_dim=64, value_dim=512,
                          top_k=32, query_norm="batch"),
        )
    return dataclasses.replace(
        cfg,
        name=f"lram-bert-{variant}",
        lram_layers=(_MEM_LAYER,),
        lram=lram_mod.memffn_config(cfg.d_model, _LOG2[variant],
                                    query_norm="batch"),
    )


def smoke_config(variant: str = "baseline") -> ModelConfig:
    _check(variant)
    cfg = dataclasses.replace(
        _base(vocab=256, w=64),
        name=f"lram-bert-{variant}-smoke",
        num_layers=3,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        max_seq=64,
    )
    if variant == "baseline":
        return cfg
    if variant == "pkm":
        return dataclasses.replace(
            cfg,
            pkm_layers=(1,),
            pkm=PKMConfig(n_keys=16, heads=2, key_dim=16, value_dim=64,
                          top_k=4, query_norm="batch"),
        )
    return dataclasses.replace(
        cfg,
        lram_layers=(1,),
        lram=lram_mod.memffn_config(64, 16, query_norm="batch"),
    )
