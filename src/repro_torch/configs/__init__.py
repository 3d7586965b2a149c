"""Architecture registry of the port: `get_config(name)` /
`get_smoke_config(name)` and `with_lram(cfg)`, as in `repro.configs`.

Registered: the reference's ten public archs of every family (`ARCHS`, in
the reference's order: dense yi-9b, qwen2-1.5b, starcoder2-3b,
h2o-danube-3-4b; hybrid zamba2-2.7b; MoE phi3.5-moe-42b-a6.6b,
mixtral-8x7b; SSM mamba2-1.3b; enc-dec whisper-small; VLM qwen2-vl-72b;
full configs in bfloat16, smoke configs in float32), the paper's
`lram-bert-*` models and the tiered serving archs (`lram-sharded-tiered`
among them).  Any other name raises KeyError listing the registered ones.
`with_lram(cfg)` inserts the paper's memory FFN into any registered
arch, as the reference's does (a hybrid then fails at `init`, as the
reference's does: no memory layer inside hybrid units).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.core import lram as lram_mod
from repro_torch.models.config import ModelConfig

ARCHS = ("yi-9b", "qwen2-1.5b", "starcoder2-3b", "h2o-danube-3-4b",
         "zamba2-2.7b", "phi3.5-moe-42b-a6.6b", "mixtral-8x7b",
         "mamba2-1.3b", "whisper-small", "qwen2-vl-72b")

_MODULES = {
    "yi-9b": "yi_9b",
    "qwen2-1.5b": "qwen2_1_5b",
    "starcoder2-3b": "starcoder2_3b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "zamba2-2.7b": "zamba2_2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "whisper-small": "whisper_small",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "lram-bert-baseline": "lram_bert",
    "lram-bert-pkm": "lram_bert",
    "lram-bert-small": "lram_bert",
    "lram-bert-medium": "lram_bert",
    "lram-bert-large": "lram_bert",
    "lram-tiered": "lram_tiered",
    "lram-tiered-q8": "lram_tiered_q8",
    "lram-sharded-tiered": "lram_sharded_tiered",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def _build(name: str, which: str) -> ModelConfig:
    make = getattr(_module(name), which)
    if name.startswith("lram-bert"):
        return make(variant=name.removeprefix("lram-bert-"))
    return make()


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _build(name, "config")
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    cfg = _build(name, "smoke_config")
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def with_lram(cfg: ModelConfig, log2_locations: int = 20,
              layer: int | None = None) -> ModelConfig:
    """Insert the paper's memory-augmented FFN at one layer of any arch
    (default the middle one), with a batchnorm query, as the reference's
    `with_lram`: heads = d_model // 16, a table of 2^log2_locations
    rows of 64 in `LRAMConfig`'s default dtype, float32, the reference's
    default too whatever the model's dtype (a bfloat16 table is
    `table_dtype="bfloat16"` on the returned `lram`).  Its placement is
    the config's default (`reference`); a server sets `pallas` for the
    kernels."""
    layer = cfg.num_layers // 2 if layer is None else layer
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}+lram{log2_locations}",
        lram_layers=(layer,),
        lram=lram_mod.memffn_config(
            cfg.d_model, log2_locations, query_norm="batch"
        ),
    )
