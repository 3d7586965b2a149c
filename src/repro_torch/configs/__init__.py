"""Architecture registry of the port: `get_config(name)` /
`get_smoke_config(name)`, as in `repro.configs`.  Only the archs whose
families are ported are registered (the paper's `lram-bert-*` models and
the tiered serving archs); the rest raise KeyError naming the reference's
list."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "lram-bert-baseline": "lram_bert",
    "lram-bert-pkm": "lram_bert",
    "lram-bert-small": "lram_bert",
    "lram-bert-medium": "lram_bert",
    "lram-bert-large": "lram_bert",
    "lram-tiered": "lram_tiered",
    "lram-tiered-q8": "lram_tiered_q8",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported to torch yet; ported: "
                       f"{sorted(_MODULES)} (see ROADMAP queue A)")
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
