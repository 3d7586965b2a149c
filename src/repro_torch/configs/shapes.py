"""The assigned input-shape set and the empty tensors of the dry-run's
inputs (torch counterpart of `repro.configs.shapes`).

Every (arch x shape) pair is a dry-run cell:

  train_4k     seq 4096,    global_batch 256  -> the train step
  prefill_32k  seq 32768,   global_batch 32   -> prefill (forward + caches)
  decode_32k   seq 32768,   global_batch 128  -> decode_step (1 new token)
  long_500k    seq 524288,  global_batch 1    -> decode_step; only for
               sub-quadratic archs (SSM / hybrid / SWA)

`input_specs` gives the reference's `ShapeDtypeStruct` stand-ins as empty
tensors of the same shapes and dtypes, on the `meta` device by default:
they carry a shape and a dtype and no data.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, validate_cell


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape_name: str) -> str | None:
    return validate_cell(cfg, shape_name)


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _extras(cfg: ModelConfig, b: int, s: int, device) -> dict:
    """Modality-frontend stubs: precomputed frame / patch embeddings, and
    a VLM's M-RoPE positions (3, B, S)."""
    extras = {}
    dt = cfg.torch_dtype
    if cfg.family == "encdec":
        extras["encoder_embeds"] = _empty((b, cfg.encoder_len, cfg.d_model),
                                          dt, device)
    if cfg.vision_tokens:
        extras["vision_embeds"] = _empty((b, cfg.vision_tokens, cfg.d_model),
                                         dt, device)
        extras["positions"] = _empty((3, b, s), torch.int32, device)
    return extras


def input_specs(cfg: ModelConfig, shape_name, device="meta") -> dict:
    """Empty tensors of every input of the cell's step (`shape_name` a
    name of `SHAPES`, or a `ShapeCell` of its own), global shapes:

    train  -> {"batch": {tokens, labels, ...extras}}
    prefill-> {"batch": {tokens, ...extras}}
    decode -> {"tokens": (B, 1), "cache": the whole cache
               (`transformer.cache_shapes`' leaves)}
    """
    cell = shape_name if isinstance(shape_name, ShapeCell) \
        else SHAPES[shape_name]
    b, s = cell.global_batch, cell.seq_len
    if cell.mode in ("train", "prefill"):
        batch = {"tokens": _empty((b, s), torch.int32, device)}
        if cell.mode == "train":
            batch["labels"] = _empty((b, s), torch.int32, device)
        batch.update(_extras(cfg, b, s, device))
        return {"batch": batch}
    return {
        "tokens": _empty((b, 1), torch.int32, device),
        "cache": {name: {k: _empty(shape, dtype, device)
                         for k, (shape, dtype) in leaves.items()}
                  for name, leaves in
                  transformer.cache_shapes(cfg, b, s).items()},
    }
