"""Turn the reference's (params, state) pytrees into the port's modules.

The input is the JAX pytree with every leaf already a numpy array (for
example `jax.tree.map(np.asarray, params)`), so this module imports no
JAX.  Keys map one to one onto the `Transformer`'s `state_dict`: nested
dict keys join with "." and the leading layer axis of a stacked ("run", n)
segment is split into n per-layer entries.  Dense kernels keep their
(in, out) layout.  Batchnorm running stats come from `state`.

A memory layer's table (`...lram.values`) is an (N, m) fp32 array, or a
quantized table as ``{"q": payload, "scale": scales}``: the reference's
payload (int8, or float8_e4m3fn as its uint8 bytes) and per-row scales,
read from a `QuantizedTable` or, shard by shard, from a tiered store's
`shard_host` / `shard_scale_host`.  Each table is rebuilt in the layer's
own plan (`Parameter`, `QuantizedTable` or `TieredValueStore`); a payload
is carried bit for bit, never dequantized and requantized.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lookup
from repro_torch.core.lram import LRAM
from repro_torch.launch import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def state_dict_from_jax(params, state, cfg: ModelConfig
                        ) -> dict[str, torch.Tensor]:
    """The port's `state_dict` for the reference's (params, state)."""
    flat = _flatten({k: v for k, v in params.items() if k != "segments"})
    for si, seg in enumerate(transformer.layer_plan(cfg)):
        name = f"seg{si}"
        leaves = _flatten(params["segments"][name])
        if seg[0] == "run":
            for key, arr in leaves.items():
                if arr.shape[0] != seg[1]:
                    raise ValueError(f"{name}.{key}: expected {seg[1]} "
                                     f"stacked layers, got {arr.shape}")
                for i in range(seg[1]):
                    flat[f"segments.{name}.{i}.{key}"] = arr[i]
        else:
            for key, arr in leaves.items():
                flat[f"segments.{name}.{key}"] = arr
            # memffn_init's state is {"lram": {"qnorm": {mean, var}}}
            for key, arr in _flatten(state.get(name, {})).items():
                flat[f"segments.{name}.memffn.{key}"] = arr
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in flat.items()}


def _load_tables(model: transformer.Transformer,
                 flat: dict[str, torch.Tensor]) -> set[str]:
    """Rebuild every memory layer's table from its entries in `flat`
    (popped), in the layer's plan; returns the state_dict keys they fill."""
    filled = set()
    for name, layer in model.named_modules():
        if not isinstance(layer, LRAM):
            continue
        key = f"{name}.values"
        plan = lookup.resolve(layer.cfg)
        if key in flat:
            layer.values = plan.build_table(flat.pop(key))
        elif f"{key}.q" in flat:
            if plan.table_from_payload is None:
                raise ValueError(f"{key}: a quantized payload cannot fill "
                                 f"a table of {plan.storage} storage")
            layer.values = plan.table_from_payload(
                flat.pop(f"{key}.q").numpy(),
                flat.pop(f"{key}.scale").numpy())
        else:
            raise KeyError(f"no table for {key}")
        filled |= {k for k in model.state_dict() if k.startswith(key)}
    return filled


def model_from_jax(params, state, cfg: ModelConfig,
                   device="cuda") -> transformer.Transformer:
    """A `Transformer` holding the reference's weights, on `device`: the
    card unless the caller asks for "cpu".  Every key must match: the
    tables are rebuilt by `_load_tables`, the rest loaded as a state_dict."""
    device = resolve_device(device)
    model = transformer.Transformer(cfg)
    flat = state_dict_from_jax(params, state, cfg)
    filled = _load_tables(model, flat)
    missing, unexpected = model.load_state_dict(flat, strict=False)
    if unexpected or set(missing) - filled:
        raise KeyError(f"state_dict mismatch: missing "
                       f"{sorted(set(missing) - filled)}, unexpected "
                       f"{sorted(unexpected)}")
    return model.to(device)
