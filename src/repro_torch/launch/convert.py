"""Turn the reference's (params, state) pytrees into the port's modules.

The input is the JAX pytree with every leaf already a numpy array (for
example `jax.tree.map(np.asarray, params)`), so this module imports no
JAX.  Keys map one to one onto the `Transformer`'s `state_dict`: nested
dict keys join with "." and the leading layer axis of a stacked ("run", n)
segment is split into n per-layer entries.  Dense kernels keep their
(in, out) layout.  Batchnorm running stats come from `state`.
"""

from __future__ import annotations

import numpy as np
import torch

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


def model_from_jax(params, state, cfg: ModelConfig,
                   device="cuda") -> transformer.Transformer:
    """A `Transformer` holding the reference's weights (strict load), on
    `device`: the card unless the caller asks for "cpu"."""
    device = resolve_device(device)
    model = transformer.Transformer(cfg)
    model.load_state_dict(state_dict_from_jax(params, state, cfg),
                          strict=True)
    return model.to(device)
