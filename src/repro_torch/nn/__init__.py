"""Functional-style layers of the port (torch counterpart of `repro.nn`)."""

from repro_torch.nn.core import (  # noqa: F401
    BatchNorm,
    Dense,
    Embedding,
    LayerNorm,
    RMSNorm,
    fan_in_init_,
    layernorm,
    rmsnorm,
    truncated_normal_,
)
