"""Dense feed-forward blocks: SwiGLU and GELU (torch counterpart of
`repro.models.mlp`).  Leaves and activations in the model's dtype; the
activation function runs in float32 and casts back, as the reference's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import nn as tnn
from repro_torch.models.config import ModelConfig


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, d_ff: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.act = cfg.act
        kw = {"use_bias": cfg.mlp_bias, "generator": generator,
              "dtype": cfg.torch_dtype}
        if cfg.act == "swiglu":
            self.wi_gate = tnn.Dense(d, f, **kw)
            self.wi_up = tnn.Dense(d, f, **kw)
        else:
            self.wi = tnn.Dense(d, f, **kw)
        self.wo = tnn.Dense(f, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "swiglu":
            g = self.wi_gate(x)
            h = F.silu(g.float()).to(x.dtype) * self.wi_up(x)
        else:
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(self.wi(x).float(), approximate="tanh").to(x.dtype)
        return self.wo(h)
