"""Core layers: dense, embedding, norms and initializers (torch counterpart
of `repro.nn.core`).

Parameters keep the reference's layout and names, so a JAX pytree maps
onto a module's `state_dict` key for key: a dense kernel is stored
(in, out) and applied as `x @ kernel`; batchnorm keeps its running
`mean`/`var` as buffers.  Inits draw from an explicit `torch.Generator`
(the numbers differ from `jax.random`'s; tests convert weights instead).

Every leaf takes a `dtype` (float32, bfloat16 or float16), with the
reference's casts: an init draws in float32 and casts to the leaf's
dtype, a dense layer applies its leaves cast to the activation's dtype,
and the norms compute in float32 and cast back.  Batchnorm's running
stats stay float32.  Leaves are made on the ambient default device (`with
torch.device(...)`), so a model can be drawn leaf by leaf on the card.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import collectives, context

# truncation at +-2 standard deviations, as jax.random.truncated_normal(-2, 2)
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator | None) -> torch.Tensor:
    """Fill `t` with stddev * N(0, 1) truncated to [-2, 2] (inverse CDF),
    drawn in float32 and cast to `t`'s dtype."""
    if t.dtype != torch.float32:
        return t.copy_(truncated_normal_(
            torch.empty(t.shape, device=t.device), stddev, generator))
    t.uniform_(2 * _LO - 1, 2 * _HI - 1, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(stddev)
    return t


def fan_in_init_(t: torch.Tensor, generator: torch.Generator | None,
                 scale: float = 1.0) -> torch.Tensor:
    """LeCun-style: stddev = scale / sqrt(fan_in), fan_in = shape[0]."""
    return truncated_normal_(t, scale / math.sqrt(max(1, t.shape[0])),
                             generator)


class Dense(nn.Module):
    """y = x @ kernel (+ bias), kernel stored (in, out) as in the reference."""

    def __init__(self, in_dim: int, out_dim: int, *, use_bias: bool = True,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(
            fan_in_init_(torch.empty(in_dim, out_dim, dtype=dtype),
                         generator)
        )
        self.bias = (nn.Parameter(torch.zeros(out_dim, dtype=dtype))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(truncated_normal_(
            torch.empty(vocab, dim, dtype=dtype), 1.0, generator))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias)


class BatchNorm(nn.Module):
    """Feature-wise batchnorm over all leading dims, as the reference's:
    running stats move with momentum 0.99 (new = 0.99 * old + 0.01 *
    batch), the batch variance is the biased one, eps is 1e-5.  Not
    `torch.nn.BatchNorm*`, whose momentum and variance differ.

    In train mode the running `mean`/`var` buffers are updated in place
    (the reference returns them as a new state instead).  Under an ambient
    mesh with a ``data`` axis, a train-mode batch is this data rank's
    slice of the global batch, and the mean and biased variance are those
    of the global batch, as GSPMD computes the reference's: sums over the
    batch axes (``data``, or ("pod", "data")), differentiable both ways
    (`collectives.sum_both`), so the running stats stay equal on every
    rank.
    """

    def __init__(self, dim: int, *, momentum: float = 0.99,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            group = context.batch_group()
            if group is None:
                mean = x32.mean(dims)
                var = ((x32 - mean) ** 2).mean(dims)
            else:  # equal slices of the global batch on the data ranks
                count = x32.numel() // x32.shape[-1] \
                    * dist.get_world_size(group)
                mean = collectives.sum_both(x32.sum(dims), group) / count
                var = collectives.sum_both(((x32 - mean) ** 2).sum(dims),
                                           group) / count
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)
