"""Product-Key Memory (Lample et al. 2019), the paper's main baseline
(torch counterpart of `repro.core.pkm`).

O(sqrt(N)) lookup: keys form a Cartesian product of two codebooks of
sqrt(N) half-keys; per head, score both halves, take the top-k of each,
combine the k*k Cartesian candidates and take the top-k again; softmax the
scores and sum the weighted value rows over heads and k.  Configured as in
the paper's comparison: 8 heads, N = 2**16, value dim 512, key dim 64,
batchnorm on queries.

The reference computes it in plain JAX (einsum, `lax.top_k`, `take`) with
no Pallas kernel, so the port is plain torch too:
  * every top-k is a stable descending sort cut at k, so equal scores keep
    the lower index first, as `lax.top_k` does (`torch.topk` promises no
    order among ties);
  * the rows are never materialised: `F.embedding_bag` with the softmax
    weights as per-sample weights sums them over heads and k, the
    reference's einsum "...hk,...hkm->...m" (at full width its (B, S, 8,
    32, 512) rows would be a 1 GiB tensor, and its gradient another).  It
    runs on the table widened to float32, so a bfloat16 or float16 layer
    (the model's dtype: every leaf is, as the reference builds them) sums
    in float32 as the reference does, and only the table is widened.  Its
    gradient is summed in float32 and rounded once to the table's dtype;
    the reference rounds each row's cotangent and scatter-adds in the
    table's dtype, which differs within 2 (d_max + 1) u of the summed
    magnitudes, d_max the most contributions a row takes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import nn as tnn


@dataclasses.dataclass(frozen=True)
class PKMConfig:
    n_keys: int = 256          # memory locations = n_keys**2 (2**16)
    heads: int = 8
    key_dim: int = 64          # per head: two halves of key_dim / 2
    value_dim: int = 512
    top_k: int = 32
    query_norm: str = "batch"
    value_init_scale: float = 0.02

    @property
    def num_locations(self) -> int:
        return self.n_keys**2

    @property
    def half_dim(self) -> int:
        return self.key_dim // 2

    @property
    def num_params(self) -> int:
        return (
            self.num_locations * self.value_dim
            + 2 * self.heads * self.n_keys * self.half_dim
        )


class PKM(nn.Module):
    """The layer's weights, named as the reference's pytree: the query
    projection `query`, the half-key codebooks `subkeys1` / `subkeys2`
    (heads, n_keys, half_dim), the table `values` (n_keys**2, value_dim)
    and, with batchnorm queries, `qnorm` (running stats as buffers), all
    in `dtype` (the model's; the running stats stay float32).
    `pkm_apply` runs it."""

    def __init__(self, in_dim: int, cfg: PKMConfig, *,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.heads, cfg.n_keys, cfg.half_dim)
        self.query = tnn.Dense(in_dim, cfg.heads * cfg.key_dim,
                               generator=generator, dtype=dtype)
        self.subkeys1 = nn.Parameter(
            tnn.fan_in_init_(torch.empty(shape, dtype=dtype), generator))
        self.subkeys2 = nn.Parameter(
            tnn.fan_in_init_(torch.empty(shape, dtype=dtype), generator))
        self.values = nn.Parameter(tnn.truncated_normal_(
            torch.empty(cfg.num_locations, cfg.value_dim, dtype=dtype),
            cfg.value_init_scale, generator))
        self.qnorm = (tnn.BatchNorm(cfg.heads * cfg.key_dim, dtype=dtype)
                      if cfg.query_norm == "batch" else None)


def pkm_init(in_dim: int, cfg: PKMConfig, *,
             generator: torch.Generator | None = None,
             dtype: torch.dtype = torch.float32) -> PKM:
    return PKM(in_dim, cfg, generator=generator, dtype=dtype)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, in
    descending order, equal values lower index first (`lax.top_k`'s
    order)."""
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def pkm_apply(layer: PKM, x: torch.Tensor, *,
              train: bool = False) -> torch.Tensor:
    """x (..., in_dim) -> (..., value_dim).  In train mode the batchnorm
    runs on batch statistics and its running stats update in place."""
    cfg = layer.cfg
    lead = x.shape[:-1]
    q = layer.query(x)  # (..., heads * key_dim)
    if layer.qnorm is not None:
        q = layer.qnorm(q, train=train)
    q = q.reshape(*lead, cfg.heads, 2, cfg.half_dim).float()
    q1, q2 = q[..., 0, :], q[..., 1, :]  # (..., heads, half_dim)

    s1 = torch.einsum("...hd,hnd->...hn", q1, layer.subkeys1.float())
    s2 = torch.einsum("...hd,hnd->...hn", q2, layer.subkeys2.float())
    t1, i1 = _top_k(s1, cfg.top_k)  # (..., heads, k)
    t2, i2 = _top_k(s2, cfg.top_k)
    # Cartesian combination: scores (..., heads, k, k)
    comb = t1[..., :, None] + t2[..., None, :]
    flat = comb.reshape(*comb.shape[:-2], cfg.top_k * cfg.top_k)
    scores, sel = _top_k(flat, cfg.top_k)  # (..., heads, k)
    r1 = torch.gather(i1, -1, sel // cfg.top_k)
    r2 = torch.gather(i2, -1, sel % cfg.top_k)
    idx = r1 * cfg.n_keys + r2  # (..., heads, k) flat memory indices
    w = torch.softmax(scores, dim=-1)
    bag = cfg.heads * cfg.top_k
    out = F.embedding_bag(idx.reshape(-1, bag), layer.values.float(),
                          per_sample_weights=w.reshape(-1, bag),
                          mode="sum")  # sums over heads too
    return out.reshape(*lead, cfg.value_dim).to(x.dtype)


def flop_count(in_dim: int, tokens: int, cfg: PKMConfig) -> int:
    """Paper Table 3: 2*w*sqrt(N) + w^2 + O(w) per token."""
    per_tok = (
        2 * in_dim * cfg.heads * cfg.key_dim  # query proj
        + 2 * cfg.heads * 2 * cfg.n_keys * cfg.half_dim  # half scores
        + cfg.heads * cfg.top_k * cfg.value_dim * 2  # gather+reduce
    )
    return tokens * per_tok
