"""Top-k sparse Mixture-of-Experts, Mixtral / Phi-3.5-MoE (torch
counterpart of `repro.models.moe`).

Capacity-based, sort-free dispatch, step for step the reference's:

  1. router logits (in the model's dtype, then float32) -> softmax ->
     top-k experts and their gates, renormalised (clamped at 1e-9);
  2. the Switch load-balancing loss `E * sum(mean(probs) *
     mean(onehot(top-1)))`;
  3. each sequence is its own dispatch group with capacity
     C = int(max(1, capacity_factor * S * k / E)), S the length the call
     sees (a bucketed prefill's padded length); a token copy's position
     in its expert is the running count over the (S * k) copies in token
     order, and a copy past C is dropped (its slot 0, its contribution
     zeroed);
  4. scatter the copies into a (B, E * C, d) buffer, run the expert FFN
     as one batched product over the stacked (E, d, f) / (E, f, d)
     weights (activation in float32, cast back), gather each copy's
     output back and weight it by its gate.

No shape depends on the data (no `nonzero`, no boolean indexing, no
`.item()`), so a decode tick through this block is one CUDA graph.  The
expert products are plain torch matmuls, as the reference leaves them to
XLA.  The reference's sharding constraints pin layouts on a mesh; on one
rank they do nothing, and the port has none.

In train mode under an ambient mesh whose batch axes hold several ranks
(each with its slice of the global batch), the router loss is this
rank's part of the global batch's (`router_loss`): the step sums the
parts over the batch axes, as it sums the cross-entropy's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import nn as tnn
from repro_torch.distributed import collectives, context
from repro_torch.models.config import ModelConfig


class Experts(nn.Module):
    """The stacked expert weights: `wi_gate`, `wi_up` (E, d, f) and `wo`
    (E, f, d) for swiglu, `wi` and `wo` for gelu, each drawn as the
    reference's `fan_in_init` draws them (fan-in = the leading dim)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        dtype = cfg.torch_dtype

        def leaf(*shape):
            return nn.Parameter(tnn.fan_in_init_(
                torch.empty(shape, dtype=dtype), generator))

        if cfg.act == "swiglu":
            self.wi_gate = leaf(e, d, f)
            self.wi_up = leaf(e, d, f)
        else:
            self.wi = leaf(e, d, f)
        self.wo = leaf(e, f, d)


class MoE(nn.Module):
    """`router` (d -> E, no bias) and `experts`, named as the reference's
    `moe_init` tree."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.router = tnn.Dense(cfg.d_model, cfg.num_experts, use_bias=False,
                                generator=generator, dtype=cfg.torch_dtype)
        self.experts = Experts(cfg, generator=generator)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, largest
    first; at equal probability the lower expert comes first, as
    `jax.lax.top_k` orders them (`torch.topk` promises no order): the
    first k of a stable descending sort."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(moe: MoE, x: torch.Tensor):
    """Router of the block: (probs (.., E), gates (.., k) renormalised,
    expert ids (.., k)), all float32 but the ids."""
    probs = torch.softmax(moe.router(x).float(), dim=-1)
    gate_vals, expert_ids = top_k(probs, moe.cfg.top_k_experts)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_ids


def _one_hot(ids: torch.Tensor, e: int, dtype) -> torch.Tensor:
    """One-hot over the last dim by comparison (no host check of the
    ids' range)."""
    return (ids[..., None] == torch.arange(e, device=ids.device)).to(dtype)


def capacity(cfg: ModelConfig, s: int) -> int:
    """Copies an expert takes from one sequence of length `s`."""
    return int(max(1, cfg.capacity_factor * s * cfg.top_k_experts
                   / cfg.num_experts))


def dispatch(cfg: ModelConfig, expert_ids: torch.Tensor):
    """(slot (B, S*k) into the (E * C) buffer, keep (B, S*k) bool) of
    every token copy, in token-major order: its position in its expert is
    the count of earlier copies routed there; past the capacity it is
    dropped (slot 0, keep False)."""
    b, s, k = expert_ids.shape
    cap = capacity(cfg, s)
    ids = expert_ids.reshape(b, s * k)
    pos = torch.cumsum(_one_hot(ids, cfg.num_experts, torch.int32), dim=1)
    pos_in_e = torch.gather(pos, 2, ids[..., None])[..., 0] - 1
    keep = pos_in_e < cap
    return torch.where(keep, ids * cap + pos_in_e, 0), keep


def expert_ffn(experts: Experts, xb: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """xb (B, E, C, d) -> (B, E, C, d): each projection one batched
    product over the stacked weights; silu / gelu (tanh, jax's default)
    in float32, cast back."""
    def proj(h, w):
        return torch.einsum("becd,edf->becf", h, w.to(h.dtype))

    if cfg.act == "swiglu":
        g = proj(xb, experts.wi_gate)
        h = F.silu(g.float()).to(xb.dtype) * proj(xb, experts.wi_up)
    else:
        h = F.gelu(proj(xb, experts.wi).float(),
                   approximate="tanh").to(xb.dtype)
    return proj(h, experts.wo)


def router_loss(probs: torch.Tensor, top1: torch.Tensor, e: int, *,
                train: bool = False) -> torch.Tensor:
    """The Switch load-balancing loss `E * sum(me * ce)`, float32: `me`
    the mean router probability of each expert, `ce` the share of tokens
    whose first choice it is, both over (B, S) of `probs` (B, S, E) and
    `top1` (B, S).

    In train mode with several batch ranks (`context.batch_group()`) the
    means are the global batch's, as GSPMD takes the reference's: the
    top-1 counts and the token count are summed over the batch axes (no
    gradient: `ce` is a one-hot mean), and this rank's part is `E *
    sum(probs.sum((0, 1)) / N * ce)` with N the global count.  The parts
    sum to the global loss, and their gradients to its gradient.
    Elsewhere (one process, or `train=False`, where every rank holds the
    whole batch) the means are this call's own."""
    onehot = _one_hot(top1, e, torch.float32)
    group = context.batch_group() if train else None
    if group is None:
        return e * torch.sum(probs.mean(dim=(0, 1))
                             * onehot.mean(dim=(0, 1)))
    counts = torch.cat([onehot.sum(dim=(0, 1)), onehot.new_tensor(
        [top1.numel()])])
    counts = collectives.all_reduce_(counts, group)
    ce = counts[:e] / counts[e]
    return e * torch.sum(probs.sum(dim=(0, 1)) / counts[e] * ce)


def moe_apply(moe: MoE, x: torch.Tensor, *, train: bool = False):
    """x (B, S, d) -> (y (B, S, d), the router's aux loss, float32; in
    train mode on several batch ranks this rank's part of the global
    batch's, `router_loss`).

    The dispatch is a scatter-add: each buffer slot receives one token
    copy plus exact zeros (the dropped copies, all at slot 0), so any
    order of adds gives the same buffer.  The combine is not: a token's
    k gated outputs are summed in order (copy 0 first) into zeros, which
    is what the reference's scatter-add of the copies computes, and
    deterministic for any k, where an atomic scatter-add would not be."""
    cfg = moe.cfg
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k_experts
    probs, gate_vals, expert_ids = route(moe, x)

    aux = router_loss(probs, expert_ids[..., 0], e, train=train)

    slot, keep = dispatch(cfg, expert_ids)
    cap = capacity(cfg, s)
    # token copy j of the (S * k) is token j // k
    xsrc = x[:, :, None].expand(b, s, k, d).reshape(b, s * k, d)
    contrib = xsrc * keep[..., None].to(x.dtype)
    index = slot[..., None].expand(b, s * k, d)
    buf = torch.zeros((b, e * cap, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, index, contrib)
    yb = expert_ffn(moe.experts, buf.reshape(b, e, cap, d), cfg)
    gathered = torch.gather(yb.reshape(b, e * cap, d), 1, index)
    wts = (gate_vals.reshape(b, s * k) * keep).to(x.dtype)
    copies = (gathered * wts[..., None]).reshape(b, s, k, d)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + copies[:, :, i]
    return y, aux


def moe_apply_dense_reference(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """O(E)-compute oracle for tests (the reference's
    `moe_apply_dense_reference`): every expert on every token, masked by
    the gates; no capacity, so it matches `moe_apply` only where nothing
    is dropped."""
    cfg = moe.cfg
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    _, gate_vals, expert_ids = route(moe, xf)
    gates = torch.zeros((xf.shape[0], cfg.num_experts), dtype=torch.float32,
                        device=x.device)
    for i in range(cfg.top_k_experts):
        gates = gates + gate_vals[:, i:i + 1] * _one_hot(
            expert_ids[:, i], cfg.num_experts, torch.float32)
    outs = expert_ffn(moe.experts, xf.expand(cfg.num_experts, *xf.shape)
                      [None], cfg)[0]  # (E, T, d)
    y = torch.einsum("te,etd->td", gates.to(xf.dtype), outs)
    return y.reshape(b, s, d)
