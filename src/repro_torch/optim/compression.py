"""Gradient compression with error feedback (torch counterpart of
`repro.optim.compression`).

Two codecs for the data-parallel sum:

  * int8 — symmetric quantization with one scale a leaf (`quant.int8_qdq`,
    4x fewer bytes than fp32); the quantization residual is fed back into
    the next step's gradient (error feedback), which keeps Adam's
    convergence;
  * topk — magnitude top-k sparsification (keep fraction `rho`, k =
    max(1, int(rho * numel))), the residual fed back likewise.

The codec is applied to the gradients after their sum over the batch
axes and before Adam, as the reference's train step does; the wire form
over a mesh axis is `distributed.collectives.compressed_psum`.  A leaf
split over a group of ranks (a row-sharded table's gradient, this
rank's rows; a dense leaf's gradient summed into this rank's block,
`distributed.sharding.DenseBlocks`) is coded as its global array: the
int8 scale is the maximum over the group, and top-k's threshold is the
k-th largest magnitude of the whole leaf (each rank's own k largest,
gathered over the group, hold it), so each element is coded as the
whole leaf's code codes it.  The residual has the shapes of the
gradients it is made from (on a mesh the blocks and shards: no rank
holds a whole leaf's).  It is state of the step: it is not
checkpointed, as in the reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import quant
from repro_torch.distributed import collectives

KINDS = ("none", "int8", "topk")


def compression_init(params: dict[str, torch.Tensor], kind: str = "none",
                     rho: float = 0.01) -> dict:
    """The codec's state: {"kind", "rho", "residual": {name: fp32 zeros of
    the shape of `params[name]`}} (residual None for "none"): give it
    the gradients as the step codes them (a rank's blocks and rows)."""
    if kind not in KINDS:
        raise ValueError(f"unknown compression {kind!r}; known: {KINDS}")
    if kind == "none":
        return {"kind": kind, "residual": None}
    return {"kind": kind, "rho": rho,
            "residual": {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for k, p in params.items()}}


def _ranks(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _quant_int8(g: torch.Tensor, group) -> torch.Tensor:
    amax = collectives.all_max_(g.abs().max().reshape(1), group)[0]
    return quant.int8_qdq(g, amax)


def _topk_mask(g: torch.Tensor, rho: float, group) -> torch.Tensor:
    flat = g.abs().reshape(-1)
    k = max(1, int(rho * flat.numel() * _ranks(group)))
    mine = torch.topk(flat, min(k, flat.numel())).values
    pool = collectives.all_gather_rows(mine, group)
    thresh = torch.topk(pool, k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros((), dtype=g.dtype,
                                                         device=g.device))


def compress_gradients(grads: dict[str, torch.Tensor], comp_state: dict, *,
                       groups: dict | None = None):
    """(the gradients as sent, the new state): each gradient plus its
    residual, coded; the residual becomes what the code lost.  `groups`
    ({name: process group}) names the leaves that are this rank's part of
    a leaf split over the group's ranks; the others are whole."""
    kind = comp_state["kind"]
    if kind == "none":
        return grads, comp_state
    groups = groups or {}
    sent, resid = {}, {}
    for name, g in grads.items():
        group = groups.get(name)
        g32 = g.float() + comp_state["residual"][name]
        if kind == "int8":
            out = _quant_int8(g32, group)
        elif kind == "topk":
            out = _topk_mask(g32, comp_state["rho"], group)
        else:
            raise ValueError(kind)
        sent[name] = out.to(g.dtype)
        resid[name] = g32 - out
    return sent, dict(comp_state, residual=resid)
