"""Adam with per-group learning rates (torch counterpart of
`repro.optim.adam`), written as plain tensor ops rather than
`torch.optim.Adam` so the reference's order of operations and its stats
(`grad_norm`, `lr`) carry over.

The paper trains "normal" parameters at 1e-4 and memory-layer values at
1e-3 "to compensate for sparse access" (§3.2).  Groups are selected by
substring match on the parameter's name (the LRAM value tables are named
`...values`).  One global-norm clip, decoupled weight decay and the
reference's schedules.  Parameters and moments are updated IN PLACE (the
reference returns new trees instead); the state is
``{"mu": {name: tensor}, "nu": {name: tensor}, "step": int32 tensor}``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import collectives


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    memory_lr_mult: float = 10.0   # paper: 1e-3 for memory values
    memory_path: str = "values"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    schedule: str = "constant"     # constant | cosine | linear
    warmup_steps: int = 0
    total_steps: int = 100_000


def schedule_lr(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor), float32."""
    step = step.float()
    lr = torch.full((), cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    if cfg.schedule == "cosine":
        frac = torch.clamp(step / max(1, cfg.total_steps), 0.0, 1.0)
        lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        frac = torch.clamp(step / max(1, cfg.total_steps), 0.0, 1.0)
        lr = lr * (1.0 - frac)
    return lr


def global_norm(tensors, sharded=(), group=None, *, split=()
                ) -> torch.Tensor:
    """The l2 norm of every tensor of `tensors`, `sharded` and `split`
    together.  `sharded` are this rank's row shards of tables split over
    `group`, and `split` (tensor, group) pairs this rank's blocks of
    leaves split over their group's ranks: the squared sums are summed
    over each group (one sum a group, in the order the pairs first name
    it), so every element counts once, and each of `tensors` (alike on
    every rank) once."""
    sq = sum(torch.sum(torch.square(t.float())) for t in tensors)
    by_group: dict = {}
    for t, g in ((t, group) for t in sharded):
        by_group.setdefault(g, []).append(t)
    for t, g in split:
        by_group.setdefault(g, []).append(t)
    for g, ts in by_group.items():
        part = sum(torch.sum(torch.square(t.float())) for t in ts)
        sq = sq + collectives.all_reduce_(part, g)
    return torch.sqrt(sq)


def lr_mult(name: str, cfg: OptimConfig) -> float:
    """Per-parameter multiplier: memory value tables get memory_lr_mult."""
    return cfg.memory_lr_mult if cfg.memory_path in name else 1.0


def adam_init(params: dict[str, torch.Tensor]) -> dict:
    device = next(iter(params.values())).device if params else None
    return {
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device) for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adam_update(params: dict[str, torch.Tensor],
                grads: dict[str, torch.Tensor | None], opt_state: dict,
                cfg: OptimConfig, *, sharded=(), group=None,
                split: dict | None = None) -> dict[str, torch.Tensor]:
    """One step over `params` (name -> tensor, updated in place) with
    `grads` (name -> tensor; None counts as zero, as a leaf the loss does
    not reach has a zero gradient in the reference).  The names in
    `sharded` are row shards of tables split over `group` (the mesh's
    ``model`` axis): the clip's global norm counts their rows once across
    the group (`global_norm`).  `split` ({name: process group}) names
    the parameters that are this rank's block of a dense leaf split over
    the group's ranks (`distributed.sharding.DenseBlocks`), with their
    gradients summed into the block: the norm counts each element of the
    leaf once (the blocks' squares summed over the group).  Advances
    `opt_state` in place; returns the stats {"grad_norm", "lr"}."""
    step = opt_state["step"] + 1
    split = split or {}
    grads = {k: (g if g is not None else torch.zeros_like(params[k]))
             for k, g in grads.items()}
    gnorm = global_norm(
        [g for k, g in grads.items() if k not in sharded and k not in split],
        [grads[k] for k in sharded], group,
        split=[(grads[k], split[k]) for k in grads if k in split])
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)

    lr = schedule_lr(cfg, step)
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for name, p in params.items():
        g32 = grads[name].float()
        if scale is not None:
            g32 = g32 * scale
        m, v = opt_state["mu"][name], opt_state["nu"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        mult = lr_mult(name, cfg)
        delta = lr * mult * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + lr * mult * cfg.weight_decay * p.float()
        p.copy_((p.float() - delta).to(p.dtype))
    opt_state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
