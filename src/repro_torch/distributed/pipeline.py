"""GPipe-style pipeline parallelism over a mesh axis (torch counterpart of
`repro.distributed.pipeline`).

Each rank along the `axis` (``pod`` by default) owns one stage's
parameters.  Microbatches march through the stages: at every tick each
stage that holds a microbatch applies itself to it and sends the result
to the next stage (a send and a receive issued together, so no ring
waits on itself).  With M microbatches and S stages the schedule runs
S + M - 1 ticks (the GPipe bubble (S - 1) / (S + M - 1)).  The last
stage's outputs are summed back to every stage, so every rank returns
the whole output, as the reference's replicated `out_specs` does.

A stage computes only on the ticks it holds a microbatch (the
reference's stages compute on every tick and discard the idle ones'
results; the outputs are the same).  In grad mode the pipeline is
differentiable (the reference's GPipe is, under `jax.grad`): each stage
keeps the graph of every microbatch it ran, and the backward runs the
ticks in reverse, each stage backpropagating its microbatches with d out
from stage s + 1 and sending d in to stage s - 1 through the same paired
sends and receives.  On a gloo group a CUDA activation or cotangent
crosses through host memory: gloo's point-to-point sends take host
tensors only.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import collectives


def _stage_params(stacked, stage: int):
    """One stage's parameters: `stacked[stage]` of a sequence, or the
    stage's slice of every tensor of a dict (a leading stage dim)."""
    if isinstance(stacked, dict):
        return {k: _stage_params(v, stage) for k, v in stacked.items()}
    return stacked[stage]


def _exchange(out, recv_shape, dtype, device, group, send_to, recv_from):
    """Send `out` (or nothing) to group rank `send_to` and receive a
    tensor from `recv_from` (or nothing), both posted before either is
    waited on; returns what was received (None if nothing)."""
    host = dist.get_backend(group) == "gloo" and device.type != "cpu"
    t = buf = None
    if out is not None:
        t = out.detach().contiguous()
        t = t.cpu() if host else t
    if recv_from is not None:
        buf = torch.empty(recv_shape, dtype=dtype,
                          device="cpu" if host else device)
    collectives.exchange(t, send_to, buf, recv_from, group)
    if buf is not None and host:
        buf = buf.to(device)
    return buf


def _leaves(params) -> list[torch.Tensor]:
    """The tensors of one stage's parameters (a tensor, a module's
    parameters, or those of a dict or sequence of them), in order."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in _leaves(p)]
    return []


class _Schedule:
    """One call's stage, group and microbatches."""

    def __init__(self, stage_fn, params, x, mesh, axis, num_microbatches):
        self.stage_fn, self.params = stage_fn, params
        self.n_stages, self.stage = mesh.size(axis), mesh.index(axis)
        self.group = mesh.group(axis)
        self.m = num_microbatches
        self.mb_shape = (x.shape[0] // num_microbatches, *x.shape[1:])
        self.last = self.stage == self.n_stages - 1

    def ticks(self) -> int:
        return self.n_stages + self.m - 1

    def exchange(self, out, like, send_to, recv_from):
        return _exchange(out, self.mb_shape, like.dtype, like.device,
                         self.group, send_to, recv_from)


def _forward(sched: _Schedule, x: torch.Tensor, keep: bool):
    """The forward ticks: (the output, alike on every rank of the axis;
    with `keep`, each microbatch this stage ran: (its input, requiring
    grad, and its output, with their graph))."""
    micro = x.detach().reshape(sched.m, *sched.mb_shape)
    outputs = torch.zeros_like(micro)
    kept = {}
    carry = None
    for t in range(sched.ticks()):
        i = t - sched.stage  # the microbatch this stage holds at tick t
        active = 0 <= i < sched.m
        out = None
        if active:
            h = micro[i] if sched.stage == 0 else carry
            if keep:
                h = h.detach().requires_grad_()
                with torch.enable_grad():
                    out = sched.stage_fn(sched.params, h)
                kept[i] = (h, out)
            else:
                out = sched.stage_fn(sched.params, h)
            if sched.last:
                outputs[i] = out.detach()
        # stage s sends what it made at tick t; stage s + 1 holds it at t + 1
        prev_active = 0 <= i + 1 < sched.m and sched.stage > 0
        carry = sched.exchange(out if active and not sched.last else None,
                               x, sched.stage + 1,
                               sched.stage - 1 if prev_active else None)
    outputs = outputs if sched.last else torch.zeros_like(outputs)
    collectives.all_reduce_(outputs, sched.group)
    return outputs.reshape(x.shape), kept


class _Pipeline(torch.autograd.Function):
    """x and this stage's parameter leaves -> the pipeline's output;
    backward: the ticks in reverse (`_backward`)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, *leaves):
        out, kept = _forward(sched, x, keep=True)
        ctx.sched, ctx.kept, ctx.leaves = sched, kept, leaves
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, d_out):
        dx, dleaves = _backward(ctx.sched, ctx.kept, ctx.leaves, d_out,
                                ctx.x_meta)
        del ctx.kept
        return (None, dx, *dleaves)


def _backward(sched: _Schedule, kept: dict, leaves, d_out, x_meta):
    """The S + M - 1 ticks in reverse: at backward tick u stage s holds
    microbatch u - (S - 1 - s), backpropagates it through the graph it
    kept (d out from this rank's own cotangent on the last stage, taken
    once: every rank's output is the same sum; from stage s + 1
    elsewhere) and sends d in to stage s - 1.  Returns (d x, stage 0's
    shared with every rank of the axis; this stage's leaves' gradients)."""
    shape, dtype, device = x_meta
    d_micro = d_out.reshape(sched.m, *sched.mb_shape)
    dx = torch.zeros((sched.m, *sched.mb_shape), dtype=dtype, device=device)
    grads = [torch.zeros_like(t) if t.requires_grad else None
             for t in leaves]
    wanted = [t for t in leaves if t.requires_grad]
    lag = sched.n_stages - 1 - sched.stage
    carry = None
    for u in range(sched.ticks()):
        i = u - lag
        active = 0 <= i < sched.m
        d_in = None
        if active:
            h, out = kept[i]
            g = d_micro[i] if sched.last else carry
            got = torch.autograd.grad(out, [h, *wanted], g.to(out.dtype),
                                      allow_unused=True)
            d_in = got[0]
            it = iter(got[1:])
            for j, t in enumerate(leaves):
                if t.requires_grad:
                    dg = next(it)
                    if dg is not None:
                        grads[j] += dg
            del kept[i]
            if sched.stage == 0:
                dx[i] = d_in
        # stage s sends d in at tick u; stage s - 1 holds it at u + 1
        next_active = 0 <= i + 1 < sched.m and not sched.last
        carry = sched.exchange(d_in if active and sched.stage > 0 else None,
                               dx, sched.stage - 1,
                               sched.stage + 1 if next_active else None)
    if sched.stage != 0:
        dx.zero_()
    collectives.all_reduce_(dx, sched.group)
    return dx.reshape(shape), grads


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, *,
                   mesh, axis: str = "pod", num_microbatches: int
                   ) -> torch.Tensor:
    """Run x through `mesh.size(axis)` sequential applications of
    stage_fn, stage i on the rank at coordinate i along `axis`.

    stage_fn(params_i, x) -> x (the same shape).  stacked_params: one
    entry a stage (a sequence, or a dict of tensors with a leading stage
    dim); a rank reads only its own.  x: (batch, ...), alike on every rank
    of the axis, batch % num_microbatches == 0.  Returns the output on
    every rank of the axis.

    Differentiable in grad mode with respect to x and this rank's stage
    parameters (a tensor, a module's parameters, or the tensors of a
    dict or sequence of them): the backward runs the ticks in reverse
    (`_backward`).  x's gradient is whole on every rank of the axis (the
    reference's replicated x); a stage's parameters get their gradient on
    their own rank only (the reference's stacked parameters split over
    the axis), each through the one cotangent of the last stage's
    output."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} does not split into "
                         f"{num_microbatches} microbatches")
    params = _stage_params(stacked_params, mesh.index(axis))
    sched = _Schedule(stage_fn, params, x, mesh, axis, num_microbatches)
    leaves = _leaves(params)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in leaves)):
        return _Pipeline.apply(sched, x, *leaves)
    with torch.no_grad():
        return _forward(sched, x, keep=False)[0]
