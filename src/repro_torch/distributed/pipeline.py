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
results; the outputs are the same).  Forward only, as the reference
uses it: an input that requires grad raises (the backward is not
ported).  On a gloo group a CUDA activation crosses through host
memory: gloo's point-to-point sends take host tensors only.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

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
    ops, buf = [], None
    if out is not None:
        t = out.detach().contiguous()
        t = t.cpu() if host else t
        ops.append(dist.P2POp(dist.isend, t,
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        buf = torch.empty(recv_shape, dtype=dtype,
                          device="cpu" if host else device)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, recv_from), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if buf is not None and host:
        buf = buf.to(device)
    return buf


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, *,
                   mesh, axis: str = "pod", num_microbatches: int
                   ) -> torch.Tensor:
    """Run x through `mesh.size(axis)` sequential applications of
    stage_fn, stage i on the rank at coordinate i along `axis`.

    stage_fn(params_i, x) -> x (the same shape).  stacked_params: one
    entry a stage (a sequence, or a dict of tensors with a leading stage
    dim); a rank reads only its own.  x: (batch, ...), alike on every rank
    of the axis, batch % num_microbatches == 0.  Returns the output on
    every rank of the axis."""
    if x.requires_grad:
        raise ValueError("pipeline_apply is forward only (its backward is "
                         "not ported): x requires grad")
    n_stages, stage = mesh.size(axis), mesh.index(axis)
    group = mesh.group(axis)
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} does not split into "
                         f"{num_microbatches} microbatches")
    mb = b // num_microbatches
    params = _stage_params(stacked_params, stage)
    micro = x.reshape(num_microbatches, mb, *x.shape[1:])
    outputs = torch.zeros_like(micro)
    last = stage == n_stages - 1
    carry = None
    for t in range(n_stages + num_microbatches - 1):
        i = t - stage  # the microbatch this stage holds at tick t
        active = 0 <= i < num_microbatches
        out = None
        if active:
            out = stage_fn(params, micro[i] if stage == 0 else carry)
            if last:
                outputs[i] = out
        # stage s sends what it made at tick t; stage s + 1 holds it at t + 1
        prev_active = 0 <= i + 1 < num_microbatches and stage > 0
        carry = _exchange(out if active and not last else None,
                          (mb, *x.shape[1:]), x.dtype, x.device, group,
                          stage + 1, stage - 1 if prev_active else None)
    outputs = outputs if last else torch.zeros_like(outputs)
    collectives.all_reduce_(outputs, group)
    return outputs.reshape(b, *x.shape[1:])
