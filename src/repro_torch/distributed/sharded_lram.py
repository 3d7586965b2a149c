"""Model-parallel LRAM lookups: the `sharded` placement of the lookup-plan
registry (torch counterpart of the `sharded` half of
`repro.distributed.sharded_lram`).

The value table's rows are split over the ``model`` axis of the ambient
mesh: the rank at coordinate i holds rows [i * R, (i + 1) * R), R = N / S.
Instead of reading rows across ranks, every rank of a model group

  1. holds the same queries (the activations are the same on the ranks of
     a model group; they differ only across the ``data`` axis),
  2. gathers only the indices that fall in its rows (the others add
     nothing: the range gather, `repro_torch.kernels.sharded_gather`),
  3. joins the partial outputs with one all-reduce over ``model``.

The traffic is O(tokens * heads * m), independent of N; no table row
crosses ranks.  The backward (the range backward, `ops.lookup_bwd_range`)
scatters into the rank's own rows, and the query's partial gradient (dq,
or dw in the plain cell) is summed over ``model``: the conjugate of the
forward's all-reduce, since everything downstream of the memory layer is
computed alike on the ranks of a model group (`collectives`).

Cells: ``pallas`` (the CUDA kernels; their plain versions on CPU tensors)
looks up through one autograd Function, K2 then the range gather then the
all-reduce, with the range backward and the dq all-reduce behind it (its
interp hook alone is forward only on the card); ``reference`` is plain
autograd over the reference's formulation, for CPU tables only.  fp32 tables train by autodiff (each rank steps its own
rows); int8 / fp8 tables (`QuantizedTable` shards) are frozen.  The plan
builds the whole table from the init-time draw, as every plan does;
`repro_torch.distributed.sharding.shard_params` then keeps the rank's
rows.  Growth is not ported (ROADMAP A10) and would need a relaunch here,
as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import lookup
from repro_torch.distributed import collectives
from repro_torch.kernels import e8_lookup, ops, sharded_gather
from repro_torch.quant import QuantizedTable

AXIS = "model"


def _partial(table, scale, idx, w, base):
    if scale is None:
        return sharded_gather.sharded_gather(table, idx, w, base)
    return sharded_gather.sharded_gather_quant(table, scale, idx, w, base)


class _ShardedLookup(torch.autograd.Function):
    """K2 on the rank's queries, the range gather, the sum over the model
    group (idx and w returned, not differentiable); backward: the range
    backward with dq (the shard's dvalues for an fp32 table, the partial
    dq), then the sum of dq over the group."""

    @staticmethod
    def forward(ctx, table, q, scale, spec, top_k, base, group):
        idx, w = e8_lookup.lram_query(q, spec, top_k)
        out = collectives.all_reduce_(_partial(table, scale, idx, w, base),
                                      group)
        ctx.save_for_backward(table, q, scale, idx, w)
        ctx.spec, ctx.base, ctx.group = spec, base, group
        ctx.mark_non_differentiable(idx, w)
        return out, idx, w

    @staticmethod
    def backward(ctx, g, _g_idx, _g_w):
        table, q, scale, idx, w = ctx.saved_tensors
        dvalues, dq = ops.lookup_bwd_range(table, idx, w,
                                           g.float().contiguous(), ctx.base,
                                           scale=scale, q=q, spec=ctx.spec)
        collectives.all_reduce_(dq, ctx.group)
        return (dvalues if ctx.needs_input_grad[0] else None,
                dq.to(q.dtype), None, None, None, None, None)


def sharded_gather_interp(mesh, *, axis: str = AXIS,
                          kernel: str = "pallas"):
    """The interp hook (values, idx, w) -> out of the sharded cells.

    `values` is this rank's shard: an fp32 tensor (R, m) or a
    `QuantizedTable` of R rows, the rows [i * R, (i + 1) * R) of the table
    with i the rank's coordinate along `axis`; idx (..., k) int32 indices
    of the whole table and w (..., k), alike on the ranks of `axis`.  The
    output is the whole gather on every rank.  On CPU tables both cells
    run the range gather's plain version, differentiable in w and in an
    fp32 shard.  On the card the ``pallas`` cell launches the range
    gather, forward only (it raises under grad, as every forward kernel
    does: training goes through the plan's `lookup`), and the
    ``reference`` cell refuses.
    """
    if kernel not in ("reference", "pallas"):
        raise ValueError(f"unknown kernel {kernel!r}")
    group, index = mesh.group(axis), mesh.index(axis)

    def interp(values, idx, w):
        quantized = isinstance(values, QuantizedTable)
        table = values.q if quantized else values
        scale = values.scale if quantized else None
        base = index * table.shape[0]
        if kernel == "reference" and table.is_cuda:
            raise lookup.LookupPlanError(
                "sharded", "?", kernel, "the plain reference path is for "
                "CPU tables; on the card use the pallas cell")
        w = collectives.copy_to(w, group)
        return collectives.reduce_from(_partial(table, scale, idx, w, base),
                                       group)

    return interp


def sharded_plan(cfg, storage: str, kernel: str, mesh) -> lookup.LookupPlan:
    """The `sharded` cell of (storage, kernel) on `mesh` (the reference's
    `_sharded_factory`): raises without an ambient mesh that has a
    ``model`` axis."""
    cell = ("sharded", storage, kernel)
    if mesh is None or AXIS not in mesh.axis_names:
        raise lookup.LookupPlanError(
            *cell, f"needs an ambient mesh with a {AXIS!r} axis: call "
            f"repro_torch.distributed.set_mesh(mesh) (under torchrun: "
            f"repro_torch.launch.mesh.init_mesh) before resolving")
    n_shards = mesh.size(AXIS)
    if cfg.num_locations % n_shards:
        raise lookup.LookupPlanError(
            *cell, f"num_locations={cfg.num_locations} not divisible by the "
            f"{AXIS!r} axis size {n_shards}")
    rows = cfg.num_locations // n_shards
    base, group = mesh.index(AXIS) * rows, mesh.group(AXIS)
    hook = sharded_gather_interp(mesh, axis=AXIS, kernel=kernel)
    quantized = storage != "fp32"

    def check_shard(values):
        if quantized != isinstance(values, QuantizedTable) or not (
                quantized or isinstance(values, torch.Tensor)):
            raise lookup.LookupPlanError(
                *cell, f"expected {'a QuantizedTable' if quantized else 'an '
                'fp32 tensor'} shard, got {type(values).__name__}")
        have = values.num_rows if quantized else values.shape[0]
        if have != rows:
            raise lookup.LookupPlanError(
                *cell, f"the table has {have} rows; this rank's shard of "
                f"the {n_shards}-way {AXIS!r} axis has {rows}: keep the "
                f"rank's rows with repro_torch.distributed.sharding."
                f"shard_params")

    def interp(values, idx, w):
        check_shard(values)
        return hook(values, idx, w)

    lookup_fn = None
    if kernel == "pallas":
        def lookup_fn(values, q, spec, top_k):
            check_shard(values)
            table, scale = ((values.q, values.scale) if quantized
                            else (values, None))
            return _ShardedLookup.apply(table, q, scale, spec, top_k, base,
                                        group)

    common = dict(query=lookup.query_fn(kernel), interp=interp,
                  lookup=lookup_fn, requires_mesh=True,
                  table_rows_axis=AXIS)
    if not quantized:
        return lookup.LookupPlan(
            *cell, build_table=lambda dense: nn.Parameter(dense), **common)
    return lookup.LookupPlan(
        *cell,
        build_table=lambda dense: QuantizedTable.from_dense(
            dense.detach().cpu().numpy(), storage),
        table_from_payload=lambda q, scale: QuantizedTable.from_payload(
            q, scale, storage),
        table_update="frozen", **common)
