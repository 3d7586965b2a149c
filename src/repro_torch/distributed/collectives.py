"""Sums across the ranks of a process group, plain, differentiable and
compressed, and the gathers of a batch's rows and of a leaf's blocks.

`all_reduce_` and `reduce_scatter_` are the places the port sums tensors
across ranks, and `all_gather_blocks` the one place it gathers them
(`all_gather_rows` concatenates its parts).  On a gloo group they take CUDA tensors too:
gloo stages them through host memory, which is how the one-card mesh
(several ranks on one H100) runs; NCCL moves them on the cards.
`compressed_psum` is the reference's wire form of the int8 gradient
codec: a common scale (one max over the group), an int32 sum of the int8
payloads, the sum dequantized.

The differentiable forms are Megatron's conjugate pair and their product,
for values that every rank of the group computes alike downstream:

  * `reduce_from(x)`: the sum over the group forward, the identity
    backward (the partial outputs of the row-sharded gather: each rank's
    partial gets the whole upstream gradient);
  * `copy_to(x)`: the identity forward, the sum backward (an input every
    rank holds alike whose gradient each rank has in part: the query's
    weights in the plain sharded cell);
  * `sum_both(x)`: the sum forward and backward (the batch statistics of a
    data-parallel batchnorm: every rank's loss is its part of the global
    loss, so the statistics' gradient is the sum of the parts).

A group of None or of one rank makes each of them the identity.

Every collective a step issues goes through this module, the pipeline's
paired sends and receives too (`exchange`), so it is also where they are
recorded: under `recording()` each one that moves bytes appends (op,
bytes, group size, site) to the list it yields, in the names and byte
convention of the reference's HLO collectives (`repro_torch.analysis.
collectives` applies their ring factors).  The bytes are the op's result
on this rank: the whole gathered tensor of an all-gather, this rank's
chunk of a reduce-scatter, the tensor of an all-reduce, the tensor sent
by a collective-permute.  `site(name)` labels the records made in its
body (the dense blocks' gathers and sums, `distributed.sharding`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_RECORDS: list | None = None   # the list `recording()` yields, when armed
_SITE: list = [None]


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def _record(op: str, nbytes: int, group) -> None:
    if _RECORDS is not None:
        _RECORDS.append((op, int(nbytes), dist.get_world_size(group),
                         _SITE[-1]))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def recording():
    """Yield a list that every collective issued in the body appends to:
    (op, bytes, group size, site), op one of the reference's HLO names
    ("all-reduce", "all-gather", "reduce-scatter", "collective-permute").
    A collective over a group of None or of one rank issues nothing and
    records nothing.  One recording at a time."""
    global _RECORDS
    _RECORDS = records = []
    try:
        yield records
    finally:
        _RECORDS = None


@contextlib.contextmanager
def site(name: str):
    """Label the records of the collectives issued in the body."""
    _SITE.append(name)
    try:
        yield
    finally:
        _SITE.pop()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the ranks of `group`, in place; returns it."""
    if not _trivial(group):
        _record("all-reduce", _nbytes(t), group)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def reduce_scatter_(out: torch.Tensor, chunks: list[torch.Tensor],
                    group) -> torch.Tensor:
    """Sum chunk j of every rank of `group` into `out` on the group's
    member j (every chunk `out`'s shape); returns `out` (chunks[0]'s sum
    for a group of None or of one rank)."""
    if _trivial(group):
        return out.copy_(chunks[0])
    _record("reduce-scatter", _nbytes(out), group)
    dist.reduce_scatter(out, [c.contiguous() for c in chunks], group=group)
    return out


def all_gather_blocks(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's `t` (alike in shape), in the group's rank order; [t]
    for a group of None or of one rank."""
    if _trivial(group):
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _record("all-gather", len(parts) * _nbytes(t), group)
    dist.all_gather(parts, t, group=group)
    return parts


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` (alike in shape) concatenated along dim 0 in the
    group's rank order: the global batch, for tensors of each data rank's
    slice (`sharding.batch_slice` takes contiguous rows).  `t` itself for a
    group of None or of one rank."""
    if _trivial(group):
        return t
    return torch.cat(all_gather_blocks(t, group))


def all_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of `t` over `group`, in place; returns it."""
    if not _trivial(group):
        _record("all-reduce", _nbytes(t), group)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """Common-scale int8 all-reduce over `group` (the reference's
    `compressed_psum`): every rank quantizes against the largest scale of
    the group, the int8 payloads are summed in int32 (worst case 127 x
    ranks, far below 2^31) and the sum is dequantized, float32.  Its
    error is at most scale / 2 x ranks; pair it with error feedback
    upstream (`repro_torch.optim.compression`)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    scale = all_max_(scale.float().reshape(1), group)[0]
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = all_reduce_(q.to(torch.int32), group)
    return total.float() * scale


def exchange(send: torch.Tensor | None, send_to: int | None,
             recv: torch.Tensor | None, recv_from: int | None,
             group) -> None:
    """Send `send` to group rank `send_to` and receive into `recv` from
    group rank `recv_from` (either None: that half is not posted), both
    posted before either is waited on: a collective-permute of the
    tensor that moves."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, send_to), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, recv_from), group))
    if not ops:
        return
    _record("collective-permute",
            _nbytes(send if send is not None else recv), group)
    for work in dist.batch_isend_irecv(ops):
        work.wait()


#: bytes of one flat buffer of `all_reduce_flat_`
FLAT_BUCKET_BYTES = 256 * 2**20


_TWO_BYTE = (torch.bfloat16, torch.float16)


def sum_dtype(dtype: torch.dtype, group) -> torch.dtype:
    """The dtype a sum of `dtype` tensors over `group` runs in: float32
    for a 2-byte dtype over more than two ranks (the exact sum rounded
    once, see `all_reduce_flat_`), else `dtype` itself."""
    if dtype in _TWO_BYTE and not _trivial(group) \
            and dist.get_world_size(group) > 2:
        return torch.float32
    return dtype


def all_reduce_flat_(tensors: list[torch.Tensor], group) -> None:
    """Sum every tensor of `tensors` (contiguous, one device) over
    `group`, in place: the tensors of each dtype in order, in flat
    buffers of at most FLAT_BUCKET_BYTES (one all-reduce each); a tensor
    as large alone is summed where it lies.

    A dtype apiece, not one buffer: a bfloat16 model's gradients mix
    bfloat16 leaves with float32 ones (a dense memory table, an SSM's
    `A_log` / `D` / `dt_bias`), and `torch.cat` would promote them all
    to float32, a transient float32 copy of every gradient.  Bounded
    buckets: a flat copy of every gradient would hold a second copy of
    the whole gradients (3.5 GB of a 1.76 B parameter bf16 model) on
    every rank.

    A bfloat16 or float16 sum is the exact sum rounded once, as XLA's
    partitioner sums a 2-byte reduction over devices (in float32, then
    rounded): over two ranks the 2-byte all-reduce is that already (a + b
    rounded once) and moves half the bytes; over more, a bucket is summed
    in float32 and cast back once, since the wire would round once a
    rank added."""
    if _trivial(group) or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, same in by_dtype.items():
        acc = sum_dtype(dtype, group)
        bucket: list[torch.Tensor] = []
        size = 0
        for t in same:
            nbytes = t.numel() * t.element_size()
            if nbytes >= FLAT_BUCKET_BYTES:
                _reduce_bucket([t], group, acc)
                continue
            if size + nbytes > FLAT_BUCKET_BYTES:
                _reduce_bucket(bucket, group, acc)
                bucket, size = [], 0
            bucket.append(t)
            size += nbytes
        _reduce_bucket(bucket, group, acc)


def _reduce_bucket(bucket: list[torch.Tensor], group,
                   acc: torch.dtype) -> None:
    if not bucket:
        return
    if len(bucket) == 1 and bucket[0].dtype == acc:
        all_reduce_(bucket[0], group)
        return
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in bucket]).to(acc),
                       group)
    for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
        t.copy_(part.view_as(t))


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _CopyTo.apply(x, group)


def sum_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if _trivial(group) else _SumBoth.apply(x, group)
