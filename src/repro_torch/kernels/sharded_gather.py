"""Row 9's forward: the weighted gather over one rank's row-range shard.

    out[t] = sum_k ok[t,k] * w[t,k] * shard[idx[t,k] - base]
             ok = base <= idx[t,k] < base + rows               (fp32,
                                                                bf16 or
                                                                fp16 shard)
    out[t] = sum_k ok[t,k] * (w[t,k] * scale[r]) * q[r]        (int8 or
             r = idx[t,k] - base                                e4m3 shard)

The shard holds rows [base, base + rows) of the whole table; an index
outside it adds nothing.  The partial outputs of the `model` ranks sum to
the whole gather (`repro_torch.distributed.sharded_lram` joins them).
Torch counterpart of the shard-local gathers of the reference's
`repro.distributed.sharded_lram.sharded_gather_interp`.  On a CUDA tensor
`sharded_gather` and `sharded_gather_quant` launch the hand-written
kernels of `csrc/sharded_gather.cu` (design and bound noted there) or
raise; on a CPU tensor they take `sharded_gather_plain` and
`sharded_gather_quant_plain`, the reference's formulation: the gather of
the clamped local rows clip(idx - base) with the weights w * ok, equal to
the kernels for finite tables.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, gather_interp

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_QUANT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
_QUANT_SYMBOL = {torch.int8: "sharded_gather_quant_i8",
                 torch.float8_e4m3fn: "sharded_gather_quant_e4m3"}


def local_rows(idx: torch.Tensor, base: int, rows: int):
    """(clip(idx - base, 0, rows - 1), ok): each index's row in the shard
    [base, base + rows) and whether the shard holds it."""
    rel = idx.long() - base
    ok = (rel >= 0) & (rel < rows)
    return rel.clamp(0, rows - 1), ok


def sharded_gather_plain(values: torch.Tensor, idx: torch.Tensor,
                         w: torch.Tensor, base: int) -> torch.Tensor:
    """`sharded_gather` in plain torch: K1's plain version over the
    clamped rows with the masked weights."""
    rel, ok = local_rows(idx, base, values.shape[0])
    return gather_interp.gather_interp_plain(values, rel, w.float() * ok)


def sharded_gather_quant_plain(q: torch.Tensor, scale: torch.Tensor,
                               idx: torch.Tensor, w: torch.Tensor,
                               base: int) -> torch.Tensor:
    """`sharded_gather_quant` in plain torch (B4's plain version)."""
    rel, ok = local_rows(idx, base, q.shape[0])
    return gather_interp.gather_interp_quant_plain(q, scale, rel,
                                                   w.float() * ok)


def check_shard_base(table: torch.Tensor, base: int, what: str) -> int:
    """`base` as an int, or raise when the shard's rows do not fit the
    kernels' int32 indices."""
    base = int(base)
    if base < 0 or base + table.shape[0] > 2**31 - 1:
        raise ValueError(f"{what}: the shard [{base}, {base} + "
                         f"{table.shape[0]}) does not fit int32 indices")
    return base


def sharded_gather(values: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                   base: int) -> torch.Tensor:
    """The partial gather over the fp32, bf16 or fp16 shard `values`
    (rows, m), which holds the table's rows [base, base + rows) -> (..., m)
    float32.

    idx (..., k) int32, indices of the whole table; w (..., k) float32.
    A bf16 or fp16 shard launches the instance of its dtype
    (`sharded_gather_bf16`'s or `sharded_gather_f16`'s count; each row
    widened to fp32 exactly, as K1's 2-byte instances do).
    On a CUDA tensor the output carries no gradient, so it raises when
    grad mode is on and values or w require grad (the differentiable forms
    are in `repro_torch.distributed.sharded_lram`).
    """
    if not values.is_cuda:
        return sharded_gather_plain(values, idx, w, base)
    _build.refuse_grad("sharded_gather", values, w)
    if values.dtype not in gather_interp.TABLE_KINDS:
        raise TypeError(f"sharded_gather kernel takes float32, bfloat16 "
                        f"or float16 shards, got {values.dtype}")
    suffix, align = gather_interp.TABLE_KINDS[values.dtype]
    base = check_shard_base(values, base, "sharded_gather")
    idx2, w2, lead = gather_interp.flat_gather_args(values, idx, w,
                                                    "sharded_gather",
                                                    align=align)
    n, top_k, m, out = gather_interp.gather_output(values, idx2)
    if n:
        fn = _build.function("sharded_gather", f"sharded_gather_{suffix}",
                             _ARGS)
        status = fn(values.data_ptr(), idx2.data_ptr(), w2.data_ptr(),
                    out.data_ptr(), n, top_k, m, base, values.shape[0],
                    values.device.index,
                    gather_interp.current_stream(values))
        _build.check(status, "sharded_gather")
        _COUNTER.get(suffix, sharded_gather).launches += 1
    return out.reshape(*lead, m)


def sharded_gather_bf16(values: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, base: int) -> torch.Tensor:
    """`sharded_gather` over a bfloat16 shard (its launches count here)."""
    if values.dtype != torch.bfloat16:
        raise TypeError(f"sharded_gather_bf16 takes a bfloat16 shard, got "
                        f"{values.dtype}")
    return sharded_gather(values, idx, w, base)


def sharded_gather_f16(values: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor, base: int) -> torch.Tensor:
    """`sharded_gather` over a float16 shard (its launches count here)."""
    if values.dtype != torch.float16:
        raise TypeError(f"sharded_gather_f16 takes a float16 shard, got "
                        f"{values.dtype}")
    return sharded_gather(values, idx, w, base)


def sharded_gather_quant(q: torch.Tensor, scale: torch.Tensor,
                         idx: torch.Tensor, w: torch.Tensor,
                         base: int) -> torch.Tensor:
    """`sharded_gather` over a 1-byte shard: q (rows, m) int8 or
    float8_e4m3fn with scale (rows,) float32, dequantized in registers
    (the scale folded into the weight, as B4 does)."""
    if not q.is_cuda:
        return sharded_gather_quant_plain(q, scale, idx, w, base)
    _build.refuse_grad("sharded_gather_quant", scale, w)
    if q.dtype not in _QUANT_SYMBOL:
        raise TypeError(f"sharded_gather_quant kernel takes int8 or "
                        f"float8_e4m3fn payloads, got {q.dtype}")
    if scale.dtype != torch.float32 or scale.shape != q.shape[:1] \
            or not scale.is_contiguous() or scale.device != q.device:
        raise ValueError("scale must be a contiguous float32 (rows,) tensor "
                         "on the payload's device")
    base = check_shard_base(q, base, "sharded_gather_quant")
    idx2, w2, lead = gather_interp.flat_gather_args(q, idx, w,
                                                    "sharded_gather_quant")
    n, top_k, m, out = gather_interp.gather_output(q, idx2)
    if n:
        fn = _build.function("sharded_gather", _QUANT_SYMBOL[q.dtype],
                             _QUANT_ARGS)
        status = fn(q.data_ptr(), scale.data_ptr(), idx2.data_ptr(),
                    w2.data_ptr(), out.data_ptr(), n, top_k, m, base,
                    q.shape[0], q.device.index,
                    gather_interp.current_stream(q))
        _build.check(status, "sharded_gather_quant")
        sharded_gather_quant.launches += 1
    return out.reshape(*lead, m)


#: kernel launches since the last reset (a run shows the path used them)
sharded_gather.launches = 0
sharded_gather_bf16.launches = 0
sharded_gather_f16.launches = 0
_COUNTER = {"bf16": sharded_gather_bf16, "f16": sharded_gather_f16}
sharded_gather_quant.launches = 0
