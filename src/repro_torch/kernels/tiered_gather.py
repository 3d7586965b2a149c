"""B5 and B6: the weighted gather from the tiered store's device cache,
through the shard -> slot indirection

    r = slot_table[gid >> log2(shard_rows)] * shard_rows
        + (gid & (shard_rows - 1))
    B5:  out[t] = sum_k w[t,k] * cache[r]                  (fp32 cache)
    B6:  out[t] = sum_k (w[t,k] * scale[r]) * cache[r]     (int8 / e4m3
         cache, per-row fp32 scales through the same r)

Torch counterpart of `repro.kernels.tiered_gather` (`tiered_gather_pallas`,
`tiered_gather_quant_pallas`).  On a CUDA tensor `tiered_gather` and
`tiered_gather_quant` launch the hand-written kernels in
`csrc/tiered_gather.cu` (design and bound noted there; the body is K1's
and B4's, `csrc/gather_batched.cuh`) or raise; on a CPU tensor they take
`tiered_gather_plain` / `tiered_gather_quant_plain`.  The kernels keep a
cache row in an int32, so they refuse a cache of 2^31 rows or more.

Every index must lie in a resident shard.  The tiered store knows this
from its residency map before it calls and passes the verdict as
`resident`; the wrappers refuse a call without it (rows of absent shards
go through `gather_interp` instead).  Checking the indices again here would
cost a pass over them on the host per call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import quant
from repro_torch.kernels import _build
from repro_torch.kernels.gather_interp import current_stream, \
    flat_gather_args, gather_output

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_QUANT_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_QUANT_SYMBOL = {torch.int8: "tiered_gather_quant_i8",
                 torch.float8_e4m3fn: "tiered_gather_quant_e4m3"}


def _log2(shard_rows: int) -> int:
    if shard_rows < 1 or shard_rows & (shard_rows - 1):
        raise ValueError("shard_rows must be a power of two")
    return shard_rows.bit_length() - 1


def cache_rows(idx: torch.Tensor, slot_table: torch.Tensor,
               shard_rows: int) -> torch.Tensor:
    """The cache row of each global row id (int64), through the slot table."""
    log2r = _log2(shard_rows)
    i = idx.long()
    slot = slot_table.long()[i >> log2r]
    return slot * shard_rows + (i & (shard_rows - 1))


def tiered_gather_plain(cache_flat: torch.Tensor, idx: torch.Tensor,
                        slot_table: torch.Tensor, w: torch.Tensor, *,
                        shard_rows: int) -> torch.Tensor:
    """sum_k w[..., k] * cache_flat[indirect(idx[..., k])] -> (..., m)."""
    rows = cache_flat[cache_rows(idx, slot_table, shard_rows)].float()
    return torch.einsum("...k,...km->...m", w.float(), rows)


def tiered_gather_quant_plain(cache_flat: torch.Tensor,
                              scale_flat: torch.Tensor, idx: torch.Tensor,
                              slot_table: torch.Tensor, w: torch.Tensor, *,
                              shard_rows: int) -> torch.Tensor:
    """sum_k (w[..., k] * scale[r]) * cache_flat[r] -> (..., m),
    r = indirect(idx[..., k])."""
    r = cache_rows(idx, slot_table, shard_rows)
    ws = w.float() * scale_flat[r].float()
    return torch.einsum("...k,...km->...m", ws,
                        quant.take_rows(cache_flat, r))


def _check_resident(resident: bool) -> None:
    if not resident:
        raise ValueError("tiered gather: a touched shard is not resident; "
                         "the store serves such rows through gather_interp")


def _check_slot_table(cache_flat: torch.Tensor,
                      slot_table: torch.Tensor) -> None:
    if slot_table.dtype != torch.int32 or slot_table.ndim != 1 \
            or not slot_table.is_contiguous() \
            or slot_table.device != cache_flat.device:
        raise ValueError("slot_table must be a contiguous int32 (shards,) "
                         "tensor on the cache's device")


def _check_cache_rows(cache_flat: torch.Tensor, what: str) -> None:
    if cache_flat.shape[0] >= 2**31:
        raise ValueError(f"{what}: a cache of {cache_flat.shape[0]} rows "
                         f"does not fit the kernels' int32 rows")


def tiered_gather(cache_flat: torch.Tensor, idx: torch.Tensor,
                  slot_table: torch.Tensor, w: torch.Tensor, *,
                  shard_rows: int, resident: bool) -> torch.Tensor:
    """B5: the fp32 gather through the indirection -> (..., m) float32.

    cache_flat (slots * shard_rows, m) float32; idx (..., k) int32 global
    row ids; slot_table (num_shards,) int32; w (..., k) float32; resident:
    the caller's verdict that every touched shard has a slot.
    """
    _check_resident(resident)
    if not cache_flat.is_cuda:
        return tiered_gather_plain(cache_flat, idx, slot_table, w,
                                   shard_rows=shard_rows)
    _build.refuse_grad("tiered_gather", cache_flat, w)
    if cache_flat.dtype != torch.float32:
        raise TypeError(f"tiered_gather kernel takes a float32 cache, got "
                        f"{cache_flat.dtype}")
    _check_cache_rows(cache_flat, "tiered_gather")
    _check_slot_table(cache_flat, slot_table)
    idx2, w2, lead = flat_gather_args(cache_flat, idx, w, "tiered_gather")
    n, top_k, m, out = gather_output(cache_flat, idx2)
    if n:
        fn = _build.function("tiered_gather", "tiered_gather_f32", _ARGS)
        status = fn(cache_flat.data_ptr(), idx2.data_ptr(),
                    slot_table.data_ptr(), w2.data_ptr(), out.data_ptr(),
                    n, top_k, m, _log2(shard_rows), cache_flat.device.index,
                    current_stream(cache_flat))
        _build.check(status, "tiered_gather")
        tiered_gather.launches += 1
    return out.reshape(*lead, m)


def tiered_gather_quant(cache_flat: torch.Tensor, scale_flat: torch.Tensor,
                        idx: torch.Tensor, slot_table: torch.Tensor,
                        w: torch.Tensor, *, shard_rows: int,
                        resident: bool) -> torch.Tensor:
    """B6: B5 over an int8 / float8_e4m3fn cache with per-row fp32 scales
    (scale_flat (slots * shard_rows,)) -> (..., m) float32.  The cache may
    lie at any alignment (the kernel loads 8 bytes a lane from an 8-byte
    aligned cache with m % 8 == 0, byte pairs from a 2-byte aligned one
    with m even, single bytes otherwise)."""
    _check_resident(resident)
    if not cache_flat.is_cuda:
        return tiered_gather_quant_plain(cache_flat, scale_flat, idx,
                                         slot_table, w,
                                         shard_rows=shard_rows)
    _build.refuse_grad("tiered_gather_quant", scale_flat, w)
    if cache_flat.dtype not in _QUANT_SYMBOL:
        raise TypeError(f"tiered_gather_quant kernel takes int8 or "
                        f"float8_e4m3fn caches, got {cache_flat.dtype}")
    _check_cache_rows(cache_flat, "tiered_gather_quant")
    if scale_flat.dtype != torch.float32 \
            or scale_flat.shape != cache_flat.shape[:1] \
            or not scale_flat.is_contiguous() \
            or scale_flat.device != cache_flat.device:
        raise ValueError("scale_flat must be a contiguous float32 (rows,) "
                         "tensor on the cache's device")
    _check_slot_table(cache_flat, slot_table)
    idx2, w2, lead = flat_gather_args(cache_flat, idx, w,
                                      "tiered_gather_quant", align=1)
    n, top_k, m, out = gather_output(cache_flat, idx2)
    if n:
        fn = _build.function("tiered_gather", _QUANT_SYMBOL[cache_flat.dtype],
                             _QUANT_ARGS)
        status = fn(cache_flat.data_ptr(), scale_flat.data_ptr(),
                    idx2.data_ptr(), slot_table.data_ptr(), w2.data_ptr(),
                    out.data_ptr(), n, top_k, m, _log2(shard_rows),
                    cache_flat.device.index, current_stream(cache_flat))
        _build.check(status, "tiered_gather_quant")
        tiered_gather_quant.launches += 1
    return out.reshape(*lead, m)


#: kernel launches since the last reset (a run shows the path used B5, B6)
tiered_gather.launches = 0
tiered_gather_quant.launches = 0
