"""The differentiable lookup: query (K2) + gather (K1 or B4) behind one
`torch.autograd.Function`, and the backward kernel every custom gradient
of the port uses (torch counterpart of `repro.kernels.ops`).

    forward:   idx, w = K2(q);  out = sum_k w_k * values[r_k]
    backward:  dq = sum_k (g . values[r_k]) * (-relu_k^3 * delta_k)
               + the table's gradient w (x) g over the touched rows

with r_k the row the forward read for idx_k, delta_k = q - x_k on the
nearest torus image of the lattice point x_k that idx_k names and relu_k
= max(0, 1 - |delta_k|^2 / 8): the analytic derivative of w = relu^4.
Where the table's gradient goes depends on the table (`lram_lookup`):

  * a dense fp32, bf16 or fp16 tensor: scattered into a dense fp32
    dvalues (B3's backward, `lookup_bwd`), rounded once to a 2-byte
    table's dtype;
  * a `RowSource`, a table autograd does not own: its rows are read
    through the source (a dense 1-byte table's own rows; a tiered store's
    flat table of cache + overflow rows) and w (x) g goes to its sink (the
    store's host write-back) or nowhere (a frozen 1-byte table).  Only dq
    flows back: `lookup_bwd_rows` (fp32 rows) or `lookup_bwd_quant`
    (1-byte rows with per-row scales).  The same autograd Function,
    through `source_gather`, is a gather over the source's rows
    differentiable in w instead: dw flows back, and w (x) g to the same
    sink (`memstore.interp.tiered_interp`, and B4's VJP
    `gather_interp.gather_interp_quant_vjp`).

All three wrappers launch the hand-written kernels of `csrc/lookup_bwd.cu`
(one body, instantiated per payload, row range and output; for the fp32
instances that scatter, a counting sort of the pairs by row and a pass
over the sorted pairs instead; design and bound noted there) on a CUDA
tensor or raise; on a CPU tensor they take `lookup_bwd_plain`.  Without
q the same kernels compute a gather's VJP, dw = g . rows: B1's
(`gather_interp.gather_interp_vjp`, with the scatter) and B4's (1-byte
rows, no scatter).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from repro_torch import quant
from repro_torch.core import indexing, lattice
from repro_torch.kernels import _build, e8_lookup, gather_interp, \
    sharded_gather


def nearest_image_delta(q: torch.Tensor, k_wrapped: torch.Tensor,
                        K) -> torch.Tensor:
    """q - k for the nearest torus image of k (exact within the kernel
    radius)."""
    Kv = torch.tensor(K, dtype=q.dtype, device=q.device)
    delta = q - k_wrapped
    return delta - Kv * torch.round(delta / Kv)


def points_from_indices(idx: torch.Tensor,
                        spec: indexing.TorusSpec) -> torch.Tensor:
    """The lattice points (..., 8) float32 in [0, K) of flat torus indices:
    the inverse of `indexing.encode_points` in int32 ops."""
    M = spec.M
    idx = idx.to(torch.int32)
    p = idx & 1
    r = idx >> 1
    half = M[7] >> 1
    j8 = torch.remainder(r, half)
    idx7 = torch.div(r, half, rounding_mode="floor")
    us = []
    for i in reversed(range(7)):
        us.append(torch.remainder(idx7, M[i]))
        idx7 = torch.div(idx7, M[i], rounding_mode="floor")
    u = torch.stack(us[::-1], dim=-1)  # (..., 7)
    qpar = u.sum(-1, dtype=torch.int32) & 1
    u8 = 2 * j8 + qpar
    full = torch.cat([u, u8[..., None]], dim=-1)
    return (2 * full + p[..., None]).float()


def lookup_bwd_plain(values: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor, g: torch.Tensor,
                     q: torch.Tensor | None = None,
                     spec: indexing.TorusSpec | None = None, *,
                     scale: torch.Tensor | None = None,
                     rows: torch.Tensor | None = None,
                     scatter: bool = True, base: int | None = None):
    """The backward in plain torch: (dvalues, dq) with q, else (dvalues,
    dw).  The rows read are `rows` (default idx) of `values`, fp32 or a
    1-byte payload whose per-row `scale` multiplies the row's dot
    (dw_k = scale_r * (g . q_r)); dvalues, an `index_add_` of w (x) g, is
    None without `scatter` (a 1-byte table is never scattered).  With
    `base`, `values` is the shard [base, base + len(values)) of the table
    and the range mask applies: an index outside it scatters nothing and
    its dw is 0, so dw and dq are the shard's partial sums."""
    g = g.float()
    m = values.shape[-1]
    r = (idx if rows is None else rows).long()
    ok = None
    if base is not None:
        r, ok = sharded_gather.local_rows(r, base, values.shape[0])
        w = w.float() * ok
    dvalues = None
    if scatter:
        flat_wg = (w.float()[..., None] * g[..., None, :]).reshape(-1, m)
        dvalues = torch.zeros(values.shape, dtype=torch.float32,
                              device=values.device).index_add_(
                                  0, r.reshape(-1), flat_wg)
    if scale is None:
        dL_dw = torch.einsum("...m,...km->...k", g, values[r].float())
    else:
        dL_dw = torch.einsum("...m,...km->...k", g,
                             quant.take_rows(values, r)) * scale[r].float()
    if ok is not None:
        dL_dw = dL_dw * ok
    if q is None:
        return dvalues, dL_dw
    pts = points_from_indices(idx, spec)  # (..., k, 8)
    delta = nearest_image_delta(q.float()[..., None, :], pts, spec.K)
    d2 = (delta * delta).sum(-1)
    relu = torch.clamp(1.0 - d2 / lattice.RADIUS_SQ, min=0.0)
    dq = ((dL_dw * relu ** 3)[..., None] * (-delta)).sum(-2)
    return dvalues, dq


# values, idx, w, g, q, dvalues, dq, scratch, n, k, m, rows, wrap, device,
# stream (dw: no q and no wrap)
_DQ_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
_DW_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_MAX_M = 256  # the kernel keeps g in registers, 64 columns per chunk


def _scatter_scratch(n: int, top_k: int, rows: int,
                     device: torch.device) -> torch.Tensor:
    """The int32 scratch of a scatter instance (its counting sort of the
    n·k pairs by row; layout in `csrc/lookup_bwd.cu`)."""
    if n >= 2**23 or top_k > 255:
        raise ValueError(f"the scatter takes n < 2^23 queries of top_k < "
                         f"256 (it packs t << 8 | k), got {n} x {top_k}")
    fn = _build.load("lookup_bwd").lookup_bwd_scatter_scratch
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return torch.empty(fn(n, top_k, rows), dtype=torch.int32, device=device)


#: None, or a callable that `lookup_bwd` and `lookup_bwd_range` hand
#: their name, positional and keyword arguments each time they go to
#: launch on the card (a caller keeps a training step's backward inputs
#: to hold them against the plain version); the launch counts stay with
#: the wrappers
input_sink = None


def lookup_bwd(values: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
               g: torch.Tensor, q: torch.Tensor | None = None,
               spec: indexing.TorusSpec | None = None):
    """The lookup's backward: (dvalues (N, m), dq (..., 8)) when q and spec
    are given, else (dvalues, dw (..., k)).

    values (N, m) float32, bfloat16 or float16, m even and <= 256;
    idx (..., k) int32 in [0, N); w (..., k) float32; g (..., m) float32;
    q (..., 8) float32.  All contiguous, on one device.  dvalues is
    float32 either way (summed in fp32; the caller rounds it once to a
    2-byte table's dtype, as the reference's VJPs do); a bf16 or fp16
    table launches the instances of its dtype (`lookup_bwd_bf16`'s or
    `lookup_bwd_f16`'s count).
    """
    if not values.is_cuda:
        return lookup_bwd_plain(values, idx, w, g, q, spec)
    if input_sink is not None:
        input_sink("lookup_bwd", (values, idx, w, g), {"q": q, "spec": spec})
    if values.dtype not in gather_interp.TABLE_KINDS \
            or g.dtype != torch.float32:
        raise TypeError(f"lookup_bwd takes float32, bfloat16 or float16 "
                        f"values and float32 g, got {values.dtype} and "
                        f"{g.dtype}")
    name, align = gather_interp.TABLE_KINDS[values.dtype]
    counter = _BWD_COUNTER.get(name, lookup_bwd)
    idx2, w2, lead = gather_interp.flat_gather_args(
        values, idx, w, "lookup_bwd", align=align)
    n, top_k, m = idx2.shape[0], idx2.shape[1], values.shape[1]
    if m % 2 or m > _MAX_M:
        raise ValueError(f"lookup_bwd kernel takes an even m <= {_MAX_M}, "
                         f"got {m}")
    if g.shape != (*lead, m) or not g.is_contiguous() \
            or g.device != values.device:
        raise ValueError(f"g must be a contiguous {(*lead, m)} tensor on "
                         f"the table's device, got {tuple(g.shape)}")
    # the kernel writes every row of dvalues, untouched ones as zeros
    dvalues = torch.empty(values.shape, dtype=torch.float32,
                          device=values.device)
    num_rows = values.shape[0]
    scratch = _scatter_scratch(n, top_k, num_rows, values.device)
    stream = gather_interp.current_stream(values)
    if q is None:
        out = torch.empty((n, top_k), dtype=torch.float32,
                          device=values.device)
        status = _build.function("lookup_bwd", f"lookup_bwd_dw_{name}",
                                 _DW_ARGS)(
            values.data_ptr(), idx2.data_ptr(), w2.data_ptr(), g.data_ptr(),
            dvalues.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
            top_k, m, num_rows, values.device.index, stream)
        _build.check(status, "lookup_bwd (dw)")
        counter.launches += 1
        return dvalues, out.reshape(*lead, top_k)
    if q.dtype != torch.float32 or q.shape != (*lead, lattice.DIM) \
            or not q.is_contiguous() or q.device != values.device:
        raise ValueError(f"q must be a contiguous float32 {(*lead, 8)} "
                         f"tensor on the table's device, got "
                         f"{tuple(q.shape)} {q.dtype}")
    out = torch.empty((n, lattice.DIM), dtype=torch.float32,
                      device=values.device)
    wrap = (ctypes.c_int * lattice.DIM)(*spec.K)
    status = _build.function("lookup_bwd", f"lookup_bwd_dq_{name}",
                             _DQ_ARGS)(
        values.data_ptr(), idx2.data_ptr(), w2.data_ptr(), g.data_ptr(),
        q.data_ptr(), dvalues.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n, top_k, m, num_rows, wrap, values.device.index, stream)
    _build.check(status, "lookup_bwd (dq)")
    counter.launches += 1
    return dvalues, out.reshape(*lead, lattice.DIM)


def lookup_bwd_bf16(values: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor, g: torch.Tensor,
                    q: torch.Tensor | None = None,
                    spec: indexing.TorusSpec | None = None):
    """`lookup_bwd` on a bfloat16 table (its launches count here): the
    rows read as bf16 and widened to fp32 exactly, dvalues (N, m) fp32."""
    if values.dtype != torch.bfloat16:
        raise TypeError(f"lookup_bwd_bf16 takes a bfloat16 table, got "
                        f"{values.dtype}")
    return lookup_bwd(values, idx, w, g, q, spec)


def lookup_bwd_f16(values: torch.Tensor, idx: torch.Tensor,
                   w: torch.Tensor, g: torch.Tensor,
                   q: torch.Tensor | None = None,
                   spec: indexing.TorusSpec | None = None):
    """`lookup_bwd` on a float16 table (its launches count here): the
    rows read as fp16 and widened to fp32 exactly, dvalues (N, m) fp32."""
    if values.dtype != torch.float16:
        raise TypeError(f"lookup_bwd_f16 takes a float16 table, got "
                        f"{values.dtype}")
    return lookup_bwd(values, idx, w, g, q, spec)


#: kernel launches since the last reset (a run shows the path used it)
lookup_bwd.launches = 0
lookup_bwd_bf16.launches = 0
lookup_bwd_f16.launches = 0
_BWD_COUNTER = {"bf16": lookup_bwd_bf16, "f16": lookup_bwd_f16}


# values, scale, rows, idx, w, g, q, dq, n, k, m, wrap, device, stream
_ROWS_DQ_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
# values, scale, rows, w, g, dw, n, k, m, device, stream
_ROWS_DW_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_ROWS_PAYLOAD = {torch.float32: "f32", torch.int8: "i8",
                 torch.float8_e4m3fn: "e4m3"}


def _rows_bwd(wrapper, table, scale, rows, w, g, idx, q, spec):
    """The instances without scatter: dq (..., 8) when q is given (idx
    names the lattice points), else dw (..., k), over `rows` of `table`.
    Counts a launch on `wrapper`."""
    if not table.is_cuda:
        _, out = lookup_bwd_plain(table, rows if idx is None else idx, w, g,
                                  q, spec, scale=scale, rows=rows,
                                  scatter=False)
        return out
    what = wrapper.__name__
    if g.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 g, got {g.dtype}")
    rows2, w2, lead = gather_interp.flat_gather_args(table, rows, w, what)
    n, top_k, m = rows2.shape[0], rows2.shape[1], table.shape[1]
    if m % 2 or m > _MAX_M:
        raise ValueError(f"{what} kernel takes an even m <= {_MAX_M}, "
                         f"got {m}")
    if g.shape != (*lead, m) or not g.is_contiguous() \
            or g.device != table.device:
        raise ValueError(f"g must be a contiguous {(*lead, m)} tensor on "
                         f"the table's device, got {tuple(g.shape)}")
    if scale is not None and (
            scale.dtype != torch.float32 or scale.shape != table.shape[:1]
            or not scale.is_contiguous() or scale.device != table.device):
        raise ValueError("scale must be a contiguous float32 (N,) tensor "
                         "on the table's device")
    name = _ROWS_PAYLOAD[table.dtype]
    stream = gather_interp.current_stream(table)
    scale_ptr = scale.data_ptr() if scale is not None else None
    if q is None:
        out = torch.empty((n, top_k), dtype=torch.float32,
                          device=table.device)
        if n:
            status = _build.function("lookup_bwd", f"lookup_bwd_rows_dw_"
                                     f"{name}", _ROWS_DW_ARGS)(
                table.data_ptr(), scale_ptr, rows2.data_ptr(),
                w2.data_ptr(), g.data_ptr(), out.data_ptr(), n, top_k, m,
                table.device.index, stream)
            _build.check(status, f"{what} (dw)")
            wrapper.launches += 1
        return out.reshape(*lead, top_k)
    if idx is None or idx.dtype != torch.int32 or idx.shape != rows.shape \
            or not idx.is_contiguous() or idx.device != table.device:
        raise ValueError(f"{what}: dq needs the lattice indices idx, a "
                         f"contiguous int32 tensor shaped like rows")
    if q.dtype != torch.float32 or q.shape != (*lead, lattice.DIM) \
            or not q.is_contiguous() or q.device != table.device:
        raise ValueError(f"q must be a contiguous float32 {(*lead, 8)} "
                         f"tensor on the table's device, got "
                         f"{tuple(q.shape)} {q.dtype}")
    out = torch.empty((n, lattice.DIM), dtype=torch.float32,
                      device=table.device)
    if n:
        wrap = (ctypes.c_int * lattice.DIM)(*spec.K)
        status = _build.function("lookup_bwd", f"lookup_bwd_rows_dq_{name}",
                                 _ROWS_DQ_ARGS)(
            table.data_ptr(), scale_ptr, rows2.data_ptr(), idx.data_ptr(),
            w2.data_ptr(), g.data_ptr(), q.data_ptr(), out.data_ptr(), n,
            top_k, m, wrap, table.device.index, stream)
        _build.check(status, f"{what} (dq)")
        wrapper.launches += 1
    return out.reshape(*lead, lattice.DIM)


def lookup_bwd_rows(values: torch.Tensor, rows: torch.Tensor,
                    w: torch.Tensor, g: torch.Tensor, *,
                    idx: torch.Tensor | None = None,
                    q: torch.Tensor | None = None,
                    spec: indexing.TorusSpec | None = None) -> torch.Tensor:
    """The backward over fp32 rows without the scatter: dq (..., 8) when
    q, idx and spec are given, else dw (..., k) = g . values[rows].

    values (R, m) float32, m even and <= 256; rows (..., k) int32 in
    [0, R), the rows the forward read; idx (..., k) int32, the lattice
    indices they stand for; w (..., k) float32; g (..., m) float32;
    q (..., 8) float32.  All contiguous, on one device.
    """
    if values.is_cuda and values.dtype != torch.float32:
        raise TypeError(f"lookup_bwd_rows takes float32 rows, got "
                        f"{values.dtype}")
    return _rows_bwd(lookup_bwd_rows, values, None, rows, w, g, idx, q,
                     spec)


def lookup_bwd_quant(payload: torch.Tensor, scale: torch.Tensor,
                     rows: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     *, idx: torch.Tensor | None = None,
                     q: torch.Tensor | None = None,
                     spec: indexing.TorusSpec | None = None) -> torch.Tensor:
    """`lookup_bwd_rows` over 1-byte rows: payload (R, m) int8 or
    float8_e4m3fn with scale (R,) float32, dequantized in registers;
    dw_k = scale_r * (g . q_r).  Without q it is B4's VJP (the reference's
    `gather_interp_quant` backward: the table is frozen, only dw flows)."""
    if payload.is_cuda and payload.dtype not in (torch.int8,
                                                 torch.float8_e4m3fn):
        raise TypeError(f"lookup_bwd_quant takes int8 or float8_e4m3fn "
                        f"payloads, got {payload.dtype}")
    return _rows_bwd(lookup_bwd_quant, payload, scale, rows, w, g, idx, q,
                     spec)


#: kernel launches since the last reset
lookup_bwd_rows.launches = 0
lookup_bwd_quant.launches = 0


# fp32: values, idx, w, g, q, dvalues, dq, scratch; 1-byte: values, scale,
# idx, w, g, q, dq; then n, k, m, base, rows, wrap, device, stream (dw: no
# q and no wrap)
_RANGE_DQ_ARGS = {
    f32: [ctypes.c_void_p] * ptrs + [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    for f32, ptrs in ((True, 8), (False, 7))}
_RANGE_DW_ARGS = {
    f32: [ctypes.c_void_p] * ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for f32, ptrs in ((True, 7), (False, 6))}


def lookup_bwd_range(values: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor, g: torch.Tensor, base: int, *,
                     scale: torch.Tensor | None = None,
                     q: torch.Tensor | None = None,
                     spec: indexing.TorusSpec | None = None):
    """Row 9's backward on one rank's row-range shard: (dvalues, dq) when
    q and spec are given, else (dvalues, dw), over the in-range k only.

    values (rows, m) is the shard [base, base + rows) of the table: fp32,
    bf16 or fp16 (dvalues (rows, m) fp32 is the scatter-add of w (x) g at
    idx - base; a 2-byte shard launches `lookup_bwd_range_bf16`'s or
    `lookup_bwd_range_f16`'s count), or a 1-byte payload with `scale`
    (rows,) float32 (frozen: dvalues is None).
    dq (..., 8) and dw (..., k) are the shard's PARTIAL sums (dw_k = 0 for
    an index the shard does not hold): the partials of the `model` ranks
    sum to the whole.  idx (..., k) int32, indices of the whole table;
    w (..., k), g (..., m), q (..., 8) float32.  All contiguous, on one
    device.  The sharded cells train through the dq instances; the dw
    instances are reached by no training path and are held against their
    plain versions by the card tests and `chip_smoke.py`.
    """
    if not values.is_cuda:
        return lookup_bwd_plain(values, idx, w, g, q, spec, scale=scale,
                                scatter=scale is None, base=base)
    if input_sink is not None:
        input_sink("lookup_bwd_range", (values, idx, w, g, base),
                   {"scale": scale, "q": q, "spec": spec})
    f32 = scale is None  # the scatter instances (fp32, bf16 or fp16 rows)
    kinds = gather_interp.TABLE_KINDS if f32 else {
        t: (n, 8) for t, n in _ROWS_PAYLOAD.items() if t != torch.float32}
    if values.dtype not in kinds:
        raise TypeError(f"lookup_bwd_range takes a float32, bfloat16 or "
                        f"float16 shard, or an int8 / float8_e4m3fn shard "
                        f"with its scales; got {values.dtype} with "
                        f"scale={scale is not None}")
    if g.dtype != torch.float32:
        raise TypeError(f"lookup_bwd_range takes float32 g, got {g.dtype}")
    name, align = kinds[values.dtype]
    idx2, w2, lead = gather_interp.flat_gather_args(
        values, idx, w, "lookup_bwd_range", align=align)
    n, top_k, m = idx2.shape[0], idx2.shape[1], values.shape[1]
    if m % 2 or m > _MAX_M:
        raise ValueError(f"lookup_bwd_range kernel takes an even m <= "
                         f"{_MAX_M}, got {m}")
    if g.shape != (*lead, m) or not g.is_contiguous() \
            or g.device != values.device:
        raise ValueError(f"g must be a contiguous {(*lead, m)} tensor on "
                         f"the shard's device, got {tuple(g.shape)}")
    if scale is not None and (
            scale.dtype != torch.float32 or scale.shape != values.shape[:1]
            or not scale.is_contiguous() or scale.device != values.device):
        raise ValueError("scale must be a contiguous float32 (rows,) tensor "
                         "on the shard's device")
    base = sharded_gather.check_shard_base(values, base, "lookup_bwd_range")
    rows = values.shape[0]
    stream = gather_interp.current_stream(values)
    if q is not None and (
            q.dtype != torch.float32 or q.shape != (*lead, lattice.DIM)
            or not q.is_contiguous() or q.device != values.device):
        raise ValueError(f"q must be a contiguous float32 {(*lead, 8)} "
                         f"tensor on the shard's device, got "
                         f"{tuple(q.shape)} {q.dtype}")
    # the scatter kernel writes every row of the shard's fp32 dvalues
    dvalues = (torch.empty(values.shape, dtype=torch.float32,
                           device=values.device) if f32 else None)
    out = torch.empty((n, top_k if q is None else lattice.DIM),
                      dtype=torch.float32, device=values.device)
    if not (n or f32):
        return dvalues, out.reshape(*lead, out.shape[1])
    # C order: values, [scale,] idx, w, g, [q,] [dvalues,] out, [scratch]
    ptrs = [values.data_ptr()] + ([] if f32 else [scale.data_ptr()]) \
        + [idx2.data_ptr(), w2.data_ptr(), g.data_ptr()] \
        + ([] if q is None else [q.data_ptr()]) \
        + ([dvalues.data_ptr()] if f32 else []) + [out.data_ptr()]
    if f32:
        ptrs.append(_scatter_scratch(n, top_k, rows,
                                     values.device).data_ptr())
    stage = "dw" if q is None else "dq"
    args = [n, top_k, m, base, rows] \
        + ([] if q is None else [(ctypes.c_int * lattice.DIM)(*spec.K)])
    status = _build.function(
        "lookup_bwd", f"lookup_bwd_range_{stage}_{name}",
        (_RANGE_DW_ARGS if q is None else _RANGE_DQ_ARGS)[f32])(
        *ptrs, *args, values.device.index, stream)
    _build.check(status, f"lookup_bwd_range ({stage})")
    _RANGE_COUNTER.get(name, lookup_bwd_range).launches += 1
    return dvalues, out.reshape(*lead, out.shape[1])


def lookup_bwd_range_bf16(values: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor, g: torch.Tensor, base: int, *,
                          q: torch.Tensor | None = None,
                          spec: indexing.TorusSpec | None = None):
    """`lookup_bwd_range` on a bfloat16 shard (its launches count here):
    dvalues (rows, m) fp32 and the partial dq or dw."""
    if values.dtype != torch.bfloat16:
        raise TypeError(f"lookup_bwd_range_bf16 takes a bfloat16 shard, "
                        f"got {values.dtype}")
    return lookup_bwd_range(values, idx, w, g, base, q=q, spec=spec)


def lookup_bwd_range_f16(values: torch.Tensor, idx: torch.Tensor,
                         w: torch.Tensor, g: torch.Tensor, base: int, *,
                         q: torch.Tensor | None = None,
                         spec: indexing.TorusSpec | None = None):
    """`lookup_bwd_range` on a float16 shard (its launches count here):
    dvalues (rows, m) fp32 and the partial dq or dw."""
    if values.dtype != torch.float16:
        raise TypeError(f"lookup_bwd_range_f16 takes a float16 shard, "
                        f"got {values.dtype}")
    return lookup_bwd_range(values, idx, w, g, base, q=q, spec=spec)


#: kernel launches since the last reset
lookup_bwd_range.launches = 0
lookup_bwd_range_bf16.launches = 0
lookup_bwd_range_f16.launches = 0
_RANGE_COUNTER = {"bf16": lookup_bwd_range_bf16,
                  "f16": lookup_bwd_range_f16}


@dataclasses.dataclass(frozen=True)
class RowSource:
    """A table autograd does not own, as `lram_lookup` reads it.

    ``rows(idx) -> (table, scale or None, rows)``: the table the lookup
    gathers from (fp32 rows, or a 1-byte payload with per-row scales) and
    the int32 row of each index in it, shaped like idx.  ``sink(idx, w,
    g)`` takes the table's gradient w (x) g over the touched rows (the
    tiered store's write-back); None for a frozen table.
    """

    rows: Callable
    sink: Callable | None = None


class _LRAMLookup(torch.autograd.Function):
    """K2 then K1 forward (idx and w kept for the backward and returned,
    not differentiable); `lookup_bwd` with dq as the backward."""

    @staticmethod
    def forward(ctx, values, q, spec, top_k):
        idx, w = e8_lookup.lram_query(q, spec, top_k)
        out = gather_interp.gather_interp(values, idx, w)
        ctx.save_for_backward(values, q, idx, w)
        ctx.spec = spec
        ctx.mark_non_differentiable(idx, w)
        return out, idx, w

    @staticmethod
    def backward(ctx, g, _g_idx, _g_w):
        values, q, idx, w = ctx.saved_tensors
        dvalues, dq = lookup_bwd(values, idx, w, g.float().contiguous(),
                                 q=q, spec=ctx.spec)
        return (dvalues.to(values.dtype) if ctx.needs_input_grad[0]
                else None,
                dq.to(q.dtype) if ctx.needs_input_grad[1] else None,
                None, None)


class _SourceGather(torch.autograd.Function):
    """K1 or B4 over the rows a `RowSource` names for idx, weighted by w,
    differentiable in x: x is q when spec is given (idx and w came from
    K2(q); the backward is dq), else x is w itself (the backward is dw).
    Either comes from `lookup_bwd_rows` or `lookup_bwd_quant` on the table
    and rows the forward read; then the table's gradient goes to the
    source's sink, the one place the sink is called."""

    @staticmethod
    def forward(ctx, x, source, idx, w, spec):
        w = (x if w is None else w).float().contiguous()
        table, scale, rows = source.rows(idx)
        if scale is None:
            out = gather_interp.gather_interp(table, rows, w)
        else:
            out = gather_interp.gather_interp_quant(table, scale, rows, w)
        ctx.save_for_backward(x, idx, w, table, scale, rows)
        ctx.source, ctx.spec = source, spec
        return out

    @staticmethod
    def backward(ctx, g):
        x, idx, w, table, scale, rows = ctx.saved_tensors
        g = g.float().contiguous()
        kw = {} if ctx.spec is None else dict(idx=idx, q=x, spec=ctx.spec)
        if scale is None:
            grad = lookup_bwd_rows(table, rows, w, g, **kw)
        else:
            grad = lookup_bwd_quant(table, scale, rows, w, g, **kw)
        if ctx.source.sink is not None:
            ctx.source.sink(idx, w, g)
        return grad.to(x.dtype), None, None, None, None


def source_gather(source: RowSource, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., k] * (the source's row for idx[..., k]) -> (..., m),
    differentiable in w (dw from the backward kernel); the table's
    gradient w (x) g goes to the source's sink."""
    return _SourceGather.apply(w, source, idx, None, None)


def lram_lookup(values, q: torch.Tensor, spec: indexing.TorusSpec,
                top_k: int = lattice.DEFAULT_TOP_K, *,
                return_access: bool = False):
    """out[t] = sum_k f(d(q_t, k)) * values[k] over the top_k nearest slots,
    differentiable in q, and in values when it is a dense (N, m) float32,
    bfloat16 or float16 tensor (its gradient summed in fp32 and rounded
    once); a `RowSource` takes the table's gradient itself (or is
    frozen).  q (..., 8) float32 torus coordinates, contiguous.  With
    `return_access` returns (out, (idx, w))."""
    if isinstance(values, RowSource):
        with torch.no_grad():
            idx, w = e8_lookup.lram_query(q, spec, top_k)
        out = _SourceGather.apply(q, values, idx, w, spec)
    else:
        out, idx, w = _LRAMLookup.apply(values, q, spec, top_k)
    return (out, (idx, w)) if return_access else out
