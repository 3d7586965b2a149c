"""The differentiable lookup: query (K2) + gather (K1) behind one
`torch.autograd.Function`, and the backward kernel both custom gradients
of the port use (torch counterpart of `repro.kernels.ops`).

    forward:   idx, w = K2(q);  out = sum_k w_k * values[idx_k]
    backward:  dvalues = scatter-add of w (x) g over the touched rows
               dq      = sum_k (g . values[idx_k]) * (-relu_k^3 * delta_k)

with delta_k = q - x_k on the nearest torus image of the lattice point
x_k that idx_k names, relu_k = max(0, 1 - |delta_k|^2 / 8): the analytic
derivative of w = relu^4.  `lookup_bwd` computes it on a CUDA tensor with
the hand-written kernel in `csrc/lookup_bwd.cu` (design and bound noted
there) or raises; on a CPU tensor it takes `lookup_bwd_plain`.  Without q
the same kernel computes B1's VJP, (dvalues, dw = g . rows), which
`gather_interp.gather_interp_vjp` uses.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import indexing, lattice
from repro_torch.kernels import _build, e8_lookup, gather_interp


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
                     spec: indexing.TorusSpec | None = None):
    """(dvalues, dq) with q (B3's backward), else (dvalues, dw) (B1's
    VJP), in plain torch: `index_add_`, an einsum and the analytic dq."""
    g = g.float()
    m = values.shape[-1]
    flat_idx = idx.reshape(-1).long()
    flat_wg = (w.float()[..., None] * g[..., None, :]).reshape(-1, m)
    dvalues = torch.zeros(values.shape, dtype=torch.float32,
                          device=values.device).index_add_(0, flat_idx,
                                                           flat_wg)
    rows = values[idx.long()].float()
    dL_dw = torch.einsum("...m,...km->...k", g, rows)
    if q is None:
        return dvalues, dL_dw
    pts = points_from_indices(idx, spec)  # (..., k, 8)
    delta = nearest_image_delta(q.float()[..., None, :], pts, spec.K)
    d2 = (delta * delta).sum(-1)
    relu = torch.clamp(1.0 - d2 / lattice.RADIUS_SQ, min=0.0)
    dq = ((dL_dw * relu ** 3)[..., None] * (-delta)).sum(-2)
    return dvalues, dq


_DQ_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
_DW_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_MAX_M = 256  # the kernel keeps g in registers, 64 columns per chunk


def lookup_bwd(values: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
               g: torch.Tensor, q: torch.Tensor | None = None,
               spec: indexing.TorusSpec | None = None):
    """The lookup's backward: (dvalues (N, m), dq (..., 8)) when q and spec
    are given, else (dvalues, dw (..., k)).

    values (N, m) float32, m even and <= 256; idx (..., k) int32 in
    [0, N); w (..., k) float32; g (..., m) float32; q (..., 8) float32.
    All contiguous, on one device.
    """
    if not values.is_cuda:
        return lookup_bwd_plain(values, idx, w, g, q, spec)
    if values.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"lookup_bwd takes float32 values and g, got "
                        f"{values.dtype} and {g.dtype}")
    idx2, w2, lead = gather_interp.flat_gather_args(values, idx, w,
                                                    "lookup_bwd")
    n, top_k, m = idx2.shape[0], idx2.shape[1], values.shape[1]
    if m % 2 or m > _MAX_M:
        raise ValueError(f"lookup_bwd kernel takes an even m <= {_MAX_M}, "
                         f"got {m}")
    if g.shape != (*lead, m) or not g.is_contiguous() \
            or g.device != values.device:
        raise ValueError(f"g must be a contiguous {(*lead, m)} tensor on "
                         f"the table's device, got {tuple(g.shape)}")
    dvalues = torch.zeros_like(values)
    stream = gather_interp.current_stream(values)
    if q is None:
        out = torch.empty((n, top_k), dtype=torch.float32,
                          device=values.device)
        if n:
            status = _build.function("lookup_bwd", "lookup_bwd_dw_f32",
                                     _DW_ARGS)(
                values.data_ptr(), idx2.data_ptr(), w2.data_ptr(),
                g.data_ptr(), dvalues.data_ptr(), out.data_ptr(), n, top_k,
                m, values.device.index, stream)
            _build.check(status, "lookup_bwd (dw)")
            lookup_bwd.launches += 1
        return dvalues, out.reshape(*lead, top_k)
    if q.dtype != torch.float32 or q.shape != (*lead, lattice.DIM) \
            or not q.is_contiguous() or q.device != values.device:
        raise ValueError(f"q must be a contiguous float32 {(*lead, 8)} "
                         f"tensor on the table's device, got "
                         f"{tuple(q.shape)} {q.dtype}")
    out = torch.empty((n, lattice.DIM), dtype=torch.float32,
                      device=values.device)
    if n:
        wrap = (ctypes.c_int * lattice.DIM)(*spec.K)
        status = _build.function("lookup_bwd", "lookup_bwd_dq_f32",
                                 _DQ_ARGS)(
            values.data_ptr(), idx2.data_ptr(), w2.data_ptr(), g.data_ptr(),
            q.data_ptr(), dvalues.data_ptr(), out.data_ptr(), n, top_k, m,
            wrap, values.device.index, stream)
        _build.check(status, "lookup_bwd (dq)")
        lookup_bwd.launches += 1
    return dvalues, out.reshape(*lead, lattice.DIM)


#: kernel launches since the last reset (a run shows the path used it)
lookup_bwd.launches = 0


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


def lram_lookup(values: torch.Tensor, q: torch.Tensor,
                spec: indexing.TorusSpec,
                top_k: int = lattice.DEFAULT_TOP_K, *,
                return_access: bool = False):
    """out[t] = sum_k f(d(q_t, k)) * values[k] over the top_k nearest slots,
    differentiable in values and q.  q (..., 8) float32 torus coordinates,
    contiguous; values (N, m) float32.  With `return_access` returns
    (out, (idx, w))."""
    out, idx, w = _LRAMLookup.apply(values, q, spec, top_k)
    return (out, (idx, w)) if return_access else out
