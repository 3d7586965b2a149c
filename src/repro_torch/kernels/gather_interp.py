"""K1 and B4: the value gather + interpolation.

    K1:  out[t] = sum_k w[t,k] * values[idx[t,k]]                (fp32 table)
    B4:  out[t] = sum_k (w[t,k] * scale[i]) * q[i], i = idx[t,k]  (int8 or
         float8_e4m3fn payload, one fp32 scale per row)

Torch counterpart of `repro.kernels.gather_interp` (`gather_interp_pallas`,
`gather_interp_quant_pallas` and the differentiable `gather_interp_vjp`,
whose backward is `ops.lookup_bwd`).  On a CUDA tensor `gather_interp` and
`gather_interp_quant` launch the hand-written kernels in
`csrc/gather_interp.cu` and `csrc/gather_interp_quant.cu` (design and bound
noted there) or raise; on a CPU tensor they take `gather_interp_plain` and
`gather_interp_quant_plain`, the same functions in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import quant
from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_QUANT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_QUANT_SYMBOL = {torch.int8: "gather_interp_quant_i8",
                 torch.float8_e4m3fn: "gather_interp_quant_e4m3"}


def gather_interp_plain(values: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., k] * values[idx[..., k]] -> (..., m), fp32 accumulate."""
    rows = values[idx.long()].float()  # (..., k, m)
    return torch.einsum("...k,...km->...m", w.float(), rows)


def gather_interp_quant_plain(q: torch.Tensor, scale: torch.Tensor,
                              idx: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """sum_k (w[..., k] * scale[i]) * q[i] -> (..., m), i = idx[..., k]:
    the scale folded into the weight, as the Pallas body does."""
    i = idx.long()
    ws = w.float() * scale[i].float()
    return torch.einsum("...k,...km->...m", ws, quant.take_rows(q, i))


def flat_gather_args(table: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor, what: str):
    """Check what the warp-per-row gather kernels take and flatten idx/w to
    (n, k): returns (idx2, w2, lead shape)."""
    if table.ndim != 2 or not table.is_contiguous() \
            or table.data_ptr() % 8:
        raise ValueError(f"{what}: the table must be a contiguous, 8-byte "
                         f"aligned (rows, m) tensor")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"{what}: idx must be int32 and w float32, got "
                        f"{idx.dtype} and {w.dtype}")
    if idx.shape != w.shape:
        raise ValueError(f"{what}: idx {tuple(idx.shape)} and w "
                         f"{tuple(w.shape)} differ in shape")
    if idx.device != table.device or w.device != table.device:
        raise ValueError(f"{what}: table, idx and w must be on one device")
    top_k = idx.shape[-1]
    idx2, w2 = idx.reshape(-1, top_k), w.reshape(-1, top_k)
    if not (idx2.is_contiguous() and w2.is_contiguous()):
        raise ValueError(f"{what}: idx and w must be contiguous")
    return idx2, w2, idx.shape[:-1]


def gather_output(table: torch.Tensor, idx2: torch.Tensor):
    """(n, top_k, m) of a flattened call, and the output to fill."""
    n, top_k, m = idx2.shape[0], idx2.shape[1], table.shape[1]
    out = torch.empty((n, m), dtype=torch.float32, device=table.device)
    return n, top_k, m, out


def current_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_interp(values: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., k] * values[idx[..., k]] -> (..., m) float32.

    values (N, m) float32, contiguous; idx (..., k) int32 in [0, N);
    w (..., k) float32.  On a CUDA tensor the output carries no gradient,
    so it raises when grad mode is on and values or w require grad:
    `gather_interp_vjp` is the differentiable form.
    """
    if not values.is_cuda:
        return gather_interp_plain(values, idx, w)
    _build.refuse_grad("gather_interp", values, w)
    if values.dtype != torch.float32:
        raise TypeError(f"gather_interp kernel takes float32 tables, got "
                        f"{values.dtype}")
    idx2, w2, lead = flat_gather_args(values, idx, w, "gather_interp")
    n, top_k, m, out = gather_output(values, idx2)
    if n:
        fn = _build.function("gather_interp", "gather_interp_f32", _ARGS)
        status = fn(values.data_ptr(), idx2.data_ptr(), w2.data_ptr(),
                    out.data_ptr(), n, top_k, m, values.device.index,
                    current_stream(values))
        _build.check(status, "gather_interp")
        gather_interp.launches += 1
    return out.reshape(*lead, m)


def gather_interp_quant(q: torch.Tensor, scale: torch.Tensor,
                        idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k (w[..., k] * scale[i]) * q[i] -> (..., m) float32.

    q (N, m) int8 or float8_e4m3fn, contiguous; scale (N,) float32;
    idx (..., k) int32 in [0, N); w (..., k) float32.  On a CUDA tensor
    not differentiable (raises when w requires grad under grad mode); the
    reference's dw-only VJP is not ported yet (ROADMAP A6).
    """
    if not q.is_cuda:
        return gather_interp_quant_plain(q, scale, idx, w)
    _build.refuse_grad("gather_interp_quant", scale, w)
    if q.dtype not in _QUANT_SYMBOL:
        raise TypeError(f"gather_interp_quant kernel takes int8 or "
                        f"float8_e4m3fn payloads, got {q.dtype}")
    if scale.dtype != torch.float32 or scale.shape != q.shape[:1] \
            or not scale.is_contiguous() or scale.device != q.device:
        raise ValueError("scale must be a contiguous float32 (N,) tensor on "
                         "the payload's device")
    idx2, w2, lead = flat_gather_args(q, idx, w, "gather_interp_quant")
    n, top_k, m, out = gather_output(q, idx2)
    if n:
        fn = _build.function("gather_interp_quant", _QUANT_SYMBOL[q.dtype],
                             _QUANT_ARGS)
        status = fn(q.data_ptr(), scale.data_ptr(), idx2.data_ptr(),
                    w2.data_ptr(), out.data_ptr(), n, top_k, m,
                    q.device.index, current_stream(q))
        _build.check(status, "gather_interp_quant")
        gather_interp_quant.launches += 1
    return out.reshape(*lead, m)


class _GatherInterpVJP(torch.autograd.Function):
    """K1 forward; `ops.lookup_bwd` without dq (B1's VJP) backward."""

    @staticmethod
    def forward(ctx, values, idx, w):
        ctx.save_for_backward(values, idx, w)
        return gather_interp(values, idx, w)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import ops

        values, idx, w = ctx.saved_tensors
        dvalues, dw = ops.lookup_bwd(values, idx, w.float().contiguous(),
                                     g.float().contiguous())
        return (dvalues.to(values.dtype) if ctx.needs_input_grad[0]
                else None, None,
                dw.to(w.dtype) if ctx.needs_input_grad[2] else None)


def gather_interp_vjp(values: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """`gather_interp`, differentiable in values and w (torch counterpart
    of the reference's `gather_interp_vjp`): d values is the sparse
    scatter-add of w (x) g over the touched rows, d w the gathered-row
    dot g . values[idx], both from the backward kernel."""
    return _GatherInterpVJP.apply(values, idx, w)


#: kernel launches since the last reset (a run shows the path used K1, B4)
gather_interp.launches = 0
gather_interp_quant.launches = 0
