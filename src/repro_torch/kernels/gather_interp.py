"""K1: the value gather + interpolation, out[t] = sum_k w[t,k] * values[idx[t,k]].

Torch counterpart of `repro.kernels.gather_interp` (`gather_interp_pallas`).
On a CUDA tensor `gather_interp` launches the hand-written kernel in
`csrc/gather_interp.cu` (design and bound noted there) or raises; on a CPU
tensor it takes `gather_interp_plain`, the same function in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def gather_interp_plain(values: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., k] * values[idx[..., k]] -> (..., m), fp32 accumulate."""
    rows = values[idx.long()].float()  # (..., k, m)
    return torch.einsum("...k,...km->...m", w.float(), rows)


def _lib():
    lib = _build.load("gather_interp")
    fn = lib.gather_interp_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gather_interp(values: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., k] * values[idx[..., k]] -> (..., m) float32.

    values (N, m) float32, contiguous; idx (..., k) int32 in [0, N);
    w (..., k) float32.  Not differentiable (the serving path runs under
    no_grad; the backward kernel comes with training).
    """
    if not values.is_cuda:
        return gather_interp_plain(values, idx, w)
    if values.dtype != torch.float32:
        raise TypeError(f"gather_interp kernel takes float32 tables, got "
                        f"{values.dtype}")
    if values.ndim != 2 or not values.is_contiguous() \
            or values.data_ptr() % 8:
        raise ValueError("values must be a contiguous, 8-byte aligned "
                         "(N, m) tensor")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and w float32, got {idx.dtype} "
                        f"and {w.dtype}")
    if idx.shape != w.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and w {tuple(w.shape)} "
                         f"differ in shape")
    if idx.device != values.device or w.device != values.device:
        raise ValueError("values, idx and w must be on one device")
    lead, top_k, m = idx.shape[:-1], idx.shape[-1], values.shape[1]
    idx2 = idx.reshape(-1, top_k)
    w2 = w.reshape(-1, top_k)
    if not (idx2.is_contiguous() and w2.is_contiguous()):
        raise ValueError("idx and w must be contiguous")
    n = idx2.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=values.device)
    if n:
        status = _lib()(
            values.data_ptr(), idx2.data_ptr(), w2.data_ptr(),
            out.data_ptr(), n, top_k, m, values.device.index,
            torch.cuda.current_stream(values.device).cuda_stream,
        )
        _build.check(status, "gather_interp")
        gather_interp.launches += 1
    return out.reshape(*lead, m)


#: kernel launches since the last reset (a run shows the path used K1)
gather_interp.launches = 0
