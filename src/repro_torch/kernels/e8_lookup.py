"""K2: the fused LRAM query, q (..., 8) -> top-k (idx int32, w float32).

Torch counterpart of `repro.kernels.e8_lookup` (`lram_query_pallas`).
Contract (`repro/kernels/ref.py:16-20`): the same (idx, w) as the memory
layer's top-k query, `indices_and_weights`.  On a CUDA tensor
`lram_query` launches the hand-written kernel in `csrc/e8_lookup.cu`
(design and bound noted there) or raises; on a CPU tensor it takes
`lram_query_plain`.  Weights come out in descending order.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import indexing, lattice
from repro_torch.kernels import _build

NUM_PADDED = 256  # candidate table padded so each lane owns 8 candidates


def lram_query_plain(q: torch.Tensor, spec: indexing.TorusSpec,
                     top_k: int = lattice.DEFAULT_TOP_K):
    """Top-k (lattice index, kernel weight) pairs for q (..., 8): the
    torch form of the reference's host-path `indices_and_weights`.

    The top-k is a stable descending sort, so equal weights keep the
    lower candidate index first, as the kernel (and `lax.top_k`) does.
    """
    nbrs, w = lattice.neighbors_and_weights(q.float())
    w_sorted, order = torch.sort(w, dim=-1, descending=True, stable=True)
    sel = order[..., :top_k]
    nb_top = torch.gather(nbrs, -2, sel[..., None].expand(
        *sel.shape, lattice.DIM))
    return indexing.encode_points(nb_top, spec), w_sorted[..., :top_k]


@functools.lru_cache(maxsize=None)
def _padded_candidates(device: torch.device):
    """The kernel's candidate table, (2, 256, 4): coordinates 0-3, then
    4-7, of each padded candidate (one float4 each), and the (256,)
    squared norms."""
    cand, nsq = lattice.candidate_arrays()
    pad = NUM_PADDED - cand.shape[0]
    cand_p = np.concatenate([cand, np.zeros((pad, 8), np.float32)])
    halves = cand_p.reshape(NUM_PADDED, 2, 4).transpose(1, 0, 2)
    nsq_p = np.concatenate([nsq, np.zeros((pad,), np.float32)])
    with torch.inference_mode(False):  # cached: usable under autograd too
        return (torch.from_numpy(np.ascontiguousarray(halves)).to(device),
                torch.from_numpy(nsq_p).to(device))


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]


def lram_query(q: torch.Tensor, spec: indexing.TorusSpec,
               top_k: int = lattice.DEFAULT_TOP_K):
    """(idx, w) = top-k lattice memory slots + kernel weights for q (..., 8).

    q must be float32 on either device (any other dtype raises: the
    memory layer casts its query before `torus_map`, and nothing here
    casts silently); on CUDA it is flattened to a contiguous (n, 8).
    On a CUDA tensor w carries no gradient, so it raises when grad mode is
    on and q requires grad: `ops.lram_lookup` is the differentiable
    lookup (its backward takes dq analytically).  Every offset of the
    kernel is 64-bit and its grid is capped (a grid-stride loop), so n is
    bounded by int32 alone.
    """
    if q.dtype != torch.float32:
        raise TypeError(f"lram_query takes float32 queries, got {q.dtype}")
    if not q.is_cuda:
        return lram_query_plain(q, spec, top_k)
    _build.refuse_grad("lram_query", q)
    if q.shape[-1] != lattice.DIM:
        raise ValueError(f"queries must be (..., 8), got {tuple(q.shape)}")
    if not 1 <= top_k <= lattice.NUM_CANDIDATES:
        raise ValueError(f"top_k must be in [1, {lattice.NUM_CANDIDATES}]")
    lead = q.shape[:-1]
    qf = q.reshape(-1, lattice.DIM)
    if not qf.is_contiguous():
        raise ValueError("queries must be contiguous")
    n = qf.shape[0]
    idx = torch.empty((n, top_k), dtype=torch.int32, device=q.device)
    w = torch.empty((n, top_k), dtype=torch.float32, device=q.device)
    if n:
        cand, nsq = _padded_candidates(q.device)
        wrap = (ctypes.c_int * lattice.DIM)(*spec.K)
        status = _build.function("e8_lookup", "lram_query_f32", _ARGS)(
            qf.data_ptr(), cand.data_ptr(), nsq.data_ptr(),
            idx.data_ptr(), w.data_ptr(), n, top_k, wrap, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(status, "lram_query")
        lram_query.launches += 1
    return idx.reshape(*lead, top_k), w.reshape(*lead, top_k)


#: kernel launches since the last reset (a run shows the path used K2)
lram_query.launches = 0
