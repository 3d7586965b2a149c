"""Bijective indexing of torus memory locations (torch counterpart of
`repro.core.indexing`).

Memory locations are the points of Lambda inside the fundamental box of
the wrap lattice prod_i (K_i Z), K_i divisible by 4; there are
prod(K)/256 of them.  Every lattice point is x = 2u + p*(1,...,1) with
sum(u) even, so (u_1..u_7, u_8/2, p) is a mixed-radix integer: the flat
index.  Both directions are a handful of int32 ops.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import lattice

_MIN_K = 8  # kernel radius sqrt(8) must be < K/2: smallest legal wrap is 8


@dataclasses.dataclass(frozen=True)
class TorusSpec:
    """Wrap lengths of the memory torus. K_i divisible by 4, >= 8."""

    K: tuple[int, ...]

    def __post_init__(self):
        if len(self.K) != lattice.DIM:
            raise ValueError(f"need {lattice.DIM} wrap lengths, got {self.K}")
        for k in self.K:
            if k < _MIN_K or k % 4 != 0:
                raise ValueError(
                    f"wrap length {k} must be >= {_MIN_K} and divisible by 4"
                )
        if self.num_locations >= 2**31:
            raise ValueError("num_locations must fit int32")

    @property
    def num_locations(self) -> int:
        return math.prod(self.K) // lattice.DET

    @property
    def M(self) -> tuple[int, ...]:
        return tuple(k // 2 for k in self.K)


def choose_torus(log2_locations: int) -> TorusSpec:
    """Power-of-two wrap lengths giving N = 2**log2_locations, extra
    factors of two spread round-robin (a near-cubic torus)."""
    extra = log2_locations - 16
    if extra < 0:
        raise ValueError("lattice memory needs >= 2**16 locations (K_i >= 8)")
    exps = [3] * lattice.DIM
    for i in range(extra):
        exps[i % lattice.DIM] += 1
    spec = TorusSpec(tuple(2**e for e in sorted(exps, reverse=True)))
    assert spec.num_locations == 2**log2_locations
    return spec


def grow_torus(spec: TorusSpec, factor: int) -> TorusSpec:
    """The index-preserving enlargement of a torus: K_0 times `factor` (a
    power of two), every other wrap length unchanged.  M_0 weighs no digit
    of the flat index, so every old lattice point keeps its index and the
    new points take [old_N, new_N): growth is an append
    (`repro_torch.memctl.growth`)."""
    if factor < 2 or factor & (factor - 1):
        raise ValueError(f"growth factor must be a power of two >= 2, "
                         f"got {factor}")
    return TorusSpec((spec.K[0] * factor,) + spec.K[1:])


def growth_parents(old_spec: TorusSpec, new_spec: TorusSpec,
                   lo: int, hi: int) -> np.ndarray:
    """The old-table parent row (int64) of each new row id in [lo, hi):
    the new row's lattice point wrapped onto the old torus.  For
    `grow_torus` enlargements this is ``j % old_N``."""
    for ko, kn in zip(old_spec.K, new_spec.K):
        if kn % ko:
            raise ValueError(
                f"new wrap lengths {new_spec.K} must be componentwise "
                f"multiples of old {old_spec.K}"
            )
    pts = decode_index(np.arange(lo, hi, dtype=np.int64), new_spec)
    return encode_points(torch.from_numpy(pts), old_spec).numpy() \
        .astype(np.int64)


def encode_points(x: torch.Tensor, spec: TorusSpec) -> torch.Tensor:
    """Map lattice points (..., 8) (any integer coords) to int32 flat
    indices, wrapping onto the torus first (floored mod K)."""
    K = torch.tensor(spec.K, dtype=torch.int32, device=x.device)
    xi = torch.round(x).to(torch.int32)
    xm = torch.remainder(xi, K)
    p = xm[..., 0] & 1
    u = (xm - p[..., None]) >> 1  # u_i in [0, M_i)
    qpar = u[..., :7].sum(-1, dtype=torch.int32) & 1
    j8 = (u[..., 7] - qpar) >> 1
    idx7 = torch.zeros_like(p)
    for i in range(7):
        idx7 = idx7 * spec.M[i] + u[..., i]
    return (idx7 * (spec.M[7] >> 1) + j8) * 2 + p


def decode_index(idx: np.ndarray, spec: TorusSpec) -> np.ndarray:
    """Inverse of :func:`encode_points` (numpy)."""
    idx = np.asarray(idx, dtype=np.int64)
    M = spec.M
    p = idx & 1
    r = idx >> 1
    half = M[7] >> 1
    j8 = r % half
    idx7 = r // half
    u = np.zeros(idx.shape + (lattice.DIM,), dtype=np.int64)
    for i in reversed(range(7)):
        u[..., i] = idx7 % M[i]
        idx7 = idx7 // M[i]
    qpar = u[..., :7].sum(axis=-1) & 1
    u[..., 7] = 2 * j8 + qpar
    return 2 * u + p[..., None]
