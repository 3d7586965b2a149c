"""The 2*E8 lattice: decoding, canonicalization, and the 232-candidate table.

Torch counterpart of `repro.core.lattice`.  The lattice is E8 scaled by 2
so every point has integer coordinates:

    Lambda := { x in (2Z)^8 ∪ (2Z+1)^8  :  sum(x) ≡ 0 (mod 4) }

The numpy precompute (shells, the fundamental region F, the exact
candidate table) is this package's own copy of the reference's, so the
port never imports the JAX package.  The torch ops (`decode`,
`canonicalize`, `neighbors_and_weights`) are batched and branch-free.

Sums over the 8 coordinates are taken left to right (`_sum8`,
`_dot_candidates`): the CUDA query kernel (`kernels/csrc/e8_lookup.cu`)
adds in the same order with the same roundings, so its kernel weights
agree with the plain version bit for bit and the two pick the same top-k.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

DIM = 8
#: squared kernel radius == squared minimum distance of the lattice
RADIUS_SQ = 8.0
#: determinant (covolume) of the scaled lattice: 2^8 * det(E8) = 256
DET = 256
#: number of lattice points within sqrt(8) of the fundamental region (paper)
NUM_CANDIDATES = 232
#: paper keeps only the top-32 closest points (>=90% of kernel mass)
DEFAULT_TOP_K = 32


# ---------------------------------------------------------------------------
# Exact shell enumeration and the candidate table (numpy precompute)
# ---------------------------------------------------------------------------

def _shell8() -> np.ndarray:
    """All 240 lattice vectors with squared norm 8."""
    out = []
    for i, j in itertools.combinations(range(DIM), 2):
        for si in (2, -2):
            for sj in (2, -2):
                v = np.zeros(DIM, dtype=np.int64)
                v[i], v[j] = si, sj
                out.append(v)
    for signs in itertools.product((1, -1), repeat=DIM):
        if signs.count(-1) % 2 == 0:
            out.append(np.array(signs, dtype=np.int64))
    arr = np.stack(out)
    assert arr.shape == (240, DIM)
    return arr


def _shell16() -> np.ndarray:
    """All 2160 lattice vectors with squared norm 16."""
    out = []
    for i in range(DIM):
        for s in (4, -4):
            v = np.zeros(DIM, dtype=np.int64)
            v[i] = s
            out.append(v)
    for pos in itertools.combinations(range(DIM), 4):
        for signs in itertools.product((2, -2), repeat=4):
            v = np.zeros(DIM, dtype=np.int64)
            for p, s in zip(pos, signs):
                v[p] = s
            out.append(v)
    for i in range(DIM):
        for signs in itertools.product((1, -1), repeat=DIM):
            v = np.array(signs, dtype=np.int64)
            v[i] *= 3
            if v.sum() % 4 == 0:
                out.append(v)
    arr = np.stack(out)
    assert arr.shape == (2160, DIM), arr.shape
    return arr


@functools.lru_cache(maxsize=None)
def shell_vectors() -> np.ndarray:
    """All 2401 lattice vectors with squared norm <= 16 (shells 0, 8, 16)."""
    return np.concatenate(
        [np.zeros((1, DIM), dtype=np.int64), _shell8(), _shell16()], axis=0
    )


def _halfspaces() -> tuple[np.ndarray, np.ndarray]:
    """F = { z : z1>=...>=z7>=|z8|, z1+z2 <= 2, sum(z) <= 4 } as A z <= b."""
    A, b = [], []
    for i in range(7):
        row = np.zeros(DIM)
        row[i + 1], row[i] = 1.0, -1.0
        A.append(row)
        b.append(0.0)
    row = np.zeros(DIM)
    row[6], row[7] = -1.0, -1.0
    A.append(row)
    b.append(0.0)
    row = np.zeros(DIM)
    row[0], row[1] = 1.0, 1.0
    A.append(row)
    b.append(2.0)
    A.append(np.ones(DIM))
    b.append(4.0)
    return np.stack(A), np.array(b)


def distance_sq_to_fundamental_region(points: np.ndarray) -> np.ndarray:
    """Exact squared distance from each point (M, 8) to the polytope F, by
    enumerating the KKT active sets of the projection QP."""
    A, b = _halfspaces()
    m = A.shape[0]
    pts = np.asarray(points, dtype=np.float64)
    best = np.full(pts.shape[0], np.inf)
    feas_tol, dual_tol = 1e-9, -1e-9
    all_resid = pts @ A.T - b
    inside = np.all(all_resid <= feas_tol, axis=1)
    best[inside] = 0.0
    for r in range(1, m + 1):
        for subset in itertools.combinations(range(m), r):
            S = list(subset)
            As = A[S]
            Ginv = np.linalg.pinv(As @ As.T)
            lam = all_resid[:, S] @ Ginv.T
            x = pts - lam @ As
            ok = np.all(lam >= dual_tol, axis=1)
            ok &= np.all(x @ A.T - b <= feas_tol, axis=1)
            ok &= np.all(np.abs(x @ As.T - b[S]) <= 1e-7, axis=1)
            d2 = ((pts - x) ** 2).sum(axis=1)
            best = np.where(ok, np.minimum(best, d2), best)
    assert np.all(np.isfinite(best)), "projection failed for some point"
    return best


@functools.lru_cache(maxsize=None)
def candidate_table() -> np.ndarray:
    """The (232, 8) int table of lattice points within < sqrt(8) of F,
    sorted lexicographically (paper §2.6)."""
    shells = shell_vectors()
    d2 = distance_sq_to_fundamental_region(shells.astype(np.float64))
    cands = shells[d2 < RADIUS_SQ - 1e-7]
    cands = cands[np.lexsort(cands.T[::-1])]
    assert cands.shape == (NUM_CANDIDATES, DIM), cands.shape
    return cands


@functools.lru_cache(maxsize=None)
def candidate_arrays() -> tuple[np.ndarray, np.ndarray]:
    """float32 candidate table and its squared norms."""
    c = candidate_table().astype(np.float32)
    return c, (c * c).sum(axis=1)


# ---------------------------------------------------------------------------
# Kernel function (paper §2.5)
# ---------------------------------------------------------------------------

def kernel_from_sq(d2: torch.Tensor) -> torch.Tensor:
    """f(r) = max(0, 1 - r^2/8)^4 computed from the squared distance."""
    t = torch.clamp(1.0 - d2 / RADIUS_SQ, min=0.0)
    t2 = t * t
    return t2 * t2


# ---------------------------------------------------------------------------
# Nearest-point decoding (Conway & Sloane), batched and branch-free
# ---------------------------------------------------------------------------

def _sum8(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (size 8), left to right."""
    s = x[..., 0]
    for i in range(1, DIM):
        s = s + x[..., i]
    return s


def _decode_d8(u: torch.Tensor) -> torch.Tensor:
    """Nearest point of D8 = {x in Z^8 : sum(x) even} to u (..., 8)."""
    r = torch.round(u)  # half to even, as jnp.round
    delta = u - r
    # an odd coordinate sum re-rounds the worst coordinate the other way
    worst = torch.argmax(delta.abs(), dim=-1, keepdim=True)
    flip = torch.where(delta >= 0, 1.0, -1.0).to(u.dtype)
    r_alt = r.scatter_add(-1, worst, torch.gather(flip, -1, worst))
    odd = torch.remainder(r.sum(-1), 2.0) != 0
    return torch.where(odd[..., None], r_alt, r)


def decode(q: torch.Tensor) -> torch.Tensor:
    """Nearest point of Lambda = 2*D8 ∪ (2*D8+1) to q (..., 8): decodes
    both cosets and keeps the closer one."""
    even = 2.0 * _decode_d8(q * 0.5)
    odd = 2.0 * _decode_d8((q - 1.0) * 0.5) + 1.0
    de = _sum8((q - even) * (q - even))
    do = _sum8((q - odd) * (q - odd))
    return torch.where((de <= do)[..., None], even, odd)


def canonicalize(t: torch.Tensor):
    """Map a Voronoi-cell offset t = q - decode(q) into F.

    Returns (z, perm, sgn) with z_j = sgn_j * t[perm_j] in F: coordinates
    sorted by decreasing absolute value, the first seven nonnegative, the
    last carrying the sign parity.  The permutation is piecewise constant
    in t, so it is taken from a detached copy.
    """
    perm = torch.argsort(-t.detach().abs(), dim=-1, stable=True)
    tp = torch.gather(t, -1, perm)
    sgn = torch.where(tp < 0, -1.0, 1.0).to(t.dtype)
    parity = torch.prod(sgn, dim=-1, keepdim=True)
    sgn = torch.cat([sgn[..., :7], sgn[..., 7:] * parity], dim=-1)
    return sgn * tp, perm, sgn


@functools.lru_cache(maxsize=None)
def _candidates_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    cand, nsq = candidate_arrays()
    # a cached tensor made under inference_mode (a serve) could never enter
    # an autograd graph later: make it a normal tensor
    with torch.inference_mode(False):
        return (torch.from_numpy(cand).to(device),
                torch.from_numpy(nsq).to(device))


def _dot_candidates(z: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """z (..., 8) . cand (C, 8)^T -> (..., C), summed left to right."""
    zc = z[..., None, :]
    s = zc[..., 0] * cand[:, 0]
    for i in range(1, DIM):
        s = s + zc[..., i] * cand[:, i]
    return s


def neighbors_and_weights(q: torch.Tensor):
    """All 232 candidate lattice points near q (..., 8) with kernel weights.

    Returns neighbors (..., 232, 8) in global un-wrapped coordinates and
    weights (..., 232), zero outside the kernel support.  Distances are
    |z|^2 - 2 z.c + |c|^2 in the canonical frame, as the TPU kernel forms
    them.
    """
    cand, cand_nsq = _candidates_on(q.device)
    c = decode(q)
    z, perm, sgn = canonicalize(q - c)
    d2 = (_sum8(z * z)[..., None] - 2.0 * _dot_candidates(z, cand)
          + cand_nsq)
    w = kernel_from_sq(d2)
    # undo the isometry: k[perm_j] = sgn_j * p_j + c[perm_j]
    inv = torch.argsort(perm, dim=-1, stable=True)
    sp = sgn[..., None, :] * cand  # (..., 232, 8)
    glob = torch.gather(sp, -1, inv[..., None, :].expand(sp.shape))
    return c[..., None, :] + glob, w
