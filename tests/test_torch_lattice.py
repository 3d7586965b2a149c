"""Port parity: lattice maths, torus indexing and torus_map against the JAX
package (inputs from numpy with a seed; tolerances stated per test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import indexing as j_indexing
from repro.core import lattice as j_lattice
from repro.core import torus as j_torus
from repro_torch.core import indexing, lattice, torus


def test_candidate_table_bit_equal():
    np.testing.assert_array_equal(lattice.candidate_table(),
                                  j_lattice.candidate_table())
    c, nsq = lattice.candidate_arrays()
    jc, jnsq = j_lattice.candidate_arrays()
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(nsq, jnsq)


@pytest.mark.parametrize("log2", [16, 18, 20, 23])
def test_choose_torus_matches(log2):
    assert indexing.choose_torus(log2).K == j_indexing.choose_torus(log2).K


@pytest.mark.parametrize("log2", [16, 20])
def test_encode_decode_bit_exact(log2):
    """Bit-exact on int32, including negative (un-wrapped) coordinates."""
    spec, j_spec = indexing.choose_torus(log2), j_indexing.choose_torus(log2)
    rng = np.random.default_rng(log2)
    ids = rng.integers(0, spec.num_locations, size=4096)
    pts = indexing.decode_index(ids, spec)
    np.testing.assert_array_equal(pts, j_indexing.decode_index(ids, j_spec))
    # shift by whole wrap periods, some negative: same index after the mod
    shift = rng.integers(-2, 3, size=pts.shape) * np.asarray(spec.K)
    x = (pts + shift).astype(np.float32)
    got = indexing.encode_points(torch.from_numpy(x), spec)
    want = np.asarray(j_indexing.encode_points(jnp.asarray(x), j_spec))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ids)


def _queries(n, seed):
    return np.random.default_rng(seed).uniform(
        -4, 12, size=(n, 8)).astype(np.float32)


def test_decode_and_canonicalize_match():
    """decode exactly; canonical z, sign and perm to 1e-6 (ties aside, the
    stable argsort gives the same permutation)."""
    q = _queries(2000, 1)
    c = lattice.decode(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(c, np.asarray(j_lattice.decode(
        jnp.asarray(q))))
    t = q - c
    z, perm, sgn = lattice.canonicalize(torch.from_numpy(t))
    jz, jperm, jsgn = j_lattice.canonicalize(jnp.asarray(t))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(sgn.numpy(), np.asarray(jsgn))


def test_neighbors_and_weights_match():
    """Neighbours exactly, weights to 1e-6 (the port sums the 8-term dot
    left to right; XLA's matmul may add in another order)."""
    q = _queries(500, 2)
    nb, w = lattice.neighbors_and_weights(torch.from_numpy(q))
    jnb, jw = j_lattice.neighbors_and_weights(jnp.asarray(q))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


def test_kernel_from_sq_matches():
    d2 = np.linspace(-1, 10, 1001).astype(np.float32)
    np.testing.assert_allclose(
        lattice.kernel_from_sq(torch.from_numpy(d2)).numpy(),
        np.asarray(j_lattice.kernel_from_sq(jnp.asarray(d2))), atol=1e-7)


@pytest.mark.parametrize("near_zero", [False, True])
def test_torus_map_matches(near_zero):
    """q in [0, K) and the scale to 1e-6 (relative: q runs up to K=16),
    including |z| ~ 0, denormal and exactly-zero inputs."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    if near_zero:
        x[:64, :8] = 0.0
        x[:64, 8:] = 0.0
        x[64:128, 3] = 1e-38  # denormal-range real part
        x[64:128, 11] = -1e-39
        x[128:192] *= 1e-11  # |z|^2 below the safe epsilon
    K = indexing.choose_torus(20).K
    q, scale = torus.torus_map(torch.from_numpy(x), K)
    jq, jscale = j_torus.torus_map(jnp.asarray(x), K)
    assert np.isfinite(q.numpy()).all() and np.isfinite(scale.numpy()).all()
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale),
                               rtol=1e-6, atol=1e-6)


def test_torus_map_gradient_finite_at_zero():
    """The double `where` keeps the backward finite where |z| ~ 0."""
    x = torch.zeros(4, 16, requires_grad=True)
    q, scale = torus.torus_map(x, (8,) * 8)
    (q.sum() + scale.sum()).backward()
    assert torch.isfinite(x.grad).all()
