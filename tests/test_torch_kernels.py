"""Port parity: the two kernel modules (K1 gather_interp, K2 lram_query).

On the CPU each wrapper takes its plain version, which is held here against
the Pallas kernel run in interpret mode.  The kernels themselves are held
against their plain versions on the card by `test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import indexing as j_indexing
from repro.kernels import e8_lookup as j_e8
from repro.kernels import gather_interp as j_gather
from repro_torch.core import indexing, lattice, lookup
from repro_torch.core.lram import LRAMConfig
from repro_torch.kernels import e8_lookup, gather_interp, tiered_gather
from repro_torch.memstore import TieredSpec

SPEC, J_SPEC = indexing.choose_torus(16), j_indexing.choose_torus(16)


@pytest.mark.parametrize("m", [8, 64])
def test_gather_interp_plain_matches_pallas(m):
    """K1's plain version against gather_interp_pallas (interpret), 1e-6."""
    rng = np.random.default_rng(m)
    values = rng.normal(size=(1024, m)).astype(np.float32)
    idx = rng.integers(0, 1024, size=(3, 7, 32)).astype(np.int32)
    w = rng.uniform(0, 1, size=(3, 7, 32)).astype(np.float32)
    before = gather_interp.gather_interp.launches
    got = gather_interp.gather_interp(torch.from_numpy(values),
                                      torch.from_numpy(idx),
                                      torch.from_numpy(w))
    assert gather_interp.gather_interp.launches == before  # CPU: no kernel
    want = j_gather.gather_interp_pallas(jnp.asarray(values),
                                         jnp.asarray(idx), jnp.asarray(w),
                                         interpret=True)
    assert got.shape == (3, 7, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("lo,hi", [(-4.0, 12.0), (0.0, 8.0)])
def test_lram_query_plain_matches_pallas(lo, hi):
    """K2's plain version against lram_query_pallas (interpret) on 128
    queries: weights as sorted multisets to 1e-5 and the gathered output
    through one table to rtol 2e-5, atol 1e-5 (ties may order equal
    weights differently, so raw idx are not compared)."""
    rng = np.random.default_rng(int(hi))
    q = rng.uniform(lo, hi, size=(2, 64, 8)).astype(np.float32)
    before = e8_lookup.lram_query.launches
    idx, w = e8_lookup.lram_query(torch.from_numpy(q), SPEC, 32)
    assert e8_lookup.lram_query.launches == before
    jidx, jw = j_e8.lram_query_pallas(jnp.asarray(q), J_SPEC, 32,
                                      interpret=True)
    assert idx.shape == w.shape == (2, 64, 32) and idx.dtype == torch.int32
    # descending weights, as the kernel emits them
    assert (w[..., :-1] >= w[..., 1:]).all()
    np.testing.assert_allclose(np.sort(w.numpy(), -1),
                               np.sort(np.asarray(jw), -1), atol=1e-5)
    values = rng.normal(size=(SPEC.num_locations, 16)).astype(np.float32)
    out = gather_interp.gather_interp_plain(torch.from_numpy(values),
                                            idx, w).numpy()
    jout = j_gather.gather_interp_pallas(jnp.asarray(values), jidx, jw,
                                         interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=2e-5, atol=1e-5)


def test_lram_query_interpolates_lattice_points():
    """phi(k) = v_k: a query on a lattice point gets weight 1 on it."""
    targets = np.array([7, 999, 2**15])
    pts = indexing.decode_index(targets, SPEC).astype(np.float32)
    idx, w = e8_lookup.lram_query(torch.from_numpy(pts), SPEC)
    np.testing.assert_array_equal(idx[:, 0].numpy(), targets)
    np.testing.assert_allclose(w[:, 0].numpy(), 1.0)
    np.testing.assert_allclose(w[:, 1:].numpy(), 0.0)


@pytest.mark.parametrize("cell,item", [
    (dict(interp_impl="tiered", tiered=TieredSpec(backing="mmap")), "A8"),
    (dict(interp_impl="sharded"), "needs an ambient mesh"),
])
def test_unported_cells_raise(cell, item):
    with pytest.raises(lookup.LookupPlanError, match=item):
        lookup.resolve(LRAMConfig(log2_locations=16, **cell))


def test_plans_name_their_kernels():
    pallas = lookup.resolve(LRAMConfig(interp_impl="pallas"))
    assert pallas.query is e8_lookup.lram_query
    assert lookup.kernel_gather("pallas", "fp32") \
        is gather_interp.gather_interp
    assert lookup.kernel_gather("pallas", "quant") \
        is gather_interp.gather_interp_quant
    assert lookup.kernel_gather("pallas", "tiered") \
        is tiered_gather.tiered_gather
    assert lookup.kernel_gather("pallas", "tiered-quant") \
        is tiered_gather.tiered_gather_quant
    assert lookup.resolve(LRAMConfig()).cell == ("dense", "fp32",
                                                 "reference")
    assert lookup.resolve(LRAMConfig(interp_impl="pallas",
                                     table_quant="fp8")).cell \
        == ("dense", "fp8", "pallas")


@pytest.mark.parametrize("top_k", [32, 8])
def test_lram_query_plain_matches_pallas_on_ties(top_k):
    """The tie rule: on `lattice.tie_queries` (exact dyadic distances, so
    equal weights are exact ties, most of them at the top-32's cut) K2's
    plain version equals lram_query_pallas (interpret) exactly, weights
    and raw indices: equal weights keep the lower candidate first.  The
    CUDA kernel is held to the plain version bit for bit on the card."""
    q = lattice.tie_queries(256, SPEC.K, seed=top_k)
    idx, w = e8_lookup.lram_query(torch.from_numpy(q), SPEC, top_k)
    jidx, jw = j_e8.lram_query_pallas(jnp.asarray(q), J_SPEC, top_k,
                                      interpret=True)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # the rule is exercised: a share of the queries (all at top-32, a
    # quarter at top-8) have exact ties inside their top-k
    assert (w[:, 1:] == w[:, :-1]).any(-1).float().mean() >= 0.2


def test_build_keeps_nvcc_output_beside_the_library(tmp_path):
    """A library built once reports nvcc's output (each kernel's registers
    and spills) again when a later process finds it built."""
    from repro_torch.kernels import _build

    class Done:  # a finished nvcc
        returncode = 0

        def communicate(self):
            return "ptxas info    : Used 64 registers", None

    out, tmp = tmp_path / "libk-0.so", tmp_path / "libk-0.tmp"
    tmp.write_bytes(b"")
    _build._finish("k", out, tmp, Done())
    assert out.exists() and not tmp.exists()
    _build.build_log.pop("k")
    _build._finish("k", out, None, None)  # found built
    assert _build.build_log.pop("k") == "ptxas info    : Used 64 registers"
    _build._finish("k", tmp_path / "libk-1.so", None, None)
    assert _build.build_log.pop("k") == "(cached build)"
