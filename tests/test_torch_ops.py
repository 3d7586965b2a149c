"""Port parity: the differentiable lookup (`ops.lram_lookup`, B3), the
gather's VJP (`gather_interp_vjp`, B1), the integer inverse of the torus
index, the torus map's gradients, and the memory layer's gradients in
both kernel cells.

On the CPU the backward kernel's wrapper takes `lookup_bwd_plain`; the
kernel itself is held against it on the card by `test_torch_cuda.py`.
Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import indexing as j_indexing
from repro.core import lram as j_lram
from repro.core import torus as j_torus
from repro.kernels import gather_interp as j_gather
from repro.kernels import ops as j_ops
from repro_torch.core import indexing, lram, torus
from repro_torch.kernels import gather_interp, ops
from repro_torch.launch.convert import _flatten

SPEC, J_SPEC = indexing.choose_torus(16), j_indexing.choose_torus(16)


def _lookup_inputs(seed: int, n: int = 48, m: int = 8):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(SPEC.num_locations, m)).astype(np.float32)
    q = (rng.uniform(size=(n, 8)) * np.array(SPEC.K)).astype(np.float32)
    g = rng.normal(size=(n, m)).astype(np.float32)
    return values, q, g


@pytest.mark.parametrize("seed", [0, 1])
def test_lram_lookup_matches_jax(seed):
    """out and dvalues to 1e-5 (float32 sums in another order), dq to
    rtol = atol = 1e-4 (the tolerance at which the reference holds its own
    analytic dq against autodiff, tests/test_kernels.py)."""
    values, q, g = _lookup_inputs(seed)

    def j_loss(v, qq):
        out = j_ops.lram_lookup(v, qq, J_SPEC, 32, False)
        return jnp.sum(out * g), out

    (_, j_out), (j_dv, j_dq) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(values),
                                              jnp.asarray(q))
    tv = torch.from_numpy(values).requires_grad_()
    tq = torch.from_numpy(q).requires_grad_()
    out = ops.lram_lookup(tv, tq, SPEC, 32)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(j_dv), atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(j_dq), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(np.asarray(j_dq)).max() > 1e-2  # dq is not trivially 0


def test_lookup_bwd_plain_matches_jax_backward():
    """Both stages of the plain backward against the reference's own
    backward functions on the same residuals (idx, w from the reference's
    query): dvalues to 1e-5, dq and dw to 1e-5 / 1e-4."""
    values, q, g = _lookup_inputs(2, n=30)
    j_idx, j_w = j_lram.indices_and_weights(jnp.asarray(q), J_SPEC, 32)
    res = (jnp.asarray(values), jnp.asarray(q), j_idx, j_w)
    j_dv, j_dq = j_ops._lookup_bwd(J_SPEC, 32, False, True, res,
                                   jnp.asarray(g))
    args = [torch.from_numpy(np.array(a)) for a in
            (values, j_idx, j_w, g)]
    dv, dq = ops.lookup_bwd(*args, q=torch.from_numpy(q), spec=SPEC)
    np.testing.assert_allclose(dv.numpy(), np.asarray(j_dv), atol=1e-5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(j_dq), rtol=1e-4,
                               atol=1e-5)
    j_dv2, _, j_dw = j_gather._vjp_bwd(True, res[:1] + res[2:],
                                       jnp.asarray(g))
    dv2, dw = ops.lookup_bwd(*args)
    np.testing.assert_allclose(dv2.numpy(), np.asarray(j_dv2), atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=1e-5,
                               atol=1e-5)
    assert ops.lookup_bwd.launches == 0  # CPU: the plain version


def test_gather_interp_vjp_matches_pallas_vjp():
    """gather_interp_vjp against the reference's (the Pallas gather in
    interpret mode, so a tiny n): out, dvalues and dw to 1e-5."""
    rng = np.random.default_rng(3)
    values = rng.normal(size=(64, 8)).astype(np.float32)
    idx = rng.integers(0, 64, size=(2, 3, 4)).astype(np.int32)
    w = rng.uniform(size=(2, 3, 4)).astype(np.float32)
    g = rng.normal(size=(2, 3, 8)).astype(np.float32)
    j_out, j_vjp = jax.vjp(
        lambda v, ww: j_gather.gather_interp_vjp(v, jnp.asarray(idx), ww,
                                                 True),
        jnp.asarray(values), jnp.asarray(w))
    j_dv, j_dw = j_vjp(jnp.asarray(g))
    tv = torch.from_numpy(values).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = gather_interp.gather_interp_vjp(tv, torch.from_numpy(idx), tw)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(j_dv), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_dw), atol=1e-5)


@pytest.mark.parametrize("K", [(8,) * 8, (16, 16, 8, 8, 8, 8, 8, 8),
                               (32, 16, 16, 12, 8, 8, 8, 20)])
def test_points_from_indices_bit_equal(K):
    spec, j_spec = indexing.TorusSpec(K), j_indexing.TorusSpec(K)
    rng = np.random.default_rng(sum(K))
    idx = rng.integers(0, spec.num_locations, size=(7, 33)).astype(np.int32)
    idx[0, :3] = [0, 1, spec.num_locations - 1]
    got = ops.points_from_indices(torch.from_numpy(idx), spec).numpy()
    want = np.asarray(j_ops._points_from_indices(jnp.asarray(idx), j_spec))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # and they are the points the index names
    np.testing.assert_array_equal(got, indexing.decode_index(idx, spec))


def test_nearest_image_delta_matches():
    rng = np.random.default_rng(5)
    q = (rng.uniform(size=(9, 1, 8)) * 16).astype(np.float32)
    k = (rng.integers(0, 16, size=(9, 4, 8))).astype(np.float32)
    got = ops.nearest_image_delta(torch.from_numpy(q), torch.from_numpy(k),
                                  (16,) * 8).numpy()
    want = np.asarray(j_ops._nearest_image_delta(jnp.asarray(q),
                                                 jnp.asarray(k), (16,) * 8))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 8


def test_torus_map_gradients_match_and_stay_finite():
    """torus_map's value and gradients against jax.grad, with entries at
    |z| = 0, |z| ~ 1e-12 (below the safe threshold) and denormals: every
    gradient finite, equal to the reference's to 1e-5 relative."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    x[0, [0, 8]] = 0.0          # z = 0
    x[1, [1, 9]] = 1e-12        # |z|^2 below the 1e-20 threshold
    x[2, [2, 10]] = [1e-38, -1e-39]  # denormal parts, flushed
    x[3, 3] = 0.0               # on the real axis
    a = rng.normal(size=(5, 8)).astype(np.float32)
    b = rng.normal(size=(5, 1)).astype(np.float32)
    K = SPEC.K

    def j_f(xx):
        qq, sc = j_torus.torus_map(xx, K)
        return jnp.sum(qq * a) + jnp.sum(sc * b)

    j_val, j_grad = jax.value_and_grad(j_f)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    qq, sc = torus.torus_map(tx, K)
    val = (qq * torch.from_numpy(a)).sum() + (sc * torch.from_numpy(b)).sum()
    val.backward()
    assert torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_lram_apply_train_gradients_match_jax(impl):
    """The memory layer in train mode (batchnorm on batch statistics):
    y, running stats, d values, d x and the batchnorm parameters' grads
    against jax.grad of the reference's reference cell.  The port's pallas
    cell takes dq analytically (the backward kernel's plain version), its
    reference cell by plain autograd: both to rtol 1e-4 / atol 1e-5."""
    cfg = lram.LRAMConfig(log2_locations=16, heads=2, query_norm="batch",
                          interp_impl=impl)
    j_cfg = j_lram.LRAMConfig(log2_locations=16, heads=2,
                              query_norm="batch")
    params, state = j_lram.lram_init(jax.random.PRNGKey(7), j_cfg)
    rng = np.random.default_rng(7)
    params["values"] = jnp.asarray(
        rng.normal(size=(SPEC.num_locations, 64)).astype(np.float32))
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    g = rng.normal(size=(3, 5, 128)).astype(np.float32)

    def j_loss(p, xx):
        y, st = j_lram.lram_apply(p, state, xx, j_cfg, train=True)
        return jnp.sum(y * g), (y, st)

    (_, (j_y, j_st)), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    layer = lram.LRAM(cfg)
    sd = _flatten(jax.tree.map(np.asarray, params))
    sd.update(_flatten(jax.tree.map(np.asarray, state)))
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    tx = torch.from_numpy(x).requires_grad_()
    y = lram.lram_apply(layer, tx, train=True)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j_y),
                               atol=1e-5)
    np.testing.assert_allclose(layer.qnorm.mean.numpy(),
                               np.asarray(j_st["qnorm"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(layer.qnorm.var.numpy(),
                               np.asarray(j_st["qnorm"]["var"]), atol=1e-6)
    np.testing.assert_allclose(layer.values.grad.numpy(),
                               np.asarray(j_gp["values"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx), rtol=1e-4,
                               atol=1e-5)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(
            getattr(layer.qnorm, k).grad.numpy(),
            np.asarray(j_gp["qnorm"][k]), rtol=1e-4, atol=1e-5)
