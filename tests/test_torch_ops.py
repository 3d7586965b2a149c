"""Port parity: the differentiable lookup (`ops.lram_lookup`, B3, and its
row-source form for 1-byte and tiered tables), the gathers' VJPs
(`gather_interp_vjp`, B1; `gather_interp_quant_vjp`, B4), the backward's
instances without scatter, the integer inverse of the torus index, the
torus map's gradients, and the memory layer's gradients in every cell
that trains: dense fp32 (both kernel cells), dense int8 / fp8 (frozen
table) and tiered fp32 / int8 (write-back).

On the CPU the backward kernel's wrapper takes `lookup_bwd_plain`; the
kernel itself is held against it on the card by `test_torch_cuda.py`.
Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import memstore as j_memstore
from repro import quant as j_quant
from repro.core import indexing as j_indexing
from repro.core import lram as j_lram
from repro.core import torus as j_torus
from repro.kernels import gather_interp as j_gather
from repro.kernels import ops as j_ops
from repro_torch import quant
from repro_torch.core import indexing, lram, torus
from repro_torch.kernels import gather_interp, ops
from repro_torch.launch.convert import _flatten
from repro_torch.memstore import TieredSpec, TieredValueStore

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


def _port_payload(q) -> np.ndarray:
    """A reference payload in the port's host form (fp8 as uint8 bytes)."""
    q = np.array(q)  # a writable copy
    return q if q.dtype == np.int8 else q.view(np.uint8)


def _quant_inputs(kind: str, seed: int):
    """A table quantized by the reference, its dequantized rows, and a
    flat table of shuffled rows with each index's row in it (the layout a
    tiered store's flat route hands the backward)."""
    values, q, g = _lookup_inputs(seed, n=30)
    j_table = j_quant.QuantizedTable.from_dense(values, kind)
    payload, scale = np.asarray(j_table.q), np.asarray(j_table.scale)
    j_idx, j_w = j_lram.indices_and_weights(jnp.asarray(q), J_SPEC, 32)
    idx, w = np.asarray(j_idx), np.asarray(j_w)
    perm = np.random.default_rng(seed).permutation(SPEC.num_locations)
    inv = np.argsort(perm)
    return (values, q, g, j_table, payload, scale, idx, w,
            perm, inv[idx].astype(np.int32))


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_lookup_bwd_quant_plain_matches_jax(kind):
    """The 1-byte instances' plain versions (`lookup_bwd_plain` with
    scale, no scatter) against the reference's backwards: dw against B4's
    VJP (`gather_interp_quant`'s `_quant_bwd`, row 8 exactly) to rtol 1e-5
    / atol 1e-6, the same over shuffled rows, and dq against B3's on the
    dequantized table to rtol 1e-4 / atol 1e-5 (the scale multiplies the
    dot here, the row there: float32 rounding)."""
    (_, q, g, j_table, payload, scale, idx, w, perm,
     rows) = _quant_inputs(kind, 3)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tq = quant.as_torch_payload(_port_payload(payload))
    _, _, _, j_dw = j_gather._quant_bwd(
        True, (j_table.q, j_table.scale, jnp.asarray(idx), jnp.asarray(w)),
        jnp.asarray(g))
    dw = ops.lookup_bwd_quant(tq, t(scale), t(idx), t(w), t(g))
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=1e-5,
                               atol=1e-6)
    dw_rows = ops.lookup_bwd_quant(tq[t(perm)], t(scale[perm]), t(rows),
                                   t(w), t(g))
    np.testing.assert_array_equal(dw_rows.numpy(), dw.numpy())
    res = (j_table.dequantize(), jnp.asarray(q), jnp.asarray(idx),
           jnp.asarray(w))
    _, j_dq = j_ops._lookup_bwd(J_SPEC, 32, False, True, res, jnp.asarray(g))
    dq = ops.lookup_bwd_quant(tq[t(perm)], t(scale[perm]), t(rows), t(w),
                              t(g), idx=t(idx), q=t(q), spec=SPEC)
    np.testing.assert_allclose(dq.numpy(), np.asarray(j_dq), rtol=1e-4,
                               atol=1e-5)
    assert ops.lookup_bwd_quant.launches == 0  # CPU: the plain version


def test_lookup_bwd_rows_plain_matches_jax():
    """The fp32 instances without scatter (a tiered store's flat route)
    over shuffled rows against the reference's backwards on the dense
    table: dq against B3's to rtol 1e-4 / atol 1e-5, dw against B1's VJP
    to 1e-5, and both equal to the scatter instances' plain dq / dw."""
    (values, q, g, _, _, _, idx, w, perm, rows) = _quant_inputs("int8", 4)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    res = tuple(jnp.asarray(a) for a in (values, q, idx, w))
    _, j_dq = j_ops._lookup_bwd(J_SPEC, 32, False, True, res, jnp.asarray(g))
    _, _, j_dw = j_gather._vjp_bwd(True, res[:1] + res[2:], jnp.asarray(g))
    flat = t(values[perm])
    dq = ops.lookup_bwd_rows(flat, t(rows), t(w), t(g), idx=t(idx), q=t(q),
                             spec=SPEC)
    dw = ops.lookup_bwd_rows(flat, t(rows), t(w), t(g))
    np.testing.assert_allclose(dq.numpy(), np.asarray(j_dq), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=1e-5,
                               atol=1e-5)
    _, dq_dense = ops.lookup_bwd(t(values), t(idx), t(w), t(g), q=t(q),
                                 spec=SPEC)
    _, dw_dense = ops.lookup_bwd(t(values), t(idx), t(w), t(g))
    torch.testing.assert_close(dq, dq_dense, rtol=0, atol=0)
    torch.testing.assert_close(dw, dw_dense, rtol=0, atol=0)
    assert ops.lookup_bwd_rows.launches == 0


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_gather_interp_quant_vjp_matches_pallas_vjp(kind):
    """gather_interp_quant_vjp against the reference's gather_interp_quant
    (the Pallas gather in interpret mode, its dw-only custom VJP): out and
    dw to 1e-5; the table gets no gradient."""
    rng = np.random.default_rng(8)
    j_table = j_quant.QuantizedTable.from_dense(
        rng.normal(size=(64, 8)).astype(np.float32), kind)
    idx = rng.integers(0, 64, size=(2, 3, 4)).astype(np.int32)
    w = rng.uniform(size=(2, 3, 4)).astype(np.float32)
    g = rng.normal(size=(2, 3, 8)).astype(np.float32)
    j_out, j_vjp = jax.vjp(
        lambda ww: j_gather.gather_interp_quant(
            j_table.q, j_table.scale, jnp.asarray(idx), ww, True),
        jnp.asarray(w))
    (j_dw,) = j_vjp(jnp.asarray(g))
    tq = quant.as_torch_payload(_port_payload(j_table.q))
    ts = torch.from_numpy(np.array(j_table.scale))
    tw = torch.from_numpy(w).requires_grad_()
    out = gather_interp.gather_interp_quant_vjp(tq, ts, torch.from_numpy(idx),
                                                tw)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_dw), atol=1e-5)
    assert ts.grad is None


def _qnorm_state(layer, params, state):
    sd = _flatten(jax.tree.map(np.asarray, {
        k: v for k, v in params.items() if k != "values"}))
    sd.update(_flatten(jax.tree.map(np.asarray, state)))
    missing, unexpected = layer.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=False)
    assert not unexpected


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(SPEC.num_locations, 64)) * 0.5).astype(
        np.float32)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    g = rng.normal(size=(3, 5, 128)).astype(np.float32)
    return table, x, g


def _port_grad(layer, x, g):
    tx = torch.from_numpy(x).requires_grad_()
    y = lram.lram_apply(layer, tx, train=True)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), tx.grad.numpy()


def _jax_grad(params, state, x, g, j_cfg):
    def j_loss(xx):
        y, _ = j_lram.lram_apply(params, state, xx, j_cfg, train=True)
        return jnp.sum(y * g), y

    (_, j_y), j_gx = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(x))
    return np.asarray(j_y), np.asarray(j_gx)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_dense_quantized_lram_apply_gradients_match_jax(kind):
    """The dense 1-byte cell (frozen table) in train mode: y and dL/dx of
    the port's pallas cell (the joined lookup over the table's own rows,
    dq from the 1-byte backward's plain version) against jax.grad of the
    reference's pallas cell (`gather_interp_quant` in interpret mode, its
    dw-only VJP, autodiff through the weights): y to 1e-5, dx to rtol 1e-4
    / atol 1e-5.  The table gets no gradient."""
    table, x, g = _layer_inputs(9)
    kw = dict(log2_locations=16, heads=2, query_norm="batch",
              interp_impl="pallas", table_quant=kind)
    j_cfg, cfg = j_lram.LRAMConfig(**kw), lram.LRAMConfig(**kw)
    params, state = j_lram.lram_init(jax.random.PRNGKey(9), j_cfg)
    params["values"] = j_quant.QuantizedTable.from_dense(table, kind)
    layer = lram.LRAM(cfg)
    _qnorm_state(layer, params, state)
    layer.values = quant.QuantizedTable.from_payload(
        _port_payload(params["values"].q), np.asarray(params["values"].scale),
        kind)
    j_y, j_gx = _jax_grad(params, state, x, g, j_cfg)
    y, gx = _port_grad(layer, x, g)
    np.testing.assert_allclose(y, j_y, atol=1e-5)
    np.testing.assert_allclose(gx, j_gx, rtol=1e-4, atol=1e-5)
    assert np.abs(j_gx).max() > 1e-2
    assert all(b.grad is None for b in layer.values.buffers())


@pytest.mark.parametrize("slots", [2, 16], ids=["overflow", "resident"])
@pytest.mark.parametrize("kind", ["none", "int8"])
def test_tiered_lram_apply_gradients_and_writeback_match_jax(kind, slots):
    """The tiered cells in train mode, with a cache that overflows (2 of 16
    shards) and one that holds every shard: y and dL/dx of the port's
    joined lookup (K2, the flat route, dq from the backward's plain
    version, then the write-back) against jax.grad of the reference's
    traced tiered lookup (io_callback forward and write-back): y to 1e-5,
    dx to rtol 1e-4 / atol 1e-5.  After the one write-back each: the
    stats (the reference's traced forward never uploads, so fill bytes
    are left out) and dirty sets equal, and the tables to atol 1e-6 (fp32)
    or rtol 1e-6 (int8: w ⊗ g differs in float32 rounding, which may move
    a fresh scale by its last bit)."""
    table, x, g = _layer_inputs(10)
    spec_kw = dict(shard_rows=4096, cache_slots=slots, quant=kind)
    kw = dict(log2_locations=16, heads=2, query_norm="batch",
              interp_impl="tiered")
    j_cfg = j_lram.LRAMConfig(**kw, tiered=j_memstore.TieredSpec(**spec_kw))
    cfg = lram.LRAMConfig(**kw, tiered=TieredSpec(**spec_kw))
    params, state = j_lram.lram_init(jax.random.PRNGKey(10), j_cfg)
    j_store = j_memstore.TieredValueStore.from_dense(
        table, j_memstore.TieredSpec(**spec_kw))
    params["values"] = j_store
    layer = lram.LRAM(cfg)
    _qnorm_state(layer, params, state)
    spec = layer.values.spec
    if kind == "none":
        layer.values = TieredValueStore.from_dense(table, spec)
    else:
        layer.values = TieredValueStore.from_payload(
            np.asarray(j_store._host).reshape(table.shape),
            np.asarray(j_store._host_scale).reshape(-1), spec)
    store = layer.values
    j_store.writeback_lr = store.writeback_lr = 0.5
    before = store.to_dense()
    j_y, j_gx = _jax_grad(params, state, x, g, j_cfg)
    y, gx = _port_grad(layer, x, g)
    np.testing.assert_allclose(y, j_y, atol=1e-5)
    np.testing.assert_allclose(gx, j_gx, rtol=1e-4, atol=1e-5)
    keys = set(j_store.stats) - {"fill_bytes"}
    assert {k: store.stats[k] for k in keys} == \
        {k: j_store.stats[k] for k in keys}
    assert store.stats["writebacks"] == 1
    assert (store.stats["uncached"] > 0) == (slots == 2)
    assert store._dirty == j_store._dirty
    after = store.to_dense()
    assert not np.array_equal(after, before)
    if kind == "none":
        np.testing.assert_allclose(after, j_store.to_dense(), atol=1e-6)
    else:
        np.testing.assert_allclose(after, j_store.to_dense(), rtol=1e-6,
                                   atol=0)


def test_tiered_lookup_without_grad_writes_nothing():
    """Under no_grad (serving, evaluate) the tiered lookup is the store's
    eager gather: the same output as the training route, no write-back."""
    table, x, _ = _layer_inputs(11)
    cfg = lram.LRAMConfig(log2_locations=16, heads=2, query_norm="rms",
                          interp_impl="tiered",
                          tiered=TieredSpec(shard_rows=4096, cache_slots=16))
    layer = lram.LRAM(cfg)
    layer.values = TieredValueStore.from_dense(table, layer.values.spec)
    layer.values.writeback_lr = 1.0
    with torch.no_grad():
        y0 = lram.lram_apply(layer, torch.from_numpy(x))
    tx = torch.from_numpy(x).requires_grad_()
    y1 = lram.lram_apply(layer, tx)
    assert layer.values.stats["writebacks"] == 0
    torch.testing.assert_close(y1.detach(), y0, rtol=1e-6, atol=1e-6)
    y1.sum().backward()
    assert layer.values.stats["writebacks"] == 1
