"""Port parity: the tiered store's training write-back and the codec's
stochastic rounding (`repro_torch.memstore.store`, `repro_torch.quant`),
against the JAX package.

The same numpy (index, w ⊗ g) sequence goes to the reference's
`TieredValueStore.apply_writeback` and the port's, with fills, evictions
of dirty slots and overflow batches between them.  Both draw stochastic
rounding from `np.random.default_rng(0)` in the same order, so payloads,
scales, the cache mirrors and `to_dense()` are compared bit for bit, and
the stats and dirty sets exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import memstore as j_memstore
from repro import quant as j_quant
from repro_torch import quant
from repro_torch.memstore import TieredSpec, TieredValueStore, tiered_interp

QUANTS = ("none", "int8", "fp8")
ROWS, SHARD_ROWS, M = 16 * 64, 64, 8


def _pair(quant_kind, *, slots=4, seed=0):
    """A reference store and a port store holding the same table."""
    rng = np.random.default_rng(seed)
    dense = (rng.normal(size=(ROWS, M)) * 0.02).astype(np.float32)
    kw = dict(shard_rows=SHARD_ROWS, cache_slots=slots, quant=quant_kind)
    j_store = j_memstore.TieredValueStore.from_dense(
        dense, j_memstore.TieredSpec(**kw))
    spec = TieredSpec(**kw)
    if quant_kind == "none":
        store = TieredValueStore.from_dense(dense, spec)
    else:
        payload = np.asarray(j_store._host).reshape(ROWS, M)
        if quant_kind == "fp8":
            payload = payload.view(np.uint8)
        store = TieredValueStore.from_payload(
            payload, np.asarray(j_store._host_scale).reshape(ROWS), spec)
    return rng, j_store, store


def _bits(a: np.ndarray) -> np.ndarray:
    """The raw bytes of an array (fp8 and uint8 payloads compare alike)."""
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_same_state(j_store, store):
    assert store.stats == j_store.stats
    assert store._dirty == j_store._dirty
    assert store.resident_shards() == j_store.resident_shards()
    np.testing.assert_array_equal(_bits(store._host), _bits(j_store._host))
    np.testing.assert_array_equal(_bits(store.cache_np),
                                  _bits(j_store.cache_np))
    if store.quant != "none":
        np.testing.assert_array_equal(store._host_scale,
                                      j_store._host_scale)
        np.testing.assert_array_equal(store.cache_scale_np,
                                      j_store.cache_scale_np)


@pytest.mark.parametrize("quant_kind", QUANTS)
def test_writeback_matches_reference_store(quant_kind):
    """Lookups and write-backs interleaved (4 slots, 16 shards): hits,
    misses that evict dirty slots, an overflow batch whose update lands
    partly on the host tier, a prefetch and duplicate indices.  After
    every step the stats (fill bytes included), dirty sets, resident
    shards, host tier and cache mirror are equal bit for bit; then
    `to_dense()` (which flushes) and the flush count."""
    rng, j_store, store = _pair(quant_kind)
    j_store.writeback_lr = store.writeback_lr = 0.5

    def batch(shards, n=4):
        return (np.asarray(shards)[rng.integers(0, len(shards), (n, 8))]
                * SHARD_ROWS + rng.integers(0, SHARD_ROWS, (n, 8))
                ).astype(np.int32)

    j_store.warm()
    store.warm()
    _assert_same_state(j_store, store)
    steps = [("gather", batch([0, 1, 2])),
             ("writeback", batch([0, 1, 2])),
             ("gather", batch([3, 5, 6])),        # evicts dirty slots
             ("writeback", batch([3, 5, 9, 10])),  # 9, 10 on the host
             ("gather", batch(list(range(8, 16)), 6)),  # overflow
             ("writeback", batch(list(range(8, 16)), 6)),
             ("prefetch", batch([1, 2])),
             ("writeback", np.full((3, 8), 70, np.int32)),  # duplicates
             ("gather", batch([1, 2, 12]))]
    for kind, idx in steps:
        if kind == "gather":
            w = rng.uniform(0, 1, size=idx.shape).astype(np.float32)
            got = store.gather(torch.from_numpy(idx), torch.from_numpy(w))
            want = j_store.gather(idx, w)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        elif kind == "prefetch":
            store.prefetch(idx)
            j_store.prefetch(idx)
        else:
            wg = rng.normal(size=idx.shape + (M,)).astype(np.float32)
            store.apply_writeback(idx, wg)
            j_store.apply_writeback(idx, wg)
        _assert_same_state(j_store, store)
    assert store.stats["evictions"] > 0 and store.stats["uncached"] > 0
    assert store.stats["dirty_writebacks"] > 0  # dirty slots were evicted
    dirty = len(store._dirty)
    assert dirty > 0
    before = store.stats["dirty_writebacks"]
    np.testing.assert_array_equal(_bits(store.to_dense()),
                                  _bits(j_store.to_dense()))
    assert store.stats["dirty_writebacks"] == before + dirty
    _assert_same_state(j_store, store)


@pytest.mark.parametrize("quant_kind", QUANTS)
def test_flush_writes_every_dirty_slot(quant_kind):
    """flush() copies each dirty slot to its host shard, counts one dirty
    write-back per slot and leaves nothing dirty; a second flush is free."""
    rng, _, store = _pair(quant_kind)
    store.writeback_lr = 0.1
    store.warm()
    idx = rng.integers(0, 4 * SHARD_ROWS, size=(6, 8)).astype(np.int32)
    store.apply_writeback(idx, rng.normal(size=(6, 8, M)).astype(
        np.float32))
    dirty = set(store._dirty)
    assert dirty
    store.flush()
    assert not store._dirty
    assert store.stats["dirty_writebacks"] == len(dirty)
    for slot in dirty:
        shard = store._slot_shard[slot]
        np.testing.assert_array_equal(_bits(store._host[shard]),
                                      _bits(store.cache_np[slot]))
    store.flush()
    assert store.stats["dirty_writebacks"] == len(dirty)


def test_writeback_is_off_at_zero_rate():
    """writeback_lr = 0 (the default) leaves table and stats untouched, as
    the reference does."""
    rng, _, store = _pair("int8")
    store.warm()
    before = store.to_dense()
    idx = rng.integers(0, ROWS, size=(4, 8)).astype(np.int32)
    store.apply_writeback(idx, np.ones((4, 8, M), np.float32))
    store.writeback(torch.from_numpy(idx), torch.ones(4, 8),
                    torch.ones(4, M))
    assert store.stats["writebacks"] == 0 and not store._dirty
    np.testing.assert_array_equal(store.to_dense(), before)


def test_writeback_sink_forms_the_reference_product():
    """`writeback(idx, w, g)` applies w ⊗ g formed on the host: the same
    table as `apply_writeback` given w[..., None] * g[..., None, :]."""
    rng, _, a = _pair("none")
    _, _, b = _pair("none")
    for s in (a, b):
        s.writeback_lr = 0.3
        s.warm()
    idx = rng.integers(0, ROWS, size=(5, 8)).astype(np.int32)
    w = rng.uniform(size=(5, 8)).astype(np.float32)
    g = rng.normal(size=(5, M)).astype(np.float32)
    a.writeback(torch.from_numpy(idx), torch.from_numpy(w),
                torch.from_numpy(g))
    b.apply_writeback(idx, w[..., None] * g[..., None, :])
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())


@pytest.mark.parametrize("axis", [None, -1])
def test_stochastic_rounding_matches_reference(axis):
    """quantize_int8 with an rng: the same payload and scales as the
    reference's from the same generator seed, and its own draws."""
    x = (np.random.default_rng(1).normal(size=(33, 16)) * 0.05).astype(
        np.float32)
    got = quant.quantize_int8(x, axis=axis, rng=np.random.default_rng(5))
    want = j_quant.quantize_int8(x, axis=axis, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    nearest = quant.quantize_int8(x, axis=axis)[0]
    assert np.abs(got[0].astype(int) - nearest).max() == 1
    assert (got[0] != nearest).any()


def test_fp8_ignores_the_rng():
    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    a = quant.quantize_rows_np(x, "fp8", rng=np.random.default_rng(0))
    b = quant.quantize_rows_np(x, "fp8")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_quantized_writeback_unbiased_in_expectation():
    """The reference's tests/test_quant.py unbiasedness test on the port:
    the same sub-quantum update applied across many rng seeds moves the
    mean stored value by ~the true update (nearest rounding would leave a
    small update invisible forever)."""
    rng = np.random.default_rng(0)
    row = (rng.normal(size=(1, 8)) * 0.02).astype(np.float32)
    upd = np.full((1, 8), 1e-5, np.float32)  # << one quantization step
    step = np.abs(row).max() / 127.0
    assert upd[0, 0] < step / 4
    before = quant.dequantize_rows_np(*quant.quantize_rows_np(row,
                                                              "int8"))[0]
    deltas = []
    for seed in range(300):
        store = TieredValueStore.from_dense(
            np.repeat(row, 256, axis=0),
            TieredSpec(shard_rows=256, cache_slots=1, quant="int8"),
        )
        store.writeback_lr = 1.0
        store._wb_rng = np.random.default_rng(seed)
        store.warm()
        store.apply_writeback(np.zeros((1,), np.int32), -upd)  # -= -upd
        deltas.append(store.to_dense()[0] - before)
    np.testing.assert_allclose(np.mean(deltas, axis=0), upd[0],
                               atol=step / 8)


@pytest.mark.parametrize("quant_kind", QUANTS)
def test_writeback_applies_sparse_sgd(quant_kind):
    """The reference's tests/test_memstore.py write-back test on the port,
    held against the reference itself: `tiered_interp` differentiable in w
    (dw from the backward kernel's plain version, then the write-back),
    one write-back, dirty slots, touched rows changed and the rest not;
    dw to 1e-5 and the table to atol 1e-6 (fp32) or rtol 1e-6 (1-byte) of
    jax.grad through the reference's tiered_interp on the same store.  The
    1-byte forwards round differently (B4 folds the scale into the weight,
    the reference dequantizes the row), so g, and with it a requantized
    row's fresh scale, may differ in the last bit."""
    rng, j_store, store = _pair(quant_kind)
    j_store.writeback_lr = store.writeback_lr = 0.1
    dense = store.to_dense()
    idx = rng.integers(0, ROWS, size=(16, 8)).astype(np.int32)
    w = rng.normal(size=idx.shape).astype(np.float32)

    tw = torch.from_numpy(w).requires_grad_()
    (tiered_interp(store, torch.from_numpy(idx), tw) ** 2).sum().backward()
    j_dw = jax.grad(lambda ww: jnp.sum(j_memstore.tiered_interp(
        j_store, jnp.asarray(idx), ww) ** 2))(jnp.asarray(w))
    assert torch.isfinite(tw.grad).all()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_dw),
                               rtol=1e-5, atol=1e-5)
    assert store.stats["writebacks"] == 1 and store._dirty
    after = store.to_dense()
    touched = np.zeros(ROWS, bool)
    touched[idx.reshape(-1)] = True
    assert not np.allclose(after[touched], dense[touched])
    np.testing.assert_array_equal(after[~touched], dense[~touched])
    if quant_kind == "none":
        np.testing.assert_allclose(after, j_store.to_dense(), atol=1e-6)
    else:
        np.testing.assert_allclose(after, j_store.to_dense(), rtol=1e-6,
                                   atol=0)
