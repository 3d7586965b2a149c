"""Port parity: the tiered store (`repro_torch.memstore`), kernels B5/B6'
plain versions and the tiered serving path, against the JAX package.

B5/B6's plain versions are held against the Pallas kernels in interpret
mode; a port store and a JAX store fed the same table and the same index
sequence must agree in every stat, in their resident shards and (to 1e-6)
in every gather; the smoke `lram-tiered` engine on converted weights must
give the JAX engine's tokens and cache summary exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import memstore as j_memstore
from repro.kernels import tiered_gather as j_tiered
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs, quant
from repro_torch.core import lookup
from repro_torch.kernels import tiered_gather
from repro_torch.launch import convert
from repro_torch.memstore import TieredSpec, TieredValueStore
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

QUANTS = ("none", "int8", "fp8")
STAT_KEYS = ("lookups", "hits", "misses", "uncached", "fills", "evictions",
             "fill_bytes")


def _port_payload(q: np.ndarray) -> np.ndarray:
    """A reference payload in the port's host form (fp8 as uint8 bytes)."""
    return q if q.dtype == np.int8 else q.view(np.uint8)


def _reference_table(store) -> dict | np.ndarray:
    """The reference store's table as the converter takes it, read shard by
    shard from its host tier."""
    shards = range(store.num_shards)
    payload = np.concatenate([store.shard_host(i) for i in shards])
    if store.quant == "none":
        return payload
    return {"q": _port_payload(payload),
            "scale": np.concatenate([store.shard_scale_host(i)
                                     for i in shards])}


def _cache_and_slots(rng, quant_kind, slots=4, shard_rows=64, shards=16,
                     m=64, top_k=32):
    rows = rng.normal(size=(slots * shard_rows, m)).astype(np.float32)
    slot_table = np.full(shards, -1, np.int32)
    resident = rng.choice(shards, size=slots, replace=False)
    slot_table[resident] = rng.permutation(slots)
    gid = (rng.choice(resident, size=(6, top_k)) * shard_rows
           + rng.integers(0, shard_rows, size=(6, top_k))).astype(np.int32)
    w = rng.uniform(0, 1, size=gid.shape).astype(np.float32)
    if quant_kind == "none":
        return rows, None, slot_table, gid, w
    q, s = quant.quantize_rows_np(rows, quant_kind)
    return q, s, slot_table, gid, w


@pytest.mark.parametrize("quant_kind", QUANTS)
@pytest.mark.parametrize("m,top_k", [(64, 32), (8, 32), (7, 20)])
def test_tiered_gather_plain_matches_pallas(m, top_k, quant_kind):
    """B5 (fp32) and B6 (int8, fp8) plain versions against
    tiered_gather[_quant]_pallas in interpret mode, rtol 2e-5 / atol 1e-6,
    at the layouts between which the CUDA kernels choose: full rows at
    top-32 (B6 with the wide loads), 8 columns (wide on 8-byte words), and
    7 columns at top-20 (single bytes, a split that leaves warps short)."""
    rng = np.random.default_rng(1)
    cache, scale, slot_table, gid, w = _cache_and_slots(rng, quant_kind, m=m,
                                                        top_k=top_k)
    tw, tg, ts = (torch.from_numpy(w), torch.from_numpy(gid),
                  torch.from_numpy(slot_table))
    if scale is None:
        got = tiered_gather.tiered_gather(
            torch.from_numpy(cache), tg, ts, tw, shard_rows=64,
            resident=True)
        want = j_tiered.tiered_gather_pallas(
            jnp.asarray(cache), jnp.asarray(gid), jnp.asarray(slot_table),
            jnp.asarray(w), shard_rows=64, interpret=True)
    else:
        got = tiered_gather.tiered_gather_quant(
            quant.as_torch_payload(cache), torch.from_numpy(scale), tg, ts,
            tw, shard_rows=64, resident=True)
        jq = cache if quant_kind == "int8" else \
            cache.view(jnp.float8_e4m3fn)
        want = j_tiered.tiered_gather_quant_pallas(
            jnp.asarray(jq), jnp.asarray(scale), jnp.asarray(gid),
            jnp.asarray(slot_table), jnp.asarray(w), shard_rows=64,
            interpret=True)
    assert got.shape == (6, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-6)


def test_tiered_gather_refuses_rows_that_are_not_resident():
    rng = np.random.default_rng(2)
    cache, _, slot_table, gid, w = _cache_and_slots(rng, "none")
    with pytest.raises(ValueError, match="not resident"):
        tiered_gather.tiered_gather(
            torch.from_numpy(cache), torch.from_numpy(gid),
            torch.from_numpy(slot_table), torch.from_numpy(w),
            shard_rows=64, resident=False)


@pytest.mark.parametrize("quant_kind", QUANTS)
def test_store_matches_reference_store(quant_kind):
    """The same table and index sequence through a port store and a JAX
    store (both on the kernel cell): equal stats and resident shards after
    every step, gathers to 1e-6, through hits, misses, an overflow batch,
    prefetch_last and prefetch."""
    rng = np.random.default_rng(3)
    dense = (rng.normal(size=(16 * 64, 64)) * 0.02).astype(np.float32)
    kw = dict(shard_rows=64, cache_slots=4, use_pallas=True,
              quant=quant_kind)
    j_store = j_memstore.TieredValueStore.from_dense(
        dense, j_memstore.TieredSpec(**kw))
    table = _reference_table(j_store)
    spec = TieredSpec(**kw)
    store = (TieredValueStore.from_dense(table, spec) if quant_kind == "none"
             else TieredValueStore.from_payload(table["q"], table["scale"],
                                                spec))
    np.testing.assert_array_equal(store.to_dense(), j_store.to_dense())

    def batch(shards, n=4):
        return (np.asarray(shards)[rng.integers(0, len(shards), (n, 8))] * 64
                + rng.integers(0, 64, (n, 8))).astype(np.int32)

    def check():
        assert {k: store.stats[k] for k in STAT_KEYS} \
            == {k: j_store.stats[k] for k in STAT_KEYS}
        assert store.resident_shards() == j_store.resident_shards()
        assert store.hit_rate() == j_store.hit_rate()

    j_store.warm()
    store.warm()
    check()
    steps = [batch([0, 1, 2]),            # hits
             batch([3, 5, 6]),            # misses, evictions
             batch(list(range(8, 16)), 6),  # 8 shards > 4 slots: overflow
             "prefetch_last",
             batch([9, 12]),
             ("prefetch", batch([1, 2])),
             batch([1, 2, 12])]
    for step in steps:
        if isinstance(step, str):  # "prefetch_last"
            store.prefetch_last()
            j_store.prefetch_last()
        elif isinstance(step, tuple):
            store.prefetch(step[1])
            j_store.prefetch(step[1])
        else:
            w = rng.uniform(0, 1, size=step.shape).astype(np.float32)
            got = store.gather(torch.from_numpy(step), torch.from_numpy(w))
            want = j_store.gather(step, w)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
        check()
    assert store.stats["uncached"] > 0 and store.stats["evictions"] > 0
    assert store.bytes_per_entry() == j_store.bytes_per_entry()


def test_tiered_cells_resolve():
    """auto -> pallas on the tiered placement (both archs), the spec folds
    in the storage and kernel, reference is CPU-only plain, and the
    unported and conflicting cells raise."""
    cfg = configs.get_smoke_config("lram-tiered").lram
    plan = lookup.resolve(cfg)
    assert plan.cell == ("tiered", "fp32", "pallas")
    assert plan.supports_prefetch
    q8 = configs.get_smoke_config("lram-tiered-q8").lram
    assert lookup.resolve(q8).cell == ("tiered", "int8", "pallas")
    spec = lookup.merged_tiered_spec(q8, "int8", "pallas")
    assert (spec.quant, spec.use_pallas) == ("int8", True)
    ref = dataclasses.replace(cfg, lookup_kernel="reference")
    assert lookup.resolve(ref).cell == ("tiered", "fp32", "reference")
    with pytest.raises(lookup.LookupPlanError, match="conflicts"):
        lookup.resolve(dataclasses.replace(q8, table_quant="fp8"))
    with pytest.raises(lookup.LookupPlanError, match="A12"):
        lookup.resolve(cfg, "sharded-tiered")


def test_reference_cell_store_matches_kernel_cell():
    """The tiered reference cell (plain gathers, CPU only) and the kernel
    cell's plain versions give the same gathers from the same table."""
    rng = np.random.default_rng(4)
    dense = rng.normal(size=(8 * 64, 16)).astype(np.float32)
    idx = torch.from_numpy(rng.integers(0, 512, (5, 8)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0, 1, (5, 8)).astype(np.float32))
    outs = [TieredValueStore.from_dense(dense, TieredSpec(
        shard_rows=64, cache_slots=slots, use_pallas=use_pallas))
        .gather(idx, w) for slots in (2, 8) for use_pallas in (False, True)]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=1e-6, atol=1e-6)


def _numpy_tree(tree):
    """The reference's params with every array as numpy and every tiered
    store as the table the converter takes."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, j_memstore.TieredValueStore):
        return _reference_table(tree)
    return np.asarray(tree)


@pytest.mark.parametrize("arch", ["lram-tiered", "lram-tiered-q8"])
def test_engine_matches_reference_engine(arch):
    """The smoke engine on converted weights, both on their tiered
    placement: the JAX engine's greedy tokens, first logits to 1e-4, and
    its cache summary (hit rate, hits, misses, uncached, fills,
    evictions) and per-request hit rates exactly."""
    j_cfg = j_configs.get_smoke_config(arch)
    params, state = j_tf.init(jax.random.PRNGKey(0), j_cfg)
    model = convert.model_from_jax(_numpy_tree(params), _numpy_tree(state),
                                   configs.get_smoke_config(arch),
                                   device="cpu")
    kw = dict(vocab_size=256, max_prompt=9, max_gen=5)
    j_rep = JServeEngine(params, state, j_cfg, JEngineConfig(
        slots=2, max_len=14)).run(
            j_synthetic_trace(np.random.default_rng(4), 4, **kw))
    rep = ServeEngine(model, EngineConfig(slots=2, max_len=14)).run(
        synthetic_trace(np.random.default_rng(4), 4, **kw))
    assert [r.tokens for r in rep.requests] == \
        [r.tokens for r in j_rep.requests]
    for a, b in zip(rep.requests, j_rep.requests):
        np.testing.assert_allclose(a.first_logits, b.first_logits,
                                   atol=1e-4)
    assert rep.cache == j_rep.cache
    assert rep.cache["uncached"] > 0  # the smoke cache overflows
    assert [r.cache_hit_rate for r in rep.requests] == \
        [r.cache_hit_rate for r in j_rep.requests]


def test_tiered_and_dense_placements_agree():
    """Placement changes where the table lives, not the output: the same
    seed's weights served from the tiered store and from a dense table
    give the same first logits (1e-5) and tokens."""
    kw = dict(vocab_size=256, max_prompt=9, max_gen=4)
    reports = []
    for placement in ("tiered", "pallas"):
        cfg = configs.get_smoke_config("lram-tiered")
        cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, interp_impl=placement))
        model = transformer.init(cfg, seed=0)
        reports.append(ServeEngine(model, EngineConfig(slots=2, max_len=13))
                       .run(synthetic_trace(np.random.default_rng(2), 3,
                                            **kw)))
    tiered, dense = reports
    assert tiered.cache is not None and dense.cache is None
    for a, b in zip(tiered.requests, dense.requests):
        assert a.tokens == b.tokens
        np.testing.assert_allclose(a.first_logits, b.first_logits,
                                   atol=1e-5)
