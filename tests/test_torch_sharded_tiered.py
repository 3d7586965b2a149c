"""The `sharded-tiered` placement of the port
(`repro_torch.distributed.sharded_lram.ShardedTieredStore`, the
`lram-sharded-tiered` arch) against the JAX package's
`repro.distributed.sharded_lram.ShardedTieredStore` on the same tables:
the eager gather, the differentiable route's rows, the routed write-back
(int8 payloads bit for bit), stats without padding, store discovery, the
config, the refusals, checkpoints across sharded-tiered, tiered and dense
tables in both packages, and the smoke arch's forward and training
against JAX's on converted weights.  The port twins of
`tests/test_lookup_plan.py`'s sharded-tiered tests."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import data as j_data
from repro import memstore as j_memstore
from repro import optim as j_optim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import lookup as j_lookup
from repro.distributed.sharded_lram import ShardedTieredStore as JStore
from repro.launch import train as j_train
from repro.memstore import TieredSpec as JSpec
from repro.memstore import TieredValueStore as JTieredValueStore
from repro.models import transformer as j_tf
from repro_torch import configs, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import lookup
from repro_torch.core.lram import LRAMConfig
from repro_torch.distributed.sharded_lram import ShardedTieredStore
from repro_torch.kernels.gather_interp import gather_interp_plain
from repro_torch.launch import convert, train
from repro_torch.memstore import TieredSpec, TieredValueStore, tiered_interp
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine

ARCH = "lram-sharded-tiered"
ROWS, M, SHARD_ROWS = 4096, 8, 256
BATCH, SEQ = 4, 32


def _pair(rng, *, ranges=4, slots=2, quant="none", rows=ROWS):
    """The same table as a port store and a reference store."""
    dense = rng.normal(size=(rows, M)).astype(np.float32)
    kw = dict(shard_rows=SHARD_ROWS, cache_slots=slots, quant=quant)
    port = ShardedTieredStore.from_dense(dense, TieredSpec(**kw), ranges)
    ref = JStore.from_dense(dense, JSpec(**kw), ranges)
    return port, ref


def _same_stats(port, ref, *, device=True):
    """Equal stats; without `device` the fill bytes aside (the reference's
    host route, `gather_rows_host`, never uploads)."""
    keys = set(ref.stats) - (set() if device else {"fill_bytes"})
    assert {k: port.stats[k] for k in keys} == {k: ref.stats[k]
                                               for k in keys}
    assert port.hit_rate() == ref.hit_rate()


def _host(store):
    """Every part's host tier (payload, scales) after a flush."""
    store.flush()
    return [(np.asarray(p._host), None if p._host_scale is None
             else np.asarray(p._host_scale)) for p in store.parts]


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_from_payload_carries_the_payload_bit_for_bit(rng, quant):
    """A 1-byte payload and its scales (the converter's and the plan's
    `table_from_payload`) land in the ranges bit for bit: each global
    shard reads back as the reference store's from the same dense table,
    and a payload of the other kind is refused."""
    port, ref = _pair(rng, ranges=4, slots=2, quant=quant)
    q = np.concatenate([ref.shard_host(i) for i in range(ref.num_shards)])
    scale = np.concatenate([ref.shard_scale_host(i)
                            for i in range(ref.num_shards)])
    q = q.view(np.uint8) if quant == "fp8" else q
    spec = TieredSpec(shard_rows=SHARD_ROWS, cache_slots=2, quant=quant)
    store = ShardedTieredStore.from_payload(q, scale, spec, 4)
    for i in range(store.num_shards):
        np.testing.assert_array_equal(store.shard_host(i),
                                      port.shard_host(i))
        np.testing.assert_array_equal(store.shard_scale_host(i),
                                      ref.shard_scale_host(i))
    with pytest.raises(ValueError, match="does not fit"):
        ShardedTieredStore.from_payload(q.astype(np.float32), scale, spec, 4)


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("ranges,slots", [(4, 2), (2, 8), (1, 3)])
def test_gather_matches_the_reference_store(rng, quant, ranges, slots):
    """Five lookups of 16 tokens x top-8 (with fills, evictions and rows
    served from the host tier on the small caches, all resident with 8
    slots a range): every output to 1e-5 of the reference's, and its
    stats, hit rate and residency equal after each."""
    port, ref = _pair(rng, ranges=ranges, slots=slots, quant=quant)
    for _ in range(5):
        idx = rng.integers(0, ROWS, size=(16, 8)).astype(np.int32)
        w = rng.uniform(0, 1, size=idx.shape).astype(np.float32)
        got = port.gather(torch.from_numpy(idx), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.gather(idx,
                                                                      w)),
                                   rtol=1e-5, atol=1e-5)
        _same_stats(port, ref)
        assert port.resident_shards() == ref.resident_shards()


@pytest.mark.parametrize("slots", [4, 2])
def test_gather_adds_masked_partials_in_range_order(rng, slots):
    """The eager gather is the reference's sum of masked partials, added
    in range order, bit for bit: range r's partial holds every token's k
    products, the other ranges' elements reading r's first routed row
    with weight 0, through r's cache (4 slots a range: every shard
    resident, B5's plain version; 2: the flat route, K1's)."""
    dense = rng.normal(size=(ROWS, M)).astype(np.float32)
    spec = TieredSpec(shard_rows=SHARD_ROWS, cache_slots=slots,
                      use_pallas=True)
    store = ShardedTieredStore.from_dense(dense, spec, 4)
    idx = rng.integers(0, ROWS, size=(16, 8)).astype(np.int32)
    w = rng.uniform(0, 1, size=idx.shape).astype(np.float32)
    got = store.gather(torch.from_numpy(idx), torch.from_numpy(w))
    rows, want = ROWS // 4, None
    for r in range(4):
        sel = idx // rows == r
        local = np.where(sel, idx - r * rows, idx[sel][0] - r * rows)
        part = gather_interp_plain(
            torch.from_numpy(dense[r * rows:(r + 1) * rows]),
            torch.from_numpy(local), torch.from_numpy(np.where(sel, w, 0)))
        want = part if want is None else want + part
    assert torch.equal(got, want)
    assert store.stats["lookups"] == 4  # one per range


def test_stats_exclude_padding(rng):
    """132 routed elements count as 132 accesses: the reference pads each
    range's sub-gather to a power of two and counts the prefix only; the
    port does not pad."""
    port, ref = _pair(rng, ranges=2, slots=4)
    idx = rng.integers(0, ROWS, size=(11, 12)).astype(np.int32)
    w = rng.normal(size=idx.shape).astype(np.float32)
    port.gather(torch.from_numpy(idx), torch.from_numpy(w))
    ref.gather(idx, w)
    s = port.stats
    assert s["hits"] + s["misses"] + s["uncached"] == idx.size
    _same_stats(port, ref)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_lookup_rows_read_the_reference_rows(rng, quant):
    """The differentiable route: the concatenated flat table at the rows
    `lookup_rows` names holds `gather_rows_host`'s rows of the reference
    (dequantized for int8), and the parts were mapped alike (stats)."""
    port, ref = _pair(rng, ranges=4, slots=2, quant=quant)
    for _ in range(3):
        idx = rng.integers(0, ROWS, size=(6, 8)).astype(np.int32)
        table, scale, rows = port.lookup_rows(torch.from_numpy(idx))
        got = table[rows.long()].float()
        if scale is not None:
            got = got * scale[rows.long()][..., None]
        np.testing.assert_allclose(got.numpy(), ref.gather_rows_host(idx),
                                   rtol=1e-6)
        _same_stats(port, ref, device=False)


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_writeback_routes_to_the_owning_ranges(rng, quant):
    """The same (idx, w ⊗ g) sequence, with lookups between that move the
    caches, through both packages' `apply_writeback`: the host tiers end
    equal (fp32 to 1e-6, 1-byte payloads and scales bit for bit: every
    part draws its stochastic rounding from its own generator in the
    reference's order), the untouched rows unchanged."""
    port, ref = _pair(rng, ranges=4, slots=2, quant=quant)
    port.writeback_lr = ref.writeback_lr = 0.1
    assert port.parts[2].writeback_lr == 0.1
    before = port.to_dense()
    touched = np.zeros(ROWS, bool)
    for _ in range(4):
        idx = rng.integers(0, ROWS, size=(12, 8)).astype(np.int32)
        port.lookup_rows(torch.from_numpy(idx))
        ref.gather_rows_host(idx)
        wg = rng.normal(size=idx.shape + (M,)).astype(np.float32)
        port.apply_writeback(idx, wg)
        ref.apply_writeback(idx, wg)
        touched[idx.reshape(-1)] = True
    for (p, ps), (r, rs) in zip(_host(port), _host(ref)):
        if quant == "none":
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(p.view(np.uint8), r.view(np.uint8))
            np.testing.assert_array_equal(ps, rs)
    _same_stats(port, ref, device=False)
    after = port.to_dense()
    np.testing.assert_array_equal(after[~touched], before[~touched])
    assert not np.allclose(after[touched], before[touched])


def test_tiered_interp_trains_through_the_routed_writeback(rng):
    """`tiered_interp` on the store is differentiable in w (dw = g · rows,
    as the reference's traced VJP) and hands w ⊗ g to the ranges'
    write-back: the reference's `tiered_interp` under `jax.grad` on the
    same table gives the same dw and the same table after."""
    port, ref = _pair(rng, ranges=4, slots=2)
    port.writeback_lr = ref.writeback_lr = 0.1
    idx = rng.integers(0, ROWS, size=(16, 8)).astype(np.int32)
    w = rng.normal(size=idx.shape).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_()
    (tiered_interp(port, torch.from_numpy(idx), wt) ** 2).sum().backward()
    dw = jax.grad(lambda w_: jnp.sum(j_memstore.tiered_interp(
        ref, jnp.asarray(idx), w_) ** 2))(jnp.asarray(w))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.to_dense(), ref.to_dense(), atol=1e-6)
    assert sum(p.stats["writebacks"] for p in port.parts) == \
        ref.stats["writebacks"] > 0


def test_find_stores_and_engine_discovery():
    """The arch's model holds one `ShardedTieredStore` of 2 ranges:
    `find_stores` lists it and not its range stores, the serve engine
    finds it through the plan's `supports_prefetch`, warms every range
    and serves."""
    cfg = configs.get_smoke_config(ARCH)
    model = transformer.init(cfg, seed=0)
    found = lookup.find_stores(model)
    assert len(found) == 1 and found[0][0].endswith("lram.values")
    store = found[0][1]
    assert isinstance(store, ShardedTieredStore) and store.num_ranges == 2
    assert lookup.is_store(store) and lookup.is_store(store.parts[0])
    engine = ServeEngine(model, EngineConfig(slots=2, max_len=24))
    assert [s for _, s in engine.stores] == [store]
    from repro_torch.serving import synthetic_trace

    report = engine.run(synthetic_trace(np.random.default_rng(0), 3,
                                        vocab_size=cfg.vocab_size,
                                        max_prompt=8, max_gen=4))
    assert len(report.requests) == 3
    assert all(len(p.resident_shards()) == 4 for p in store.parts)
    assert report.cache["hits"] > 0


@pytest.mark.parametrize("smoke", [True, False])
def test_config_resolves_to_the_reference_cell(smoke):
    """Both sizes carry the reference's model and layout letter for
    letter (model_shards, TieredSpec); the cell is the reference's
    placement and storage, with the kernel axis's ``auto`` resolved to
    the port's CUDA kernels as for every tiered placement."""
    get = configs.get_smoke_config if smoke else configs.get_config
    j_get = j_configs.get_smoke_config if smoke else j_configs.get_config
    cfg, j_cfg = get(ARCH), j_get(ARCH)
    assert cfg.name == j_cfg.name == ARCH
    for f in dataclasses.fields(cfg):
        if f.name != "lram":
            assert getattr(cfg, f.name) == getattr(j_cfg, f.name), f.name
    for f in dataclasses.fields(cfg.lram):
        if f.name != "tiered":
            assert getattr(cfg.lram, f.name) == getattr(j_cfg.lram,
                                                        f.name), f.name
    for f in dataclasses.fields(cfg.lram.tiered):
        assert getattr(cfg.lram.tiered, f.name) == \
            getattr(j_cfg.lram.tiered, f.name), f.name
    plan, j_plan = lookup.resolve(cfg.lram), j_lookup.resolve(j_cfg.lram)
    assert plan.cell[:2] == j_plan.cell[:2] == ("sharded-tiered", "fp32")
    assert plan.kernel == "pallas"
    assert plan.supports_prefetch and plan.table_update == "writeback"
    assert plan.table_rows_axis is None
    assert cfg.lram.model_shards == (2 if smoke else 4)


@pytest.mark.parametrize("kw,match", [
    (dict(model_shards=3), "not divisible"),
    (dict(model_shards=4, tiered=TieredSpec(shard_rows=32768,
                                            cache_slots=1)), "shard_rows"),
    (dict(tiered=TieredSpec(backing="mmap")), "A8"),
])
def test_indivisible_ranges_and_unported_backing_raise(kw, match):
    with pytest.raises(lookup.LookupPlanError, match=match):
        lookup.resolve(LRAMConfig(log2_locations=16, m=8, heads=2,
                                  interp_impl="sharded-tiered", **kw))


def test_without_model_shards_one_range_or_the_mesh_size():
    """model_shards 0: one range without a mesh (the reference's rule)."""
    plan = lookup.resolve(LRAMConfig(log2_locations=12, m=8, heads=2,
                                     interp_impl="sharded-tiered",
                                     tiered=TieredSpec(shard_rows=256)))
    store = plan.build_table(torch.zeros(4096, 8))
    assert isinstance(store, ShardedTieredStore) and store.num_ranges == 1


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:012d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_checkpoints_cross_restore_in_both_packages(rng, tmp_path, quant):
    """A dirty sharded-tiered store's checkpoint is the reference's:
    manifest and every shard file byte for byte.  It restores bit for bit
    into a fresh sharded-tiered store, a plain tiered store and a dense
    proto in the port and in the JAX package, and a plain tiered and a
    dense checkpoint restore into a sharded-tiered store."""
    port, ref = _pair(rng, ranges=2, slots=2, quant=quant, rows=2048)
    port.writeback_lr = ref.writeback_lr = 0.5
    idx = rng.integers(0, 2048, size=(64,)).astype(np.int32)
    port.lookup_rows(torch.from_numpy(idx))
    ref.gather_rows_host(idx)
    wg = rng.normal(size=(64, M)).astype(np.float32)
    port.apply_writeback(idx, wg)
    ref.apply_writeback(idx, wg)
    assert any(p._dirty for p in port.parts)
    CheckpointManager(str(tmp_path / "port")).save(1, {"values": port})
    JCheckpointManager(str(tmp_path / "jax")).save(1, {"values": ref})
    assert _manifest(tmp_path / "port", 1) == _manifest(tmp_path / "jax", 1)
    for root, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            mine = os.path.join(root.replace(str(tmp_path / "jax"),
                                             str(tmp_path / "port")), f)
            with open(os.path.join(root, f), "rb") as a, \
                    open(mine, "rb") as b:
                assert a.read() == b.read(), f
    want = port.to_dense()
    spec = TieredSpec(shard_rows=SHARD_ROWS, cache_slots=2, quant=quant)
    j_spec = JSpec(shard_rows=SHARD_ROWS, cache_slots=2, quant=quant)
    mgr = CheckpointManager(str(tmp_path / "port"))
    j_mgr = JCheckpointManager(str(tmp_path / "port"))
    for fresh in (ShardedTieredStore(2048, M, spec, 2),
                  TieredValueStore(2048, M, spec),
                  ShardedTieredStore(2048, M, spec, 4)):
        assert mgr.restore({"values": fresh})[0] == 1
        np.testing.assert_array_equal(fresh.to_dense(), want)
    for fresh in (JStore(2048, M, j_spec, 2),
                  JTieredValueStore(2048, M, j_spec)):
        assert j_mgr.restore({"values": fresh})[0] == 1
        np.testing.assert_array_equal(fresh.to_dense(), want)
    _, dense = mgr.restore({"values": np.zeros((2048, M), np.float32)})
    np.testing.assert_array_equal(dense["values"], want)
    _, j_dense = j_mgr.restore({"values": jnp.zeros((2048, M))})
    np.testing.assert_array_equal(np.asarray(j_dense["values"]), want)
    # the reverse: a plain tiered and a dense checkpoint into the store
    tiered = TieredValueStore.from_dense(want, spec)
    CheckpointManager(str(tmp_path / "t")).save(1, {"values": tiered})
    CheckpointManager(str(tmp_path / "d")).save(1, {"values": want})
    for d in ("t", "d"):
        fresh = ShardedTieredStore(2048, M, spec, 2)
        CheckpointManager(str(tmp_path / d)).restore({"values": fresh})
        want_d = tiered.to_dense() if d == "t" or quant == "none" else \
            TieredValueStore.from_dense(want, spec).to_dense()
        np.testing.assert_array_equal(fresh.to_dense(), want_d)


# ---------------------------------------------------------------------------
# the smoke arch against the JAX package
# ---------------------------------------------------------------------------

def _numpy_tree(tree):
    """The reference's params as numpy, every store as its table."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (JStore, JTieredValueStore)):
        return tree.to_dense()
    return np.asarray(tree)


@pytest.fixture(scope="module")
def ref():
    j_cfg = j_configs.get_smoke_config(ARCH)
    params, state = j_tf.init(jax.random.PRNGKey(0), j_cfg)
    return j_cfg, params, state


def _port_model(ref):
    j_cfg, params, state = ref
    return convert.model_from_jax(_numpy_tree(params),
                                  jax.tree.map(np.asarray, state),
                                  configs.get_smoke_config(ARCH),
                                  device="cpu")


def test_smoke_forward_matches_jax(ref):
    """The eval logits of the smoke arch on converted weights, each range
    gathering through its own cache, to 1e-5 of the reference's."""
    j_cfg, params, state = ref
    model = _port_model(ref)
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective)
    batch = j_data.get_batch(dcfg, step=0)
    want, _, _ = j_tf.forward(params, state,
                              jax.tree.map(jnp.asarray, batch), j_cfg)
    with torch.no_grad():
        got = transformer.forward(model, {k: torch.from_numpy(np.asarray(v))
                                          .long() for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_smoke_train_steps_match_jax(ref):
    """5 steps from converted weights on the reference's batches (write-back
    rate 1e-3): losses and grad norms to rtol 1e-4 of the JAX train step
    with its traced write-back, and the tables after to 1e-5."""
    j_cfg, params, state = ref
    params = jax.tree.map(lambda x: x, params)
    model = _port_model(ref)
    (_, j_store), = j_lookup.find_stores(params)
    j_store.writeback_lr = 1e-3
    j_store.warm()
    (store,) = train.bind_stores(model, 1e-3)
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective,
                             seed=0)
    j_step = j_train.build_train_step(j_cfg, j_optim.OptimConfig(lr=1e-4))
    j_opt, residual = j_optim.adam_init(params), jnp.zeros(())
    opt_state = optim.adam_init(dict(model.named_parameters()))
    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4))
    got, want = [], []
    for s in range(5):
        b = j_data.get_batch(dcfg, step=s)
        params, j_opt, state, residual, jm = j_step(
            params, j_opt, state, residual, jax.tree.map(jnp.asarray, b))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        m = step(opt_state, {k: torch.from_numpy(np.asarray(v)).long()
                             for k, v in b.items()})
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert store.stats["writebacks"] == j_store.stats["writebacks"] > 0
    np.testing.assert_allclose(store.to_dense(), j_store.to_dense(),
                               atol=1e-5)


def test_serve_restores_a_sharded_tiered_checkpoint(tmp_path, capsys):
    """`serve --ckpt-dir` serves what `train` saved from the smoke arch
    (the ranges' shards streamed into fresh stores), and the same
    checkpoint serves on the plain tiered placement of `lram-tiered`
    (global shard ids: one layout): both give the trained model's first
    logits to 1e-5."""
    from repro_torch.launch import serve
    from repro_torch.serving import synthetic_trace

    run = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path)])
    assert run.stores[0].stats["writebacks"] == 3 * 2
    trace = synthetic_trace(np.random.default_rng(0), 4,
                            vocab_size=run.model.cfg.vocab_size,
                            max_prompt=8, max_gen=4)
    want = ServeEngine(run.model, EngineConfig(slots=2, max_len=12)).run(
        trace)
    capsys.readouterr()
    for arch in (ARCH, "lram-tiered"):
        report = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "8", "--gen",
                             "4", "--json", "--ckpt-dir", str(tmp_path)])
        lines = capsys.readouterr().out.splitlines()
        assert json.loads(lines[0]) == {"restored_step": 3}
        assert len(report.requests) == len(want.requests) == 4
        for a, b in zip(report.requests, want.requests):
            np.testing.assert_allclose(a.first_logits, b.first_logits,
                                       atol=1e-5)
