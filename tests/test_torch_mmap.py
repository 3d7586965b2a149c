"""The tiered store's `mmap` backing in the port (`TieredSpec(backing=
"mmap")`) against its RAM twin and the JAX package's mmap store: the
round trip of `tests/test_memstore.py`, the files and their names, every
reader and writer of the host tier on a memmap (`_read_rows_raw`,
`shard_host`, `load_shard`, `to_dense`, the write-back, migration),
`grow_rows` moving to a fresh file, checkpoints byte for byte a RAM
store's and restorable by the JAX package, the sharded-tiered store's
directory a range, and the plans and a served model on an mmap table."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.distributed.sharded_lram import ShardedTieredStore as JShStore
from repro.memstore import TieredSpec as JSpec
from repro.memstore import TieredValueStore as JStore
from repro_torch import configs
from repro_torch.memctl.migrate import migrate_table
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import lookup
from repro_torch.core.lram import LRAMConfig
from repro_torch.distributed.sharded_lram import ShardedTieredStore
from repro_torch.memstore import TieredSpec, TieredValueStore
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

STORAGES = ("fp32", "int8", "fp8")


@pytest.fixture
def one_thread():
    """One intra-op thread for a bit-for-bit comparison of two engines: with
    several, the CPU BLAS may split a product's sum by thread and
    alignment, an ulp apart from run to run (a 1-byte overlay row then
    rounds to another quantum)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quant(storage):
    return "none" if storage == "fp32" else storage


def _dense(seed=0, rows=1024, m=8):
    return np.random.default_rng(seed).normal(size=(rows, m)).astype(
        np.float32)


def _pair(dense, tmp_path, storage="fp32", **kw):
    """(RAM store, mmap store under tmp_path) of the same table."""
    spec = TieredSpec(shard_rows=128, cache_slots=2, quant=_quant(storage),
                      **kw)
    return (TieredValueStore.from_dense(dense, spec),
            TieredValueStore.from_dense(dense, dataclasses.replace(
                spec, backing="mmap", backing_dir=str(tmp_path))))


def _host(store):
    return np.asarray(store._host), (None if store._host_scale is None
                                     else np.asarray(store._host_scale))


def _same_host(a, b):
    (pa, sa), (pb, sb) = _host(a), _host(b)
    np.testing.assert_array_equal(pa, pb)
    if sa is not None or sb is not None:
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("storage", STORAGES)
def test_mmap_backing_round_trip(storage, tmp_path):
    """`tests/test_memstore.py`'s round trip: the mmap store's gathers
    equal its RAM twin's bit for bit (and the dense reference's within
    the storage's rounding); its host tier is the two `.npy` files, named
    by rows x width, holding the RAM tier's bytes, and the JAX package's
    mmap store of the same table writes the same arrays."""
    dense = _dense()
    ram, mm = _pair(dense, tmp_path / "port", storage)
    assert isinstance(mm._host, np.memmap)
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, 1024, (4, 8)).astype(np.int32))
    w = torch.from_numpy(rng.random((4, 8)).astype(np.float32))
    out = mm.gather(idx, w)
    torch.testing.assert_close(out, ram.gather(idx, w), rtol=0, atol=0)
    if storage == "fp32":
        want = np.einsum("nk,nkm->nm", w.numpy(), dense[idx.numpy()])
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    names = ["values_1024x8.npy"] + (["scales_1024x8.npy"]
                                     if storage != "fp32" else [])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(names)
    values = np.load(tmp_path / "port" / names[0])
    np.testing.assert_array_equal(values, ram._host)
    JStore.from_dense(dense, JSpec(shard_rows=128, cache_slots=2,
                                   quant=_quant(storage), backing="mmap",
                                   backing_dir=str(tmp_path / "jax")))
    for name in names:
        mine = np.load(tmp_path / "port" / name)
        theirs = np.load(tmp_path / "jax" / name)
        if storage == "fp8" and name.startswith("values"):
            theirs = theirs.view(np.uint8)  # the reference's `<V1` bytes
        np.testing.assert_array_equal(mine, theirs)
        if storage != "fp8":  # the same header too: byte for byte
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes()


def test_mmap_without_a_directory_takes_a_temporary_one(tmp_path,
                                                        monkeypatch):
    """No `backing_dir`: the files go to a fresh ``memstore_*`` temporary
    directory, one a store."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    spec = TieredSpec(shard_rows=128, cache_slots=2, backing="mmap")
    a = TieredValueStore.from_dense(_dense(), spec)
    b = TieredValueStore.from_dense(_dense(1), spec)
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2 and all(d.startswith("memstore_") for d in dirs)
    assert a._host.filename != b._host.filename


@pytest.mark.parametrize("storage", STORAGES)
def test_mmap_host_tier_io_matches_ram(storage, tmp_path):
    """Every reader and writer of the host tier works unchanged on a
    memmap: the write-back (resident and host rows, dirty slots, flush),
    `_read_rows_raw`, `shard_host` / `shard_scale_host`, `load_shard`,
    `to_dense`, `load_dense`, all equal to the RAM store's."""
    dense = _dense(2)
    stores = _pair(dense, tmp_path, storage)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 1024, size=(64,)).astype(np.int32)
    upd = rng.normal(size=(64, 8)).astype(np.float32)
    rows = rng.integers(0, 1024, size=(40,))
    shard = (0.1 * rng.normal(size=(128, 8))).astype(np.float32)
    for s in stores:
        s.writeback_lr = 0.5
        s.prefetch(idx[:16], sync_device=False)
        s.apply_writeback(idx, upd)
        assert s._dirty
    a, b = stores
    for i in range(a.num_shards):
        np.testing.assert_array_equal(a.shard_host(i), b.shard_host(i))
        if storage != "fp32":
            np.testing.assert_array_equal(a.shard_scale_host(i),
                                          b.shard_scale_host(i))
    for x, y in zip(a._read_rows_raw(rows), b._read_rows_raw(rows)):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    for s in stores:
        s.load_shard(3, shard)
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())
    _same_host(a, b)
    for s in stores:
        s.load_dense(dense)
    _same_host(a, b)
    assert isinstance(b._host, np.memmap)


@pytest.mark.parametrize("storage", STORAGES)
def test_mmap_grow_rows_matches_ram(storage, tmp_path):
    """`grow_rows` on a memmap writes a fresh file at the new shape
    (``values_2048x8.npy``) holding the RAM store's grown tier bit for
    bit, and the JAX package's grown mmap store's arrays; lookups of old
    rows are unchanged."""
    dense = _dense(4)
    ram, mm = _pair(dense, tmp_path / "port", storage)
    jm = JStore.from_dense(dense, JSpec(
        shard_rows=128, cache_slots=2, quant=_quant(storage),
        backing="mmap", backing_dir=str(tmp_path / "jax")))
    parents = np.random.default_rng(5).integers(0, 1024, size=(1024,))
    idx = torch.from_numpy(np.arange(0, 1024, 37, dtype=np.int32)[:, None])
    w = torch.ones(idx.shape)
    before = mm.gather(idx, w)
    for s in (ram, mm, jm):
        s.grow_rows(2048, parents)
    assert os.path.exists(tmp_path / "port" / "values_2048x8.npy")
    assert isinstance(mm._host, np.memmap) and mm._host.shape[0] == 16
    _same_host(ram, mm)
    want = np.asarray(jm._host)
    np.testing.assert_array_equal(
        mm._host, want.view(np.uint8) if storage == "fp8" else want)
    torch.testing.assert_close(mm.gather(idx, w), before, rtol=0, atol=0)


def test_migration_into_an_mmap_store_is_payload_exact(tmp_path):
    """`memctl.migrate_table` into a tiered plan backed by a memmap: the
    dense table's rows, bit for bit, in the file."""
    cfg = LRAMConfig(log2_locations=12, m=8, heads=2, query_norm="rms",
                     interp_impl="reference")
    dense = torch.from_numpy(_dense(6, rows=4096))
    dst = dataclasses.replace(cfg, interp_impl="tiered", tiered=TieredSpec(
        shard_rows=512, cache_slots=2, backing="mmap",
        backing_dir=str(tmp_path)))
    store = migrate_table(dense, cfg, dst)
    assert isinstance(store._host, np.memmap)
    np.testing.assert_array_equal(
        np.load(tmp_path / "values_4096x8.npy").reshape(4096, 8),
        dense.numpy())


@pytest.mark.parametrize("storage", STORAGES)
def test_mmap_checkpoint_is_the_ram_stores(storage, tmp_path):
    """A checkpoint of an mmap-backed store (dirty slots included) is the
    RAM-backed store's byte for byte; it restores into an mmap store of
    either package (the JAX package's fp8 restore aside: ROADMAP C4)."""
    dense = _dense(7)
    stores = _pair(dense, tmp_path / "files", storage)
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 1024, size=(32,)).astype(np.int32)
    upd = rng.normal(size=(32, 8)).astype(np.float32)
    for s, sub in zip(stores, ("ram", "mmap")):
        s.writeback_lr = 0.25
        s.prefetch(idx, sync_device=False)
        s.apply_writeback(idx, upd)
        CheckpointManager(str(tmp_path / sub)).save(1, {"values": s})
    for root, _, files in os.walk(tmp_path / "ram"):
        for f in files:
            mine = os.path.join(root.replace(str(tmp_path / "ram"),
                                             str(tmp_path / "mmap")), f)
            with open(os.path.join(root, f), "rb") as x, \
                    open(mine, "rb") as y:
                assert x.read() == y.read(), f
    back = TieredValueStore(1024, 8, TieredSpec(
        shard_rows=128, cache_slots=2, quant=_quant(storage),
        backing="mmap", backing_dir=str(tmp_path / "back")))
    assert CheckpointManager(str(tmp_path / "mmap")).restore(
        {"values": back})[0] == 1
    np.testing.assert_array_equal(back.to_dense(), stores[0].to_dense())
    if storage == "fp8":
        return
    j_back = JStore(1024, 8, JSpec(shard_rows=128, cache_slots=2,
                                   quant=_quant(storage), backing="mmap",
                                   backing_dir=str(tmp_path / "jback")))
    assert JCheckpointManager(str(tmp_path / "mmap")).restore(
        {"values": j_back})[0] == 1
    _same_host(j_back, back)


def test_sharded_tiered_mmap_range_directories(tmp_path, monkeypatch):
    """`ShardedTieredStore` with an mmap backing and a directory: one
    ``range_{r:03d}`` a range, each with its own file (the names alike),
    as the JAX package lays them out; growth adds the next range's
    directory; a gather equals the RAM twin's."""
    dense = _dense(9, rows=4096)
    spec = TieredSpec(shard_rows=256, cache_slots=2, backing="mmap",
                      backing_dir=str(tmp_path / "port"))
    store = ShardedTieredStore.from_dense(dense, spec, 4)
    JShStore.from_dense(dense, JSpec(shard_rows=256, cache_slots=2,
                                     backing="mmap",
                                     backing_dir=str(tmp_path / "jax")), 4)
    ranges = [f"range_{r:03d}" for r in range(4)]
    assert sorted(os.listdir(tmp_path / "port")) == ranges \
        == sorted(os.listdir(tmp_path / "jax"))
    for r, name in enumerate(ranges):
        assert os.listdir(tmp_path / "port" / name) == ["values_1024x8.npy"]
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / name / "values_1024x8.npy")
            .reshape(1024, 8), dense[r * 1024:(r + 1) * 1024])
    ram = ShardedTieredStore.from_dense(dense, dataclasses.replace(
        spec, backing="ram", backing_dir=None), 4)
    idx = torch.from_numpy(np.random.default_rng(10).integers(
        0, 4096, (6, 4)).astype(np.int32))
    w = torch.ones(idx.shape) / 4
    torch.testing.assert_close(store.gather(idx, w), ram.gather(idx, w),
                               rtol=0, atol=0)
    store.grow_rows(5120, np.arange(1024))
    assert "range_004" in os.listdir(tmp_path / "port")
    # no directory: each range its own temporary directory
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    plain = ShardedTieredStore(4096, 8, dataclasses.replace(
        spec, backing_dir=None), 2)
    dirs = {os.path.dirname(p._host.filename) for p in plain.parts}
    assert len(dirs) == 2 and all(
        os.path.basename(d).startswith("memstore_") for d in dirs)


@pytest.mark.parametrize("placement,spec_kw", [
    ("tiered", dict(shard_rows=4096, cache_slots=4)),
    ("sharded-tiered", dict(shard_rows=2048, cache_slots=2)),
])
def test_mmap_plans_resolve_and_build(placement, spec_kw, tmp_path):
    """The tiered and sharded-tiered cells take `backing="mmap"` (the
    shard-size check stays): the plan builds a store whose host tier is
    a memmap under the directory."""
    cfg = LRAMConfig(log2_locations=16, m=8, heads=2,
                     interp_impl=placement, model_shards=4,
                     tiered=TieredSpec(backing="mmap",
                                       backing_dir=str(tmp_path), **spec_kw))
    plan = lookup.resolve(cfg)
    table = plan.build_table(torch.zeros(2**16, 8))
    parts = table.parts if placement == "sharded-tiered" else [table]
    assert all(isinstance(p._host, np.memmap) for p in parts)
    assert plan.supports_overlay
    with pytest.raises(lookup.LookupPlanError, match="shard_rows"):
        lookup.resolve(dataclasses.replace(cfg, tiered=dataclasses.replace(
            cfg.tiered, shard_rows=2**17)))


def test_mmap_model_serves_the_ram_models_tokens(tmp_path, one_thread):
    """`lram-tiered-q8` (smoke) on its own spec with an mmap backing
    serves the RAM-backed model's tokens and first logits bit for bit,
    with tenants too (int8 overlays over the memmap's base rows)."""
    cfg = configs.get_smoke_config("lram-tiered-q8")
    mm_cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, tiered=dataclasses.replace(
            cfg.lram.tiered, backing="mmap", backing_dir=str(tmp_path))))
    trace = synthetic_trace(np.random.default_rng(0), 4,
                            vocab_size=cfg.vocab_size, max_prompt=6,
                            max_gen=4, tenants=2)
    reports = {}
    for name, c in (("ram", cfg), ("mmap", mm_cfg)):
        torch.manual_seed(0)
        model = transformer.init(c, seed=0)
        reports[name] = ServeEngine(model, EngineConfig(
            slots=2, max_len=12, overlay_rows=4)).run(trace)
    assert sorted(os.listdir(tmp_path)) == ["scales_65536x64.npy",
                                            "values_65536x64.npy"]
    for a, b in zip(reports["ram"].requests, reports["mmap"].requests):
        assert a.tokens == b.tokens
        np.testing.assert_array_equal(a.first_logits, b.first_logits)
    assert reports["mmap"].overlay["writebacks"] > 0
