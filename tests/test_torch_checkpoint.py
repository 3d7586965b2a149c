"""Checkpoints of the port (`repro_torch.checkpoint`): twins of the JAX
package's checkpoint tests (round trip, atomicity, corruption fallback,
async, retention, grow-on-restore and `CheckpointError`), of its store's
checkpoint streaming (dirty shards, a corrupt shard, quantized <-> dense),
the store's shard I/O against the reference store's, and checkpoints
across the two packages: the port's files are the reference's, byte for
byte, and restore in it bit for bit."""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import optim as j_optim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.memstore import TieredSpec as JTieredSpec
from repro.memstore import TieredValueStore as JTieredValueStore
from repro.checkpoint.manager import _tree_items as j_tree_items
from repro.models import transformer as j_tf
from repro_torch import configs, data, optim
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.checkpoint.manager import _tree_items
from repro_torch.launch import convert, train
from repro_torch.memstore import TieredSpec, TieredValueStore

SMOKE_ARCHS = ["lram-bert-small", "lram-bert-pkm", "lram-tiered",
               "lram-tiered-q8"]


@pytest.fixture
def tree(rng):
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype("f")),
                   "b": torch.from_numpy(rng.normal(size=(4,)).astype("f"))},
        "opt": {"step": torch.tensor(17, dtype=torch.int32)},
    }


def _equal(restored, tree):
    for k in ("w", "b"):
        np.testing.assert_array_equal(restored["params"][k],
                                      tree["params"][k].numpy())
    assert restored["opt"]["step"] == 17
    assert restored["opt"]["step"].dtype == np.int32


def _dirty_store(rng, rows=2048, shard_rows=256, slots=3, n=64, **kw):
    """A store whose write-back left dirty cached shards."""
    dense = rng.normal(size=(rows, 8)).astype(np.float32) * 0.02
    store = TieredValueStore.from_dense(
        dense, TieredSpec(shard_rows=shard_rows, cache_slots=slots, **kw))
    store.writeback_lr = 0.5
    idx = rng.integers(0, rows, size=(n,)).astype(np.int32)
    store.prefetch(idx, sync_device=False)
    store.apply_writeback(idx, rng.normal(size=(n, 8)).astype(np.float32))
    assert store._dirty, "test needs dirty cached shards"
    return store


def _manifest(d, step):
    with open(os.path.join(str(d), f"step_{step:012d}",
                           "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(100, tree)
    step, restored = mgr.restore(tree)
    assert step == 100
    _equal(restored, tree)
    assert [h["op"] for h in mgr.history] == ["save", "restore"]
    assert mgr.history[0]["bytes"] > 0


def test_latest_and_retention(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_corrupted_checkpoint_falls_back(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, tree)
    mgr.save(2, tree)
    d = os.path.join(str(tmp_path), "step_000000000002")
    leaf = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, leaf), "wb") as f:
        f.write(b"garbage")
    step, restored = mgr.restore(tree)
    assert step == 1  # fell back to the newest VALID checkpoint
    _equal(restored, tree)


def test_interrupted_save_leaves_no_partial(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_000000000002.tmp"))
    assert mgr.latest_step() == 1
    step, _ = mgr.restore(tree)
    assert step == 1


def test_async_save(tmp_path, tree):
    """The host copy is taken at save(): the in-place update that follows
    (as the next train step makes) is not in the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    want = tree["params"]["w"].clone()
    mgr.save(5, tree, blocking=False)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    step, restored = mgr.restore(tree)
    assert step == 5
    np.testing.assert_array_equal(restored["params"]["w"], want.numpy())
    assert mgr.history[0]["write_ms"] >= 0


def test_async_save_error_raises_at_wait(tmp_path, tree, monkeypatch):
    """A write that fails in the thread raises at the next wait(), and
    leaves no checkpoint behind."""
    from repro_torch.checkpoint import manager

    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(manager, "_save", broken)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.latest_step() is None


def test_restore_with_dtype_cast(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    like = {"params": {k: torch.empty(v.shape, dtype=torch.float16,
                                      device="meta")
                       for k, v in tree["params"].items()},
            "opt": tree["opt"]}
    _, restored = mgr.restore(like)
    assert restored["params"]["w"].dtype == np.float16


def test_missing_leaf_raises(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    bigger = dict(tree, extra=torch.zeros(2))
    with pytest.raises(KeyError):
        mgr.restore(bigger)


def test_manifest_contents(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, tree)
    man = _manifest(tmp_path, 9)
    assert man["step"] == 9
    assert man["leaves"]["params/w"]["shape"] == [8, 4]
    assert man["leaves"]["opt/step"]["dtype"] == "int32"


def test_grow_on_restore_into_larger_store(tmp_path, rng):
    dense = rng.normal(size=(2048, 8)).astype(np.float32)
    spec = TieredSpec(shard_rows=256, cache_slots=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"values": TieredValueStore.from_dense(dense, spec)})
    big = TieredValueStore(4096, 8, spec)
    step, _ = mgr.restore({"values": big})
    assert step == 1
    got = big.to_dense()
    np.testing.assert_array_equal(got[:2048], dense)
    np.testing.assert_array_equal(got[2048:], dense)  # alias copy


def test_grow_on_restore_dense_leaf(tmp_path, rng):
    arr = rng.normal(size=(1024, 8)).astype(np.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"lram": {"values": torch.from_numpy(arr)}})
    _, restored = mgr.restore({"lram": {"values": torch.zeros(2048, 8)}})
    got = restored["lram"]["values"]
    np.testing.assert_array_equal(got[:1024], arr)
    np.testing.assert_array_equal(got[1024:], arr)


def test_restore_shrink_raises_checkpoint_error(tmp_path, rng):
    dense = rng.normal(size=(4096, 8)).astype(np.float32)
    spec = TieredSpec(shard_rows=256, cache_slots=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"values": TieredValueStore.from_dense(dense, spec)})
    with pytest.raises(CheckpointError, match="shrink"):
        mgr.restore({"values": TieredValueStore(2048, 8, spec)})
    mgr2 = CheckpointManager(str(tmp_path / "d"))
    mgr2.save(1, {"lram": {"values": torch.from_numpy(dense)}})
    with pytest.raises(CheckpointError, match="shrink"):
        mgr2.restore({"lram": {"values": torch.zeros(2048, 8)}})


def test_restore_non_table_shape_mismatch_raises(tmp_path, rng):
    """Only an LRAM table grows: `pkm/values` rows have no lattice
    parent, so a mismatch there raises like any other leaf's."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype("f"))})
    with pytest.raises(CheckpointError, match="shape mismatch"):
        mgr.restore({"w": torch.zeros(16, 4)})
    mgr2 = CheckpointManager(str(tmp_path / "p"))
    mgr2.save(1, {"pkm": {"values": torch.from_numpy(
        rng.normal(size=(8, 4)).astype("f"))}})
    with pytest.raises(CheckpointError, match="shape mismatch"):
        mgr2.restore({"pkm": {"values": torch.zeros(16, 4)}})


def test_restore_shard_geometry_mismatch_raises(tmp_path, rng):
    dense = rng.normal(size=(2048, 8)).astype(np.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"values": TieredValueStore.from_dense(
        dense, TieredSpec(shard_rows=256, cache_slots=2))})
    other = TieredValueStore(2048, 8, TieredSpec(shard_rows=512,
                                                 cache_slots=2))
    with pytest.raises(CheckpointError, match="geometry"):
        mgr.restore({"values": other})


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_grow_on_restore_quantized_payload_exact(tmp_path, rng, kind):
    dense = rng.normal(size=(1024, 8)).astype(np.float32)
    spec = TieredSpec(shard_rows=256, cache_slots=2, quant=kind)
    small = TieredValueStore.from_dense(dense, spec)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"values": small})
    big = TieredValueStore(2048, 8, spec)
    mgr.restore({"values": big})
    got = big.to_dense()
    np.testing.assert_array_equal(got[:1024], small.to_dense())
    np.testing.assert_array_equal(got[1024:], small.to_dense())


# ---------------------------------------------------------------------------
# twins of the store's checkpoint tests (test_memstore.py, test_quant.py)
# ---------------------------------------------------------------------------

def test_checkpoint_streams_dirty_tiered_table(rng, tmp_path):
    store = _dirty_store(rng)
    tree = {"params": {"values": store, "w": torch.ones(3)},
            "opt": {"mu": {"values": store}}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree)
    expected = store.to_dense()
    kinds = sorted(v.get("kind", "array")
                   for v in _manifest(tmp_path, 5)["leaves"].values())
    assert kinds == ["array", "tiered", "tiered_ref"]

    fresh = TieredValueStore(2048, 8, TieredSpec(shard_rows=256,
                                                 cache_slots=3))
    tree2 = {"params": {"values": fresh, "w": torch.zeros(3)},
             "opt": {"mu": {"values": fresh}}}
    step, restored = mgr.restore(tree2)
    assert step == 5
    np.testing.assert_array_equal(fresh.to_dense(), expected)
    assert restored["params"]["values"] is fresh

    # a tiered checkpoint restored into a dense proto: materialized
    tree3 = {"params": {"values": torch.zeros(2048, 8), "w": torch.zeros(3)},
             "opt": {"mu": {"values": torch.zeros(2048, 8)}}}
    _, r3 = mgr.restore(tree3)
    np.testing.assert_array_equal(r3["params"]["values"], expected)


def test_corrupt_shard_falls_back_to_older_checkpoint(rng, tmp_path):
    dense = rng.normal(size=(1024, 8)).astype(np.float32)
    store = TieredValueStore.from_dense(dense, TieredSpec(shard_rows=128,
                                                          cache_slots=2))
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"values": store})
    store.writeback_lr = 0.5
    idx = rng.integers(0, 1024, size=(32,)).astype(np.int32)
    store.prefetch(idx, sync_device=False)
    store.apply_writeback(idx, rng.normal(size=(32, 8)).astype(np.float32))
    mgr.save(2, {"values": store})
    for step in (2, 1):
        with open(os.path.join(str(tmp_path), f"step_{step:012d}",
                               "values.npy.shards", "shard_000003.npy"),
                  "wb") as f:
            f.write(b"garbage")
        fresh = TieredValueStore(1024, 8, TieredSpec(shard_rows=128,
                                                     cache_slots=2))
        if step == 2:  # the newest shard set is corrupt: the older wins
            assert mgr.restore({"values": fresh})[0] == 1
            np.testing.assert_array_equal(fresh.to_dense(), dense)
        else:  # every candidate corrupt, the store partly overwritten
            with pytest.raises(IOError):
                mgr.restore({"values": fresh})


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_dirty_checkpoint_round_trip(rng, tmp_path, kind):
    """Dirty shards of a quantized store: payload + scales streamed;
    restored bit-exact into a fresh store of its kind, dequantized into a
    dense proto and a dense store, requantized into the other kind."""
    store = _dirty_store(rng, quant=kind)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"values": store})
    expected = store.to_dense()
    meta = _manifest(tmp_path, 3)["leaves"]["values"]
    assert meta["quant"] == kind and meta["dtype"] == "float32"
    assert len(meta["scale_crc32"]) == store.num_shards
    assert os.path.exists(os.path.join(str(tmp_path), "step_000000000003",
                                       meta["dir"], "scale_000000.npy"))

    fresh = TieredValueStore(2048, 8, store.spec)
    assert mgr.restore({"values": fresh})[0] == 3
    np.testing.assert_array_equal(fresh._host, store._host)
    np.testing.assert_array_equal(fresh._host_scale, store._host_scale)

    _, r = mgr.restore({"values": torch.zeros(2048, 8)})
    np.testing.assert_array_equal(r["values"], expected)
    dense_store = TieredValueStore(2048, 8, TieredSpec(shard_rows=256,
                                                       cache_slots=3))
    mgr.restore({"values": dense_store})
    np.testing.assert_array_equal(dense_store.to_dense(), expected)
    other = "fp8" if kind == "int8" else "int8"
    cross = TieredValueStore(2048, 8, TieredSpec(shard_rows=256,
                                                 cache_slots=3, quant=other))
    mgr.restore({"values": cross})
    ref = TieredValueStore.from_dense(expected, cross.spec)
    np.testing.assert_array_equal(cross._host, ref._host)


# ---------------------------------------------------------------------------
# the store's shard I/O against the reference store's
# ---------------------------------------------------------------------------

def _reference_payload(arr, kind):
    return arr.view(ml_dtypes.float8_e4m3fn) if kind == "fp8" else arr


@pytest.mark.parametrize("src", ["none", "int8", "fp8"])
@pytest.mark.parametrize("dst", ["none", "int8", "fp8"])
def test_load_shard_matches_reference(rng, src, dst):
    """A shard of each kind loaded into a store of each kind: the host
    tier (and scales) the reference store's `load_shard` gives."""
    rows = rng.normal(size=(256, 8)).astype(np.float32) * 0.02
    q, scale = rows, None
    if src != "none":
        shard = TieredValueStore.from_dense(
            rows, TieredSpec(shard_rows=256, quant=src))
        q, scale = shard.shard_host(0), shard.shard_scale_host(0)
    store = TieredValueStore(1024, 8, TieredSpec(shard_rows=256,
                                                 cache_slots=2, quant=dst))
    j_store = JTieredValueStore(1024, 8, JTieredSpec(
        shard_rows=256, cache_slots=2, quant=dst))
    store.load_shard(2, q, scale)
    j_store.load_shard(2, _reference_payload(q, src), scale)
    want = np.asarray(j_store._host[2])
    if dst == "fp8":
        want = want.view(np.uint8)
    np.testing.assert_array_equal(store.shard_host(2), want)
    if dst != "none":
        np.testing.assert_array_equal(store.shard_scale_host(2),
                                      np.asarray(j_store._host_scale[2]))


def test_load_shard_refreshes_a_dirty_cached_copy(rng):
    store = _dirty_store(rng, n=8)
    slot = next(iter(store._dirty))
    shard = int(store._slot_shard[slot])
    new = rng.normal(size=(256, 8)).astype(np.float32)
    store._dev_stale.clear()
    store.load_shard(shard, new)
    assert slot not in store._dirty and slot in store._dev_stale
    np.testing.assert_array_equal(store.cache_np[slot], new)
    np.testing.assert_array_equal(store.shard_host(shard), new)
    store.load_dense(np.zeros((2048, 8), np.float32))
    assert not store.resident_shards() and not store._dirty
    assert not store.to_dense().any()


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _jax_tree(arch):
    """The reference's {"params", "opt", "model_state"} for a smoke arch
    from PRNGKey(0), with fresh Adam state."""
    j_cfg = j_configs.get_smoke_config(arch)
    params, state = j_tf.init(jax.random.PRNGKey(0), j_cfg)
    return j_cfg, {"params": params, "opt": j_optim.adam_init(params),
                   "model_state": state}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, JTieredValueStore):
        shards = range(tree.num_shards)
        payload = np.concatenate([tree.shard_host(i) for i in shards])
        if tree.quant == "none":
            return payload
        return {"q": payload.view(np.uint8) if tree.quant == "fp8"
                else payload,
                "scale": np.concatenate([tree.shard_scale_host(i)
                                         for i in shards])}
    return np.asarray(tree)


def _port_model(arch, j_tree):
    return convert.model_from_jax(_numpy_tree(j_tree["params"]),
                                  _numpy_tree(j_tree["model_state"]),
                                  configs.get_smoke_config(arch),
                                  device="cpu")


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_names_cover_the_reference_tree(arch):
    """`reference_path` names every state_dict key (and tiered table) of
    the port with a leaf of the reference's tree of that shape, and the
    port's tree has exactly the reference's leaves."""
    j_cfg, j_tree = _jax_tree(arch)
    model = _port_model(arch, j_tree)
    flat = dict(convert.state_dict_from_jax(
        _numpy_tree(j_tree["params"]), _numpy_tree(j_tree["model_state"]),
        j_cfg))
    for key, t in model.state_dict().items():
        path, layer = convert.reference_path(key, model.cfg)
        node = j_tree
        for p in path.split("/"):
            node = node[p]
        arr = np.asarray(node)
        np.testing.assert_array_equal(arr if layer is None else arr[layer],
                                      flat[key].numpy())
    port = convert.reference_tree(
        model, optim.adam_init(dict(model.named_parameters())))
    assert [n for n, _ in _tree_items(port)] == \
        [n for n, _ in j_tree_items(j_tree)]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_manifest_equals_the_reference(tmp_path, arch):
    """The port's checkpoint of a model converted from a JAX init, with
    fresh Adam state, is the reference's: the same manifest (names,
    shapes, dtypes, crc32s, tiered and tiered_ref entries) and the same
    files, byte for byte."""
    _, j_tree = _jax_tree(arch)
    model = _port_model(arch, j_tree)
    opt_state = optim.adam_init(dict(model.named_parameters()))
    JCheckpointManager(str(tmp_path / "jax")).save(0, j_tree)
    CheckpointManager(str(tmp_path / "port")).save(
        0, convert.reference_tree(model, opt_state))
    assert _manifest(tmp_path / "port", 0) == _manifest(tmp_path / "jax", 0)
    for root, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            mine = os.path.join(root.replace(str(tmp_path / "jax"),
                                             str(tmp_path / "port")), f)
            with open(os.path.join(root, f), "rb") as a, \
                    open(mine, "rb") as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("arch", ["lram-bert-pkm", "lram-tiered-q8"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    """A port checkpoint taken after two train steps restores through the
    reference's `CheckpointManager.restore` into a fresh JAX tree: every
    array, Adam's moments and step and the store's payload and scales bit
    for bit."""
    _, j_tree = _jax_tree(arch)
    model = _port_model(arch, j_tree)
    opt_state = optim.adam_init(dict(model.named_parameters()))
    stores = train.bind_stores(model, 1e-3)
    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4))
    dcfg = data.DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16,
                           global_batch=2, objective=model.cfg.objective)
    for s in range(2):
        step(opt_state, train.batch_to(data.get_batch(dcfg, step=s), "cpu"))
    port = convert.reference_tree(model, opt_state)
    CheckpointManager(str(tmp_path)).save(2, port)
    _, fresh = _jax_tree(arch)
    found, got = JCheckpointManager(str(tmp_path)).restore(fresh)
    assert found == 2
    want = dict(_tree_items(port))
    for name, leaf in _tree_items(got):
        if isinstance(leaf, JTieredValueStore):
            (store,) = stores
            host = np.asarray(leaf._host)
            np.testing.assert_array_equal(host, store._host)
            np.testing.assert_array_equal(np.asarray(leaf._host_scale),
                                          store._host_scale)
            continue
        np.testing.assert_array_equal(np.asarray(leaf),
                                      want[name].numpy(), err_msg=name)
    assert int(got["opt"]["step"]) == 2


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_reference_quantized_checkpoint_restores_in_the_port(tmp_path, rng,
                                                             kind):
    """The reference's quantized tiered checkpoint (fp8 payloads written as
    numpy's `<V1`) streams into the port's store bit for bit; the port's
    shard files of the same store are the reference's, byte for byte."""
    dense = rng.normal(size=(1024, 8)).astype(np.float32)
    j_store = JTieredValueStore.from_dense(dense, JTieredSpec(
        shard_rows=256, cache_slots=2, quant=kind))
    JCheckpointManager(str(tmp_path / "jax")).save(1, {"values": j_store})
    store = TieredValueStore(1024, 8, TieredSpec(shard_rows=256,
                                                 cache_slots=2, quant=kind))
    assert CheckpointManager(str(tmp_path / "jax")).restore(
        {"values": store})[0] == 1
    want = np.asarray(j_store._host)
    np.testing.assert_array_equal(
        store._host, want.view(np.uint8) if kind == "fp8" else want)
    np.testing.assert_array_equal(store._host_scale, j_store._host_scale)
    CheckpointManager(str(tmp_path / "port")).save(1, {"values": store})
    sub = os.path.join("step_000000000001", "values.npy.shards")
    for f in os.listdir(tmp_path / "jax" / sub):
        assert (tmp_path / "jax" / sub / f).read_bytes() == \
            (tmp_path / "port" / sub / f).read_bytes(), f
