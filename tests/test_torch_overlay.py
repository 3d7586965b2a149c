"""Per-tenant memory overlays of the port (`repro_torch.serving.overlay`,
`repro_torch.core.overlay`) against the JAX package's, case for case with
`tests/test_overlay.py`: the overlay and the manager property-tested
against the same pure-dict models (their rounding the JAX package's
codec), the `.npz` files crossing both ways, `enforce`, `save_all` /
`load_all`, the plans' capability flag, `read_rows_fp32` over every table
form, the manager's write-back fed the JAX engine's own accesses, and the
serve engine on the reference's tiny model with converted weights: the
empty pack bit-exact, retirement, the correction in the logits, the pack
deltas, mixed tenants, a quantized table, the controller's lifecycle and
the CLI.  The JAX engine serves the same weights and trace as the
oracle."""

import collections
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from repro import memctl as j_memctl
from repro import quant as j_quant
from repro.core import lookup as j_lookup
from repro.core import lram as j_lram
from repro.distributed import context as j_context
from repro.distributed.sharded_lram import ShardedTieredStore as JShStore
from repro.memstore import TieredSpec as JSpec
from repro.memstore import TieredValueStore as JStore
from repro.models import transformer as j_tf
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import OverlayManager as JOverlayManager
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import TenantOverlay as JTenantOverlay
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import memctl, quant
from repro_torch.core import lookup, lram, overlay
from repro_torch.distributed import context
from repro_torch.distributed.sharded_lram import ShardedTieredStore
from repro_torch.launch import convert, serve
from repro_torch.memstore import TieredSpec, TieredValueStore
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (EngineConfig, Request, ServeEngine,
                                 synthetic_trace)
from repro_torch.serving.overlay import OverlayManager, TenantOverlay

KEY = jax.random.PRNGKey(0)
KW = dict(log2_locations=16, m=8, heads=2, query_norm="rms")
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


def _roundtrip(v, storage):
    """What one overlay write stores, by the JAX package's codec."""
    v = np.asarray(v, np.float32)
    if storage == "fp32":
        return v.copy()
    q, scale = j_quant.quantize_rows_np(v, storage)
    return j_quant.dequantize_rows_np(
        q[None], np.asarray([scale], np.float32))[0]


def _row(seed, m=4):
    return np.random.default_rng(seed).normal(size=m).astype(np.float32)


# ---------------------------------------------------------------------------
# the pure-dict models of tests/test_overlay.py
# ---------------------------------------------------------------------------

class RefOverlay:
    """Per-layer row -> effective fp32 value, insertion-order recency,
    the oldest evicted beyond capacity."""

    def __init__(self, num_layers, m, storage, cap):
        self.m, self.storage, self.cap = m, storage, cap
        self.rows = [collections.OrderedDict() for _ in range(num_layers)]

    def write(self, layer, row, v):
        od = self.rows[layer]
        od.pop(row, None)
        od[row] = _roundtrip(v, self.storage)
        while len(od) > self.cap:
            od.popitem(last=False)

    def read(self, layer, row):
        return self.rows[layer].get(row)

    def evict(self, layer, row):
        return self.rows[layer].pop(row, None) is not None


def _assert_overlay_matches(ov: TenantOverlay, ref: RefOverlay):
    assert ov.num_rows == sum(len(od) for od in ref.rows)
    for layer, od in enumerate(ref.rows):
        assert ov.packed_rows(layer) == list(od)
        for row, want in od.items():
            np.testing.assert_array_equal(ov.read(layer, row), want)


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_tenant_overlay_matches_reference_model(data):
    """Random write / read / evict interleavings: the port's overlay
    (reads, row count, recency) equals the pure-dict model exactly, for
    every storage kind."""
    storage = data.draw(st.sampled_from(STORAGES))
    cap = data.draw(st.integers(min_value=1, max_value=4))
    layers = data.draw(st.integers(min_value=1, max_value=2))
    ops = data.draw(st.lists(
        st.tuples(
            st.sampled_from(["write", "read", "evict"]),
            st.integers(min_value=0, max_value=1),
            st.integers(min_value=0, max_value=7),
            st.integers(min_value=0, max_value=999),
        ),
        max_size=50,
    ))
    ov = TenantOverlay("t", num_layers=layers, m=4, storage=storage,
                       max_rows=cap)
    ref = RefOverlay(layers, 4, storage, cap)
    for op, layer, row, seed in ops:
        layer %= layers
        if op == "write":
            ov.write(layer, row, _row(seed))
            ref.write(layer, row, _row(seed))
        elif op == "read":
            got, want = ov.read(layer, row), ref.read(layer, row)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)
        else:
            assert ov.evict(layer, row) == ref.evict(layer, row)
        _assert_overlay_matches(ov, ref)


def _filled(cls, storage, seed=3):
    rng = np.random.default_rng(seed)
    ov = cls("u/1", num_layers=2, m=4, storage=storage, max_rows=8)
    for _ in range(12):
        ov.write(int(rng.integers(0, 2)), int(rng.integers(0, 16)),
                 rng.normal(size=4).astype(np.float32))
    ov.last_used_tick = 7
    return ov


def _same_overlay(a, b):
    assert (a.tenant_id, a.storage, a.last_used_tick, a.writes) == \
        (b.tenant_id, b.storage, b.last_used_tick, b.writes)
    for layer in range(a.num_layers):
        assert a.packed_rows(layer) == b.packed_rows(layer)
        for row in a.packed_rows(layer):
            np.testing.assert_array_equal(a.read(layer, row),
                                          b.read(layer, row))


@pytest.mark.parametrize("storage", STORAGES)
def test_tenant_overlay_save_load_roundtrip(storage, tmp_path):
    """The port's npz is lossless in storage form (1-byte payloads as
    uint8 views; scales and recency survive), and its writes equal the
    JAX package's overlay under the same writes."""
    ov = _filled(TenantOverlay, storage)
    _same_overlay(ov, _filled(JTenantOverlay, storage))
    path = str(tmp_path / "ov.npz")
    ov.save(path)
    _same_overlay(TenantOverlay.load(path, m=4), ov)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_overlay_files_cross_packages(storage, writer, tmp_path):
    """A tenant's `.npz` written by either package loads in the other:
    the same tenant, counters, recency and rows (the payload bytes and
    scales bit for bit)."""
    classes = {"port": TenantOverlay, "jax": JTenantOverlay}
    reader = "jax" if writer == "port" else "port"
    path = str(tmp_path / "ov.npz")
    src = _filled(classes[writer], storage)
    src.save(path)
    back = classes[reader].load(path, m=4)
    _same_overlay(back, src)
    with np.load(path) as z:
        files = {k: z[k] for k in z.files}
    other = str(tmp_path / "again.npz")
    back.save(other)
    with np.load(other) as z:
        assert sorted(z.files) == sorted(files)
        for k in z.files:
            assert z[k].dtype == files[k].dtype, k
            np.testing.assert_array_equal(z[k], files[k], err_msg=k)


# ---------------------------------------------------------------------------
# the manager against the pure-dict model
# ---------------------------------------------------------------------------

class _RefManager:
    """attach / detach / writeback / enforce by plain loops."""

    def __init__(self, base, storage, slots, cap, lr, spill_dir):
        self.base = base
        self.L, _, self.m = base.shape
        self.storage, self.cap, self.lr = storage, cap, lr
        self.spill_dir = spill_dir
        self.slot_tenant = [None] * slots
        self.overlays = {}
        self.spilled = {}
        self.last_used = {}

    def _get(self, tid):
        if tid not in self.overlays:
            self.overlays[tid] = RefOverlay(self.L, self.m, self.storage,
                                            self.cap)
            self.last_used.setdefault(tid, 0)
        ov = self.overlays[tid]
        parked = self.spilled.pop(tid, None)
        if parked is not None and not any(len(od) for od in ov.rows):
            self.overlays[tid] = ov = parked
        return ov

    def attach(self, slot, tid, tick):
        self.detach(slot)
        if tid is None:
            return
        self._get(tid)
        self.last_used[tid] = max(self.last_used[tid], tick)
        self.slot_tenant[slot] = tid

    def detach(self, slot):
        self.slot_tenant[slot] = None

    def effective(self, tid, layer, row):
        got = self.overlays[tid].read(layer, row)
        return self.base[layer][row] if got is None else got

    def writeback(self, slot, idx, w, y, tick):
        tid = self.slot_tenant[slot]
        if tid is None:
            return
        ov = self.overlays[tid]
        for layer in range(self.L):
            flat = idx[layer].reshape(-1)
            k = idx[layer].shape[-1]
            agg = {}
            for i, r in enumerate(flat.tolist()):
                contrib = (w[layer].reshape(-1)[i]
                           * y[layer][i // k]).astype(np.float32)
                agg[r] = agg.get(r, np.zeros(self.m, np.float32)) + contrib
            for r in sorted(agg):
                ov.write(layer, r, self.effective(tid, layer, r)
                         + self.lr * agg[r])
        self.last_used[tid] = max(self.last_used[tid], tick)

    def nbytes(self, tid):
        kind = None if self.storage == "fp32" else self.storage
        return (sum(len(od) for od in self.overlays[tid].rows)
                * j_quant.bytes_per_entry(self.m, kind))

    def enforce(self, tick, ttl, budget):
        attached = {t for t in self.slot_tenant if t is not None}

        def offload(tid):
            if self.spill_dir is not None:
                self.spilled[tid] = self.overlays[tid]
            self.overlays[tid] = RefOverlay(self.L, self.m, self.storage,
                                            self.cap)

        if ttl is not None:
            for tid in list(self.overlays):
                if tid in attached or self.nbytes(tid) == 0:
                    continue
                if tick - self.last_used[tid] >= ttl:
                    offload(tid)
        if budget is not None:
            total = sum(self.nbytes(t) for t in self.overlays)
            if total > budget:
                lru = sorted((self.last_used[t], t) for t in self.overlays
                             if t not in attached and self.nbytes(t) > 0)
                for _, tid in lru:
                    if total <= budget:
                        break
                    total -= self.nbytes(tid)
                    offload(tid)


def _assert_manager_matches(mgr: OverlayManager, ref: _RefManager):
    assert mgr.slot_tenant == ref.slot_tenant
    assert set(mgr.overlays) == set(ref.overlays)
    for tid, rov in ref.overlays.items():
        _assert_overlay_matches(mgr.overlays[tid], rov)
    for b, tid in enumerate(mgr.slot_tenant):
        if tid is None:
            assert (mgr.ids[:, b] == -1).all()
            assert (mgr.deltas[:, b] == 0.0).all()
            continue
        for layer in range(ref.L):
            packed = list(ref.overlays[tid].rows[layer])
            n = len(packed)
            assert mgr.ids[layer, b, :n].tolist() == packed
            assert (mgr.ids[layer, b, n:] == -1).all()
            for j, r in enumerate(packed):
                np.testing.assert_array_equal(
                    mgr.deltas[layer, b, j],
                    ref.effective(tid, layer, r) - ref.base[layer][r])


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_manager_matches_reference_under_interleavings(data):
    """Random attach / detach / writeback / enforce interleavings: the
    port's tenant rows, recency, packs (delta = effective - base) and
    spill-restore-on-attach match the pure-dict model exactly."""
    storage = data.draw(st.sampled_from(STORAGES))
    spill = data.draw(st.booleans())
    L, m, slots, cap, N, heads, k = 2, 4, 2, 3, 16, 2, 2
    rng = np.random.default_rng(
        data.draw(st.integers(min_value=0, max_value=2**31)))
    base = rng.normal(size=(L, N, m)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        spill_dir = tmp if spill else None
        mgr = OverlayManager(num_layers=L, m=m, storage=storage,
                             slots=slots, rows=cap, write_lr=0.5,
                             spill_dir=spill_dir)
        mgr.set_base_reader(
            lambda layer, rows: base[layer][np.asarray(rows, np.int64)])
        ref = _RefManager(base, storage, slots, cap, 0.5, spill_dir)
        tick = 0
        for _ in range(data.draw(st.integers(min_value=1, max_value=30))):
            op = data.draw(st.sampled_from(
                ["attach", "detach", "writeback", "enforce", "tick"]))
            if op == "tick":
                tick += data.draw(st.integers(min_value=1, max_value=3))
            elif op == "attach":
                slot = data.draw(st.integers(min_value=0,
                                             max_value=slots - 1))
                tid = data.draw(st.sampled_from(["A", "B", "C", None]))
                mgr.attach(slot, tid, tick=tick)
                ref.attach(slot, tid, tick)
            elif op == "detach":
                slot = data.draw(st.integers(min_value=0,
                                             max_value=slots - 1))
                mgr.detach(slot)
                ref.detach(slot)
            elif op == "writeback":
                slot = data.draw(st.integers(min_value=0,
                                             max_value=slots - 1))
                r2 = np.random.default_rng(
                    data.draw(st.integers(min_value=0, max_value=999)))
                idx = r2.integers(0, N, size=(L, heads, k))
                w = r2.normal(size=(L, heads, k)).astype(np.float32)
                y = r2.normal(size=(L, heads, m)).astype(np.float32)
                mgr.writeback(slot, idx, w, y, tick=tick)
                ref.writeback(slot, idx, w, y, tick)
            else:
                ttl = data.draw(st.sampled_from([None, 1, 3]))
                budget = data.draw(st.sampled_from([None, 0, 64]))
                mgr.enforce(tick=tick, ttl_ticks=ttl, budget_bytes=budget)
                ref.enforce(tick, ttl, budget)
            _assert_manager_matches(mgr, ref)


def test_enforce_never_touches_attached_tenants(tmp_path):
    """TTL expiry and budget pressure offload only detached tenants; the
    spilled one is restored on its next attach (the JAX manager's events
    and state under the same calls)."""
    base = np.zeros((1, 8, 4), np.float32)
    events = []
    for cls, sub in ((OverlayManager, "port"), (JOverlayManager, "jax")):
        mgr = cls(num_layers=1, m=4, storage="fp32", slots=2, rows=4,
                  spill_dir=str(tmp_path / sub))
        mgr.set_base_reader(lambda layer, rows: base[layer][rows])
        mgr.attach(0, "inflight", tick=0)
        for tid in ("inflight", "idle"):
            mgr.get(tid).write(0, 3, np.ones(4, np.float32))
        ev = mgr.enforce(tick=100, ttl_ticks=1, budget_bytes=0)
        assert [e["tenant"] for e in ev] == ["idle"]
        assert ev[0]["action"] == "spill"
        assert mgr.get("inflight").num_rows == 1
        assert mgr.overlays["idle"].num_rows == 0
        mgr.attach(1, "idle", tick=101)
        assert mgr.stats["restores"] == 1
        np.testing.assert_array_equal(mgr.get("idle").read(0, 3),
                                      np.ones(4, np.float32))
        events.append(ev)
    assert events[0] == events[1]


def test_enforce_without_spill_dir_drops():
    for cls in (OverlayManager, JOverlayManager):
        mgr = cls(num_layers=1, m=4, storage="fp32", slots=1, rows=4)
        mgr.set_base_reader(lambda layer, rows: np.zeros((len(rows), 4),
                                                         np.float32))
        mgr.get("gone").write(0, 1, np.ones(4, np.float32))
        events = mgr.enforce(tick=9, ttl_ticks=1)
        assert events[0]["action"] == "drop" and mgr.stats["drops"] == 1
        mgr.attach(0, "gone", tick=10)
        assert mgr.get("gone").num_rows == 0


def _write_tenants(mgr, seed=0):
    rng = np.random.default_rng(seed)
    for tid in ("a", "b/c"):
        for i in range(3):
            mgr.get(tid).write(i % 2, i, rng.normal(size=4))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manager_save_all_load_all_roundtrip(tmp_path, writer):
    """`save_all` of either package, `load_all` of both: every tenant's
    rows and recency back; another storage kind refused by name."""
    classes = {"port": OverlayManager, "jax": JOverlayManager}
    kw = dict(num_layers=2, m=4, storage="int8", slots=1, rows=4)
    mgr = classes[writer](**kw)
    _write_tenants(mgr)
    assert mgr.save_all(str(tmp_path)) == 2
    assert sorted(os.listdir(tmp_path)) == ["overlay_a.npz",
                                            "overlay_b-2fc.npz"]
    for cls in classes.values():
        back = cls(**kw)
        assert back.load_all(str(tmp_path)) == 2
        for tid in ("a", "b/c"):
            _same_overlay(back.overlays[tid], mgr.overlays[tid])
    with pytest.raises(ValueError, match="expects"):
        OverlayManager(**dict(kw, storage="fp8")).load_all(str(tmp_path))


# ---------------------------------------------------------------------------
# the plans' capability flag and the base-row reader
# ---------------------------------------------------------------------------

def test_supports_overlay_capability_matrix():
    """`supports_overlay` where the reference sets it: dense fp32 and
    1-byte, tiered, sharded-tiered; not on the row-sharded plan."""
    cells = [
        dict(),
        dict(table_quant="int8"),
        dict(interp_impl="pallas", table_quant="fp8"),
        dict(interp_impl="tiered", table_quant="fp8"),
        dict(interp_impl="sharded-tiered", model_shards=4),
    ]
    for cell in cells:
        kw = dict(KW, **cell)
        if kw.get("interp_impl") == "tiered":
            specs = (TieredSpec(shard_rows=4096, cache_slots=4),
                     JSpec(shard_rows=4096, cache_slots=4))
        elif kw.get("interp_impl") == "sharded-tiered":
            specs = (TieredSpec(shard_rows=2048, cache_slots=2),
                     JSpec(shard_rows=2048, cache_slots=2))
        else:
            specs = (None, None)
        port = lookup.resolve(lram.LRAMConfig(**kw, tiered=specs[0]))
        ref = j_lookup.resolve(j_lram.LRAMConfig(**kw, tiered=specs[1]))
        assert port.supports_overlay and ref.supports_overlay, cell
    j_context.set_mesh(jax.make_mesh((1,), ("model",)))
    try:
        ref = j_lookup.resolve(j_lram.LRAMConfig(**KW,
                                                 interp_impl="sharded"))
    finally:
        j_context.set_mesh(None)
    assert not ref.supports_overlay
    context.set_mesh(_OneRankMesh())
    try:
        port = lookup.resolve(lram.LRAMConfig(**KW, interp_impl="sharded"))
    finally:
        context.set_mesh(None)
    assert not port.supports_overlay


class _OneRankMesh:
    """The mesh surface the sharded plan reads, for one rank (resolved,
    never run)."""

    axis_names = ("model",)

    def size(self, axis):
        return 1

    def index(self, axis):
        return 0

    def group(self, axis):
        return None


@pytest.mark.parametrize("storage", STORAGES)
def test_read_rows_fp32_matches_table_forms(storage):
    """The base-row reader agrees with the JAX package's over the dense
    (tensor or `QuantizedTable`), tiered and sharded-tiered forms, bit
    for bit (the same payloads)."""
    rng = np.random.default_rng(11)
    dense = rng.normal(size=(1024, 8)).astype(np.float32)
    rows = rng.integers(0, 1024, size=(16,))
    kind = None if storage == "fp32" else storage
    spec = TieredSpec(shard_rows=256, cache_slots=4,
                      quant=kind or "none")
    jspec = JSpec(shard_rows=256, cache_slots=4, quant=kind or "none")
    if kind is None:
        want = dense[rows]
        j_dense = j_lookup.read_rows_fp32(jnp.asarray(dense), rows)
        got_dense = lookup.read_rows_fp32(torch.from_numpy(dense), rows)
    else:
        qt = j_quant.QuantizedTable.from_dense(dense, storage)
        want = j_quant.dequantize_rows_np(np.asarray(qt.q)[rows],
                                          np.asarray(qt.scale)[rows])
        j_dense = j_lookup.read_rows_fp32(qt, rows)
        got_dense = lookup.read_rows_fp32(
            quant.QuantizedTable.from_dense(dense, storage), rows)
    np.testing.assert_array_equal(j_dense, want)
    np.testing.assert_array_equal(got_dense, want)
    for port, ref in (
            (TieredValueStore.from_dense(dense, spec),
             JStore.from_dense(dense, jspec)),
            (ShardedTieredStore.from_dense(dense, spec, 2),
             JShStore.from_dense(dense, jspec, 2))):
        np.testing.assert_array_equal(lookup.read_rows_fp32(port, rows),
                                      j_lookup.read_rows_fp32(ref, rows))


def test_delta_correction_matches_reference():
    """The correction alone: the exact id match and the two contractions
    against the JAX package's, an empty pack exactly 0."""
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 64, size=(3, 5, 2, 4)).astype(np.int32)
    w = rng.random(size=idx.shape).astype(np.float32)
    ids = np.full((3, 6), -1, np.int32)
    ids[:, :4] = rng.integers(0, 64, size=(3, 4))
    deltas = rng.normal(size=(3, 6, 8)).astype(np.float32)
    got = overlay.delta_correction(*map(torch.from_numpy,
                                        (idx, w, ids, deltas))).numpy()
    from repro.core import overlay as j_overlay

    want = np.asarray(j_overlay.delta_correction(idx, w, ids, deltas))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    empty = overlay.delta_correction(
        torch.from_numpy(idx), torch.from_numpy(w),
        torch.full((3, 6), -1, dtype=torch.int32), torch.zeros(3, 6, 8))
    assert (empty == 0).all()
    with pytest.raises(RuntimeError, match="do not nest"):
        with overlay.activate(torch.zeros(1, 1, 1), torch.zeros(1, 1, 1, 1)):
            with overlay.activate(torch.zeros(1, 1, 1),
                                  torch.zeros(1, 1, 1, 1)):
                pass
    assert overlay.current() is None


# ---------------------------------------------------------------------------
# the serve engine on the reference's tiny model
# ---------------------------------------------------------------------------

def _tiny_cfgs(**lram_kw):
    """The reference's `_tiny_cfg`, port and JAX."""
    lram_kw.setdefault("query_norm", "rms")
    lram_kw.setdefault("interp_impl", "reference")
    out = []
    for mod, mc in ((lram, ModelConfig), (j_lram, JModelConfig)):
        out.append(mc(
            name="tiny-overlay", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=97,
            objective="clm", remat=False, lram_layers=(1,),
            lram=mod.memffn_config(32, 16, **lram_kw)))
    return tuple(out)


def _np(tree):
    """The reference's tree as the converter takes it: numpy leaves, a
    `QuantizedTable` as its payload (e4m3 as uint8 bytes) and scales."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, j_quant.QuantizedTable):
        q = np.asarray(tree.q)
        return {"q": q if q.dtype == np.int8 else q.view(np.uint8),
                "scale": np.asarray(tree.scale)}
    return np.asarray(tree)


class _Tiny:
    """The reference's tiny memory model, its JAX weights and a port
    model of them (fresh each call: the engine mutates the KV cache, a
    store its cache)."""

    def __init__(self, **lram_kw):
        self.cfg, self.j_cfg = _tiny_cfgs(**lram_kw)
        self.params, self.state = j_tf.init(KEY, self.j_cfg)

    def model(self):
        return convert.model_from_jax(_np(self.params), _np(self.state),
                                      self.cfg, device="cpu")

    def jax_engine(self, **kw):
        return JServeEngine(self.params, self.state, self.j_cfg,
                            JEngineConfig(**kw))


@pytest.fixture(scope="module")
def tiny():
    return _Tiny()


def _trace(seed, n, **kw):
    """The same trace for both packages."""
    kw = dict(dict(vocab_size=97, max_prompt=6, max_gen=5), **kw)
    return (synthetic_trace(np.random.default_rng(seed), n, **kw),
            j_synthetic_trace(np.random.default_rng(seed), n, **kw))


def test_engine_rejects_overlay_without_memory_arch():
    from repro_torch import configs

    cfg = configs.get_smoke_config("qwen2-1.5b")
    with pytest.raises(ValueError, match="memory arch"):
        ServeEngine(transformer.init(cfg), EngineConfig(
            slots=1, max_len=8, overlay_rows=4))


def test_empty_overlay_is_bit_exact_vs_no_overlay(tiny, one_thread):
    """An anonymous trace through an overlay-enabled engine gives the
    overlay-free engine's tokens and first logits bit for bit (the empty
    pack adds exactly 0), and the JAX engine's tokens."""
    trace, j_trace = _trace(0, 4)
    plain = ServeEngine(tiny.model(), EngineConfig(slots=2, max_len=12)) \
        .run(trace)
    overlaid = ServeEngine(tiny.model(), EngineConfig(
        slots=2, max_len=12, overlay_rows=4)).run(trace)
    ref = tiny.jax_engine(slots=2, max_len=12, overlay_rows=4).run(j_trace)
    for a, b, c in zip(plain.requests, overlaid.requests, ref.requests):
        assert a.id == b.id == c.id and a.tokens == b.tokens == c.tokens
        np.testing.assert_array_equal(a.first_logits, b.first_logits)
        np.testing.assert_allclose(b.first_logits, c.first_logits,
                                   atol=1e-5)


def test_retire_frees_overlay_and_never_recompiles(tiny):
    """Retirement detaches the tenant (packs empty, nothing leaks), and
    the run's overlay summary equals the JAX engine's, row for row of
    the report; on the CPU no graph is captured."""
    trace, j_trace = _trace(1, 5, tenants=2)
    engine = ServeEngine(tiny.model(), EngineConfig(
        slots=2, max_len=12, overlay_rows=6))
    report = engine.run(trace)
    mgr = engine.overlays
    assert mgr.attached == 0
    assert (mgr.ids == -1).all() and (mgr.deltas == 0.0).all()
    assert mgr.stats["attaches"] == mgr.stats["detaches"] > 0
    assert mgr.stats["writebacks"] > 0
    assert report.graph_captures == 0 and not report.cuda_graph
    assert len(report.overlay_s) == len(report.step_s)
    assert report.overlay is not None and report.overlay["tenants"] == 2
    assert any(r[0] == "serve_overlay" for r in report.rows())
    assert report.summary(tiny.cfg.name)["overlay"]["attaches"] > 0
    ref = tiny.jax_engine(slots=2, max_len=12, overlay_rows=6).run(j_trace)
    for k in ("tenants", "attaches", "detaches", "writebacks", "rows",
              "bytes", "overlay_lookups"):
        assert report.overlay[k] == ref.overlay[k], k
    assert [r.tokens for r in report.requests] == \
        [r.tokens for r in ref.requests]


def _forced_logits(engine, packs, cache_fn):
    """One decode step of token 5 at position 3 on a fresh cache."""
    engine.cache = cache_fn()
    with torch.inference_mode():
        logits, access = engine._step(torch.tensor([[5]]),
                                      torch.tensor([3]), packs)
    return logits.numpy(), access


def test_overlay_correction_reaches_decode_logits(tiny):
    """A pack whose ids cover the rows one decode step visits moves that
    step's logits, within 1e-5 of the JAX engine's under the same pack;
    the same pack emptied does not move them."""
    j_engine = tiny.jax_engine(slots=1, max_len=12, overlay_rows=8)
    tok, pos = jnp.array([[5]], jnp.int32), jnp.array([3], jnp.int32)
    empty_ids = np.full_like(j_engine.overlays.ids, -1)
    empty_deltas = np.zeros_like(j_engine.overlays.deltas)
    j0, _, access = j_engine._decode(tok, pos,
                                     j_tf.init_cache(tiny.j_cfg, 1, 12),
                                     jnp.asarray(empty_ids),
                                     jnp.asarray(empty_deltas))
    visited = np.unique(np.asarray(access[0])[0].reshape(-1))[:8]
    ids, deltas = empty_ids.copy(), empty_deltas.copy()
    ids[0, 0, :len(visited)] = visited
    deltas[0, 0, :len(visited)] = 5.0
    j1, _, _ = j_engine._decode(tok, pos, j_tf.init_cache(tiny.j_cfg, 1, 12),
                                jnp.asarray(ids), jnp.asarray(deltas))

    engine = ServeEngine(tiny.model(), EngineConfig(
        slots=1, max_len=12, overlay_rows=8))

    def cache():
        return transformer.init_cache(tiny.cfg, 1, 12, "cpu")

    p0, p_access = _forced_logits(engine, (torch.from_numpy(empty_ids),
                                           torch.from_numpy(empty_deltas)),
                                  cache)
    np.testing.assert_array_equal(p_access[0].numpy(),
                                  np.asarray(access[0]))
    p1, _ = _forced_logits(engine, (torch.from_numpy(ids),
                                    torch.from_numpy(deltas)), cache)
    assert not np.array_equal(p1, p0)
    np.testing.assert_allclose(p0, np.asarray(j0), atol=1e-5)
    np.testing.assert_allclose(p1, np.asarray(j1), atol=1e-5)


def _base_table(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    (values,) = [v for path, v in flat
                 if "lram" in str(path) and "values" in str(path)]
    return np.asarray(values, np.float32)


def test_writeback_pack_deltas_match_base_table(tiny):
    """After serving one tenant, re-attaching fills the pack with delta =
    dequant(overlay row) - base row, checked against the table itself;
    ids equal the JAX engine's pack, deltas within 1e-6 of it."""
    req = dict(id=0, prompt=np.arange(1, 7, dtype=np.int32),
               max_new_tokens=6, tenant_id="A")
    ecfg = dict(slots=1, max_len=14, overlay_rows=32, overlay_write_lr=1.0)
    engine = ServeEngine(tiny.model(), EngineConfig(**ecfg))
    engine.run([Request(**req)])
    j_engine = tiny.jax_engine(**ecfg)
    j_engine.run([JRequest(**req)])
    ov = engine.overlays.get("A")
    assert ov.num_rows > 0 and ov.writes > 0
    engine.overlays.attach(0, "A", tick=99)
    j_engine.overlays.attach(0, "A", tick=99)
    base = _base_table(tiny.params)
    packed = ov.packed_rows(0)
    assert engine.overlays.ids[0, 0, :len(packed)].tolist() == packed
    for j, r in enumerate(packed):
        np.testing.assert_array_equal(engine.overlays.deltas[0, 0, j],
                                      ov.read(0, r) - base[r])
    np.testing.assert_array_equal(engine.overlays.ids,
                                  j_engine.overlays.ids)
    np.testing.assert_allclose(engine.overlays.deltas,
                               j_engine.overlays.deltas, atol=1e-6)


def test_mixed_tenants_match_each_tenant_alone(tiny, one_thread):
    """A mixed-tenant run gives each tenant's tokens and first logits bit
    for bit as the tenant alone does, and the JAX engine's tokens."""
    trace, j_trace = _trace(3, 4, max_gen=6)
    for i, (req, j_req) in enumerate(zip(trace, j_trace)):
        req.tenant_id = j_req.tenant_id = f"T{i}"
    ecfg = EngineConfig(slots=2, max_len=12, overlay_rows=6)
    mixed = ServeEngine(tiny.model(), ecfg).run(trace)
    ref = tiny.jax_engine(slots=2, max_len=12, overlay_rows=6).run(j_trace)
    assert [r.tokens for r in mixed.requests] == \
        [r.tokens for r in ref.requests]
    for req in trace:
        alone = ServeEngine(tiny.model(), ecfg).run([req])
        got = next(r for r in mixed.requests if r.id == req.id)
        want = alone.requests[0]
        assert got.tokens == want.tokens
        np.testing.assert_array_equal(got.first_logits, want.first_logits)


def _same_rows(port_mgr, ref_mgr, *, atol, storage):
    """Every tenant's overlay rows of the port's run against the JAX
    run's: the same ids in the same order; fp32 rows within `atol`,
    1-byte payloads within one quantum."""
    assert set(port_mgr.overlays) == set(ref_mgr.overlays)
    for tid, ov in port_mgr.overlays.items():
        rov = ref_mgr.overlays[tid]
        for layer in range(ov.num_layers):
            assert ov.packed_rows(layer) == rov.packed_rows(layer)
            for r in ov.packed_rows(layer):
                if storage == "fp32":
                    np.testing.assert_allclose(ov.read(layer, r),
                                               rov.read(layer, r),
                                               atol=atol)
                    continue
                (q, s), (rq, rs) = ov.rows[layer][r], rov.rows[layer][r]
                rq = np.asarray(rq).view(np.uint8) \
                    if storage == "fp8" else np.asarray(rq)
                if storage == "int8":
                    assert np.abs(q.astype(np.int32)
                                  - rq.astype(np.int32)).max() <= 1
                np.testing.assert_allclose(
                    ov.read(layer, r), rov.read(layer, r),
                    atol=float(max(s, rs)) * j_quant.qmax(storage) / 8
                    if storage == "fp8" else float(max(s, rs)) * 1.0001)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_engine_writeback_tracks_jax(storage):
    """End to end: the same tenants' trace through both engines; the
    tokens equal and the overlay rows of every tenant agree (fp32 within
    1e-5, 1-byte payloads within one quantum); int8 overlays hold int8
    payloads."""
    kind = {} if storage == "fp32" else dict(table_quant=storage)
    t = _Tiny(**kind)
    trace, j_trace = _trace(4, 3, tenants=2)
    ecfg = dict(slots=2, max_len=10, overlay_rows=4)
    engine = ServeEngine(t.model(), EngineConfig(**ecfg))
    report = engine.run(trace)
    j_engine = t.jax_engine(**ecfg)
    ref = j_engine.run(j_trace)
    assert engine.overlays.storage == storage
    assert [r.tokens for r in report.requests] == \
        [r.tokens for r in ref.requests]
    assert report.overlay["writebacks"] == ref.overlay["writebacks"] > 0
    if storage != "fp32":
        for ov in engine.overlays.overlays.values():
            for od in ov.rows:
                for payload, scale in od.values():
                    assert payload.dtype == np.int8 and scale is not None
    _same_rows(engine.overlays, j_engine.overlays, atol=1e-5,
               storage=storage)


@pytest.mark.parametrize("storage", STORAGES)
def test_manager_writeback_fed_jax_accesses_bit_equal(storage):
    """The manager's write-back fed the JAX engine's own decode accesses
    (idx, w, y) over the same base rows: the port's overlay rows equal
    the JAX manager's bit for bit, payloads and scales."""
    j_engine = _Tiny().jax_engine(slots=1, max_len=12, overlay_rows=8)
    base = _base_table(_Tiny().params)[None]
    mgrs = []
    for cls in (OverlayManager, JOverlayManager):
        mgr = cls(num_layers=1, m=64, storage=storage, slots=1, rows=8,
                  write_lr=0.5)
        mgr.set_base_reader(lambda layer, rows: base[layer][rows])
        mgr.attach(0, "A", tick=0)
        mgrs.append(mgr)
    cache = j_tf.init_cache(j_engine.cfg, 1, 12)
    ids = jnp.asarray(np.full_like(j_engine.overlays.ids, -1))
    deltas = jnp.asarray(np.zeros_like(j_engine.overlays.deltas))
    for step, tok in enumerate((5, 17, 40, 5)):
        _, cache, access = j_engine._decode(
            jnp.array([[tok]], jnp.int32), jnp.array([step], jnp.int32),
            cache, ids, deltas)
        idx_a, w_a, y_a = (np.asarray(a) for a in access)
        for mgr in mgrs:
            mgr.writeback(0, idx_a[:, 0, 0], w_a[:, 0, 0], y_a[:, 0, 0],
                          tick=step + 1)
    port, ref = (m.overlays["A"] for m in mgrs)
    assert port.packed_rows(0) == ref.packed_rows(0)
    assert port.writes == ref.writes > 0
    for r in port.packed_rows(0):
        (q, s), (rq, rs) = port.rows[0][r], ref.rows[0][r]
        rq = np.asarray(rq)
        np.testing.assert_array_equal(
            q, rq.view(np.uint8) if storage == "fp8" else rq)
        assert (s is None) == (rs is None) and (s is None or s == rs)
    np.testing.assert_array_equal(mgrs[0].ids, mgrs[1].ids)
    np.testing.assert_array_equal(mgrs[0].deltas, mgrs[1].deltas)


# ---------------------------------------------------------------------------
# lifecycle: the controller's overlay tick, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ttl,budget_kb", [(2, None), (None, 0.25),
                                           (1, 0.25)])
def test_controller_overlay_lifecycle_preserves_generation(
        tiny, tmp_path, ttl, budget_kb):
    """The TTL / byte-budget schedule through `MemoryController`: every
    token equals the run without the lifecycle and the JAX engine's under
    the same policy; the events are the JAX controller's, all spills."""
    trace, j_trace = _trace(5, 6, max_gen=6, tenants=2)
    ecfg = dict(slots=2, max_len=12, overlay_rows=6)
    want = {r.id: r.tokens for r in
            ServeEngine(tiny.model(), EngineConfig(**ecfg)).run(trace)
            .requests}
    budget = int(budget_kb * 1024) if budget_kb is not None else None
    ctl = memctl.MemoryController(memctl.LifecyclePolicy(
        tenant_ttl_ticks=ttl, tenant_budget_bytes=budget,
        overlay_spill_dir=str(tmp_path / "port")))
    engine = ServeEngine(tiny.model(), EngineConfig(**ecfg), controller=ctl)
    got = {r.id: r.tokens for r in engine.run(trace).requests}
    assert got == want
    assert all(e["event"].startswith("overlay_") for e in ctl.events)
    assert all(e["action"] == "spill" for e in ctl.events)
    if ctl.events:
        assert engine.overlays.stats["spills"] == len(ctl.events)
    j_ctl = j_memctl.MemoryController(j_memctl.LifecyclePolicy(
        tenant_ttl_ticks=ttl, tenant_budget_bytes=budget,
        overlay_spill_dir=str(tmp_path / "jax")))
    ref = JServeEngine(tiny.params, tiny.state, tiny.j_cfg,
                       JEngineConfig(**ecfg), controller=j_ctl).run(j_trace)
    assert got == {r.id: r.tokens for r in ref.requests}
    assert [(e["event"], e["tenant"], e["tick"]) for e in ctl.events] == \
        [(e["event"], e["tenant"], e["tick"]) for e in j_ctl.events]


def test_serve_cli_multitenant_e2e(tmp_path, capsys):
    """The serve CLI end to end: a multi-tenant trace with the lifecycle
    flags, the overlays saved at the end and restored by a relaunch
    (`{"restored_overlays": n}`); the files load in the JAX package."""
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "4", "--gen", "3", "--tenants", "2", "--overlay-rows", "6",
            "--overlay-ttl", "50", "--overlay-budget-kb", "64",
            "--overlay-dir", str(tmp_path / "ov")]
    report = serve.main(args)
    assert report.overlay is not None and report.overlay["tenants"] >= 1
    saved = sorted(os.listdir(tmp_path / "ov"))
    assert saved and all(f.startswith("overlay_") and f.endswith(".npz")
                         for f in saved)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["overlay"]["tenants"] == report.overlay["tenants"]
    report2 = serve.main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == {"restored_overlays": len(saved)}
    assert report2.overlay["tenants"] >= 1
    j_mgr = JOverlayManager(num_layers=1, m=64, storage="fp32", slots=2,
                            rows=6)
    assert j_mgr.load_all(str(tmp_path / "ov")) == len(saved)


def test_serve_cli_overlay_dir_defaults_beside_the_checkpoint(tmp_path,
                                                             capsys):
    """`--tenants` with `--ckpt-dir`: the overlays go to
    `<ckpt-dir>/overlays`, as the reference's CLI puts them, and a
    relaunch restores both the checkpoint (the directory beside its steps
    is not one) and the overlays."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager

    model = transformer.init(configs.get_smoke_config("lram-tiered"))
    CheckpointManager(str(tmp_path)).save(1, convert.reference_tree(model))
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "4", "--gen", "3", "--tenants", "2", "--ckpt-dir", str(tmp_path)]
    serve.main(argv)
    parked = [f for f in os.listdir(tmp_path / "overlays")
              if f.startswith("overlay_")]
    assert parked
    capsys.readouterr()
    serve.main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[:2] == [{"restored_step": 1},
                         {"restored_overlays": len(parked)}]
