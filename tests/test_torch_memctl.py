"""The port's memory lifecycle manager (`repro_torch.memctl`) against the
JAX package's (`repro.memctl`), case for case with `tests/test_memctl.py`:
the growth maths, growth in every placement × storage cell (the grown
table bit for bit the reference's, outputs at pre-growth points and their
gradients), tiered and sharded-tiered growth in place, `grow_model` with
Adam's moments, migration round trips, telemetry, the controller's train
schedule and serve spill, the prefetch pool, the `--grow-at --telemetry`
trainer and the grow, crash, resume and serve round trip.  Tables and
weights cross from JAX as numpy (the converter's forms); the reference
runs its `reference` cells on the CPU."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _ranks import run_ranks

from repro import configs as j_configs
from repro import memctl as j_memctl
from repro import optim as j_optim
from repro import quant as j_quant
from repro.core import indexing as j_indexing
from repro.core import lookup as j_lookup
from repro.core import lram as j_lram
from repro.distributed.sharded_lram import ShardedTieredStore as JShardedStore
from repro.launch import train as j_train
from repro.memstore import TieredSpec as JSpec
from repro.memstore import TieredValueStore as JStore
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs, memctl, optim, quant
from repro_torch.core import indexing, lookup, lram
from repro_torch.distributed import context
from repro_torch.distributed.sharded_lram import ShardedTieredStore
from repro_torch.kernels import e8_lookup
from repro_torch.launch import convert, serve, train
from repro_torch.memstore import TieredSpec, TieredValueStore, tiered_interp
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

KEY = jax.random.PRNGKey(0)
KW = dict(log2_locations=16, m=8, heads=2, query_norm="rms")
GROW_CELLS = [(p, s) for p in ("dense", "tiered", "sharded-tiered")
              for s in ("fp32", "int8", "fp8")]


def make_cfgs(placement, storage, **extra):
    """(port LRAMConfig, reference LRAMConfig) of one cell, as
    `tests/test_memctl.py`'s `make_cfg` builds it."""
    out = []
    for mod, spec in ((lram, TieredSpec), (j_lram, JSpec)):
        kw = dict(KW, **extra)
        kw["table_quant"] = "none" if storage == "fp32" else storage
        if placement == "dense":
            out.append(mod.LRAMConfig(interp_impl="reference", **kw))
            continue
        if placement == "tiered":
            kw.setdefault("tiered", spec(shard_rows=4096, cache_slots=4))
        else:
            kw.setdefault("tiered", spec(shard_rows=2048, cache_slots=2))
            kw.setdefault("model_shards", 4)
        out.append(mod.LRAMConfig(interp_impl=placement, **kw))
    return tuple(out)


def _payload(q) -> np.ndarray:
    """A payload in the port's host form (fp8 as uint8 bytes)."""
    q = np.asarray(q)
    return q if q.dtype in (np.int8, np.float32) else q.view(np.uint8)


def reference_table(table):
    """A reference table (array, QuantizedTable or store) as (payload,
    scales or None) in the port's host form."""
    if isinstance(table, (JStore, JShardedStore)):
        shards = range(table.num_shards)
        payload = np.concatenate([table.shard_host(i) for i in shards])
        scales = (None if table.quant == "none" else np.concatenate(
            [table.shard_scale_host(i) for i in shards]))
        return _payload(payload), scales
    if isinstance(table, j_quant.QuantizedTable):
        return _payload(table.q), np.asarray(table.scale)
    return np.asarray(table), None


def port_table(table):
    """A port table as (payload, scales or None) on the host."""
    if lookup.is_store(table):
        n = table.num_rows
        return table._read_rows_raw(np.arange(n))
    if isinstance(table, quant.QuantizedTable):
        q = table.q
        q = q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn else q
        return q.numpy(), table.scale.numpy()
    return table.detach().numpy(), None


def port_layer(cfg, j_table):
    """A port LRAM layer of `cfg` holding the reference's table."""
    layer = lram.LRAM(cfg)
    plan = lookup.resolve(cfg)
    payload, scales = reference_table(j_table)
    if scales is None:
        table = plan.build_table(torch.from_numpy(payload.copy()))
    else:
        table = plan.table_from_payload(payload, scales)
    lookup.set_table(layer, table)
    return layer


def _same_table(port, ref):
    p, ps = port_table(port)
    r, rs = reference_table(ref)
    np.testing.assert_array_equal(p, r)
    if rs is not None:
        np.testing.assert_array_equal(ps, rs)


def _query(cfg, q):
    return e8_lookup.lram_query_plain(q, cfg.torus_spec, cfg.top_k)


def _out_and_grad(plan, values, idx, w):
    w = w.clone().requires_grad_(True)
    y = plan.interp(values, idx, w)
    (y ** 2).sum().backward()
    return y.detach().numpy(), w.grad.numpy()


# ---------------------------------------------------------------------------
# the growth maths
# ---------------------------------------------------------------------------

def test_grow_torus_preserves_old_indices():
    old = indexing.choose_torus(16)
    new = indexing.grow_torus(old, 2)
    assert new.K == j_indexing.grow_torus(j_indexing.choose_torus(16), 2).K
    assert new.num_locations == 2 * old.num_locations
    ids = np.arange(old.num_locations)
    pts = indexing.decode_index(ids, old)
    np.testing.assert_array_equal(
        indexing.encode_points(torch.from_numpy(pts), new).numpy(), ids)


@pytest.mark.parametrize("factor", [2, 4])
def test_growth_parents_is_alias_rule(factor):
    """`j % old_N` for K_0 enlargements, and the reference's parents."""
    old = indexing.choose_torus(16)
    new = indexing.grow_torus(old, factor)
    n_old, n_new = old.num_locations, new.num_locations
    parents = indexing.growth_parents(old, new, n_old, n_new)
    np.testing.assert_array_equal(parents, np.arange(n_old, n_new) % n_old)
    j_old = j_indexing.choose_torus(16)
    np.testing.assert_array_equal(parents, j_indexing.growth_parents(
        j_old, j_indexing.grow_torus(j_old, factor), n_old, n_new))


def test_grow_torus_rejects_bad_factor():
    spec = indexing.choose_torus(16)
    with pytest.raises(ValueError, match="power of two"):
        indexing.grow_torus(spec, 3)
    with pytest.raises(ValueError, match="multiples"):
        indexing.growth_parents(indexing.grow_torus(spec, 2), spec, 0, 1)


def test_lram_config_torus_override_validated():
    spec = indexing.grow_torus(indexing.choose_torus(16), 2)
    cfg = lram.LRAMConfig(**dict(KW, log2_locations=17), torus=spec)
    assert cfg.torus_spec == spec
    with pytest.raises(ValueError, match="locations"):
        lram.LRAMConfig(**KW, torus=spec)  # 2^17 torus vs log2=16


@pytest.mark.parametrize("storage", ["fp32", "int8", "fp8"])
def test_table_bytes_per_entry_matches_reference(storage):
    cfg, j_cfg = make_cfgs("dense", storage)
    assert cfg.table_bytes_per_entry == j_cfg.table_bytes_per_entry


# ---------------------------------------------------------------------------
# growth in every placement x storage cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement,storage", GROW_CELLS)
def test_grow_reproduces_pre_growth_points(placement, storage):
    """grow(N -> 2N) on the reference's table: the grown table is the
    reference's grown table bit for bit; lookups at pre-growth points
    (re-encoded on the grown torus) give the pre-growth outputs (atol
    1e-6) and gradients in w (1e-5), and the reference's grown outputs."""
    rng = np.random.default_rng(0)
    cfg, j_cfg = make_cfgs(placement, storage)
    j_params, _ = j_lram.lram_init(KEY, j_cfg)
    layer = port_layer(cfg, j_params["values"])
    plan = lookup.resolve(cfg)
    assert plan.supports_growth == j_lookup.resolve(j_cfg).supports_growth
    q = torch.from_numpy(rng.uniform(0, 8, size=(16, 8)).astype(np.float32))
    idx_o, w = _query(cfg, q)
    y_pre, g_pre = _out_and_grad(plan, layer.values, idx_o, w)

    cfg2 = memctl.grow(layer, 2**17)
    j_params2, j_cfg2 = j_memctl.grow(j_params, j_cfg, 2**17)
    assert cfg2 == layer.cfg and cfg2.num_locations == 2**17
    assert cfg2.torus_spec.K == j_cfg2.torus_spec.K
    assert cfg2.model_shards == j_cfg2.model_shards
    _same_table(layer.values, j_params2["values"])

    plan2 = lookup.resolve(cfg2)
    idx_n, w_n = _query(cfg2, q)
    np.testing.assert_array_equal(w_n.numpy(), w.numpy())
    y_post, g_post = _out_and_grad(plan2, layer.values, idx_n, w)
    np.testing.assert_allclose(y_post, y_pre, atol=1e-6)
    np.testing.assert_allclose(g_post, g_pre, atol=1e-5)
    j_plan2 = j_lookup.resolve(j_cfg2)
    j_y = np.asarray(j_plan2.interp(j_params2["values"],
                                    jnp.asarray(idx_n.numpy()),
                                    jnp.asarray(w.numpy())))
    np.testing.assert_allclose(y_post, j_y, atol=1e-6)


class _OneRankMesh:
    """The mesh surface the sharded plan reads, for one rank (no process
    group: the plan is only resolved, never run)."""

    axis_names = ("model",)

    def size(self, axis):
        return 1

    def index(self, axis):
        return 0

    def group(self, axis):
        return None


def test_grow_rejects_bad_sizes_and_sharded():
    cfg, _ = make_cfgs("dense", "fp32")
    layer = lram.LRAM(cfg)
    with pytest.raises(ValueError, match="multiple"):
        memctl.grow(layer, 2**16 + 4096)
    with pytest.raises(ValueError, match="grow"):
        memctl.grow(layer, 2**15)
    context.set_mesh(_OneRankMesh())
    try:
        cfg_sh = lram.LRAMConfig(**KW, interp_impl="sharded")
        assert not lookup.resolve(cfg_sh).supports_growth
        with pytest.raises(lookup.LookupPlanError, match="grow"):
            memctl.grow(lram.LRAM(cfg_sh), 2**17)
    finally:
        context.set_mesh(None)


def test_tiered_grow_appends_without_touching_cache():
    """Growth appends host shards in place: the cache keeps its
    residency, no new fills, old shard ids stay valid, lookups of old
    rows are bit-identical and the appended rows alias their parents."""
    rng = np.random.default_rng(1)
    cfg, _ = make_cfgs("tiered", "fp32")
    layer = lram.LRAM(cfg)
    store = layer.values
    assert isinstance(store, TieredValueStore)
    idx = torch.from_numpy(rng.integers(0, 2**16, size=(8, 4))
                           .astype(np.int32))
    w = torch.from_numpy(rng.normal(size=idx.shape).astype(np.float32))
    y_pre = store.gather(idx, w)
    resident = store.resident_shards()
    fills = store.stats["fills"]

    memctl.grow(layer, 2**17)
    assert layer.values is store  # in place: handles stay valid
    assert store.num_rows == 2**17 and store.num_shards == 32
    assert store.resident_shards() == resident
    assert store.stats["fills"] == fills
    torch.testing.assert_close(store.gather(idx, w), y_pre, rtol=0, atol=0)
    torch.testing.assert_close(store.gather(idx + 2**16, w), y_pre, rtol=0,
                               atol=0)


def test_tiered_grow_trains_after_growth():
    """The write-back lands after growth (appended rows too) and flushes
    through the grown host tier, as the reference's does: the tables
    after the step agree to 1e-6."""
    rng = np.random.default_rng(2)
    cfg, j_cfg = make_cfgs("tiered", "fp32")
    j_params, _ = j_lram.lram_init(KEY, j_cfg)
    layer = port_layer(cfg, j_params["values"])
    store, j_store = layer.values, j_params["values"]
    memctl.grow(layer, 2**17)
    j_memctl.grow(j_params, j_cfg, 2**17)
    store.writeback_lr = j_store.writeback_lr = 0.1
    idx = rng.integers(0, 2**17, size=(16, 4)).astype(np.int32)
    w = rng.normal(size=idx.shape).astype(np.float32)
    before = store.to_dense()

    wt = torch.from_numpy(w).requires_grad_(True)
    (tiered_interp(store, torch.from_numpy(idx), wt) ** 2).sum().backward()
    from repro import memstore as j_memstore

    jax.grad(lambda w_: jnp.sum(j_memstore.tiered_interp(
        j_store, jnp.asarray(idx), w_) ** 2))(jnp.asarray(w))
    after = store.to_dense()
    touched = np.zeros(2**17, bool)
    touched[idx.reshape(-1)] = True
    assert not np.allclose(after[touched], before[touched])
    np.testing.assert_array_equal(after[~touched], before[~touched])
    np.testing.assert_allclose(after, j_store.to_dense(), atol=1e-6)


def test_sharded_tiered_grow_appends_ranges():
    cfg, j_cfg = make_cfgs("sharded-tiered", "fp32")
    j_params, _ = j_lram.lram_init(KEY, j_cfg)
    layer = port_layer(cfg, j_params["values"])
    store = layer.values
    assert isinstance(store, ShardedTieredStore)
    store.writeback_lr = 0.25
    before = store.to_dense()
    cfg2 = memctl.grow(layer, 2**17)
    _, j_cfg2 = j_memctl.grow(j_params, j_cfg, 2**17)
    assert layer.values is store
    assert store.num_ranges == 8 and cfg2.model_shards == 8 \
        == j_cfg2.model_shards
    assert all(p.writeback_lr == 0.25 for p in store.parts)
    after = store.to_dense()
    np.testing.assert_array_equal(after[:2**16], before)
    np.testing.assert_array_equal(after[2**16:], before)  # alias copy
    np.testing.assert_array_equal(after, j_params["values"].to_dense())


def _smoke_dense_cfgs(impl="reference"):
    """lram-tiered's smoke config on a dense table, port and reference."""
    out = []
    for mod in (configs, j_configs):
        cfg = mod.get_smoke_config("lram-tiered")
        out.append(dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, interp_impl=impl, tiered=None)))
    return tuple(out)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_grow_model_with_opt_state():
    """Model-level growth: every memory table and Adam's mu / nu of it
    grow by the parent copy, equal to the reference's grown moments; the
    grown config resolves and the model still runs."""
    cfg, j_cfg = _smoke_dense_cfgs()
    params, state = j_tf.init(KEY, j_cfg)
    rng = np.random.default_rng(3)
    opt = j_optim.adam_init(params)
    for key in ("mu", "nu"):  # moments worth copying
        opt[key] = jax.tree.map(lambda x: jnp.asarray(rng.random(
            x.shape, np.float32)), opt[key])
    model = convert.model_from_jax(_np(params), _np(state), cfg,
                                   device="cpu")
    opt_state = optim.adam_init(dict(model.named_parameters()))
    convert.load_reference_tree(model, {
        "params": _np(params), "model_state": _np(state),
        "opt": {"mu": _np(opt["mu"]), "nu": _np(opt["nu"]),
                "step": np.asarray(opt["step"])}}, opt_state)
    n_old = cfg.lram.num_locations

    cfg2 = memctl.grow_model(model, 2 * n_old, opt_state=opt_state)
    params2, j_cfg2, opt2 = j_memctl.grow_model(params, j_cfg, 2 * n_old,
                                                opt_state=opt)
    assert cfg2 is model.cfg and cfg2.lram.num_locations == 2 * n_old
    assert cfg2.lram.torus_spec.K == j_cfg2.lram.torus_spec.K
    (seg,) = [f"seg{i}" for i, s in enumerate(transformer.layer_plan(cfg))
              if s[0] == "memory"]
    key = f"segments.{seg}.memffn.lram.values"
    j_path = lambda t: t["segments"][seg]["memffn"]["lram"]["values"]  # noqa: E731
    np.testing.assert_array_equal(model.get_parameter(key).detach().numpy(),
                                  np.asarray(j_path(params2)))
    for m in ("mu", "nu"):
        np.testing.assert_array_equal(opt_state[m][key].numpy(),
                                      np.asarray(j_path(opt2[m])))
    assert key in dict(model.named_parameters())
    logits = transformer.forward(model, {"tokens": torch.zeros(
        (2, 8), dtype=torch.long)})
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def test_migration_roundtrip_exact_model_logits():
    """dense -> tiered -> sharded-tiered -> dense: logits within 1e-5 on
    the way, the table moves payload-exact and the end is exact."""
    cfg, j_cfg = _smoke_dense_cfgs()
    params, state = j_tf.init(KEY, j_cfg)
    model = convert.model_from_jax(_np(params), _np(state), cfg,
                                   device="cpu")
    toks = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))}
    with torch.no_grad():
        y0 = transformer.forward(model, toks).numpy()
        j_y0 = np.asarray(j_tf.forward(params, state, {"tokens": jnp.asarray(
            toks["tokens"].numpy(), jnp.int32)}, j_cfg)[0])
        np.testing.assert_allclose(y0, j_y0, atol=1e-4)
        table0 = port_table(model.segments["seg1"].memffn.lram.values)[0]

        memctl.migrate_model(model, dataclasses.replace(
            cfg.lram, interp_impl="tiered",
            tiered=TieredSpec(shard_rows=2048, cache_slots=4)))
        assert isinstance(model.segments["seg1"].memffn.lram.values,
                          TieredValueStore)
        np.testing.assert_allclose(transformer.forward(model, toks).numpy(),
                                   y0, atol=1e-5)
        memctl.migrate_model(model, dataclasses.replace(
            cfg.lram, interp_impl="sharded-tiered", model_shards=2,
            tiered=TieredSpec(shard_rows=2048, cache_slots=2)))
        np.testing.assert_allclose(transformer.forward(model, toks).numpy(),
                                   y0, atol=1e-5)
        memctl.migrate_model(model, cfg.lram)
        assert model.cfg == cfg
        np.testing.assert_array_equal(
            port_table(model.segments["seg1"].memffn.lram.values)[0],
            table0)
        np.testing.assert_array_equal(
            transformer.forward(model, toks).numpy(), y0)


def test_migration_same_kind_quant_payload_exact():
    """int8 -> int8 across placements moves payload and scales verbatim,
    and back: as the reference's migration does."""
    cfg_d, j_cfg_d = make_cfgs("dense", "int8")
    cfg_t, j_cfg_t = make_cfgs("tiered", "int8")
    j_params, _ = j_lram.lram_init(KEY, j_cfg_d)
    layer = port_layer(cfg_d, j_params["values"])
    table = layer.values
    assert isinstance(table, quant.QuantizedTable)
    memctl.migrate(layer, cfg_t)
    j_t = j_memctl.migrate(j_params, j_cfg_d, j_cfg_t)
    store = layer.values
    np.testing.assert_array_equal(store.to_dense(),
                                  table.dequantize().numpy())
    _same_table(store, j_t["values"])
    memctl.migrate(layer, cfg_d)
    np.testing.assert_array_equal(layer.values.q.numpy(), table.q.numpy())
    np.testing.assert_array_equal(layer.values.scale.numpy(),
                                  table.scale.numpy())


def test_migration_cross_storage_within_bound():
    cfg_d, j_cfg_d = make_cfgs("dense", "fp32")
    cfg_q, j_cfg_q = make_cfgs("sharded-tiered", "int8", model_shards=2)
    j_params, _ = j_lram.lram_init(KEY, j_cfg_d)
    layer = port_layer(cfg_d, j_params["values"])
    dense = layer.values.detach().numpy().copy()
    memctl.migrate(layer, cfg_q)
    got = layer.values.to_dense()
    _, scale = quant.quantize_rows_np(dense, "int8")
    assert np.abs(got - dense).max() <= float(scale.max()) * 0.5 + 1e-7
    j_q = j_memctl.migrate(j_params, j_cfg_d, j_cfg_q)
    _same_table(layer.values, j_q["values"])


def test_migration_rejects_mesh_and_resize():
    cfg, _ = make_cfgs("dense", "fp32")
    layer = lram.LRAM(cfg)
    context.set_mesh(_OneRankMesh())
    try:
        with pytest.raises(lookup.LookupPlanError, match="migrate"):
            memctl.migrate(layer, lram.LRAMConfig(**KW,
                                                  interp_impl="sharded"))
    finally:
        context.set_mesh(None)
    with pytest.raises(ValueError, match="shape"):
        memctl.migrate(layer, make_cfgs("tiered", "fp32",
                                        log2_locations=17)[0])


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def _tel_np(tel):
    return {k: np.asarray(v) for k, v in tel.items()}


def test_telemetry_update_matches_reference():
    """Counts, EMA and steps equal the reference's on the same indices,
    over two steps."""
    rng = np.random.default_rng(4)
    tel = memctl.telemetry_init(1024, rows_per_bin=4)
    j_tel = j_memctl.telemetry_init(1024, rows_per_bin=4)
    for shape in ((7, 5), (1, 5)):
        idx = rng.integers(0, 1024, size=shape).astype(np.int32)
        tel = memctl.telemetry_update(tel, torch.from_numpy(idx))
        j_tel = j_memctl.telemetry_update(j_tel, jnp.asarray(idx))
        for k in ("counts", "ema", "steps"):
            np.testing.assert_array_equal(tel[k].numpy(),
                                          np.asarray(j_tel[k]), err_msg=k)
    assert int(tel["steps"]) == 2
    assert float(tel["ema"].sum()) < float(tel["counts"].sum())


def test_utilisation_report_fractions():
    rng = np.random.default_rng(5)
    tel = memctl.telemetry_init(100, rows_per_bin=1)
    j_tel = j_memctl.telemetry_init(100, rows_per_bin=1)
    tel = memctl.telemetry_update(tel, torch.arange(50, dtype=torch.int32))
    j_tel = j_memctl.telemetry_update(j_tel, jnp.arange(50, dtype=jnp.int32))
    rows = memctl.utilisation_report(tel, prefix="t")
    assert {r[0]: r[2] for r in rows}["t_dead_frac"].startswith("0.5000")
    assert rows == j_memctl.utilisation_report(j_tel, prefix="t")
    idx = rng.integers(0, 100, size=(9, 4)).astype(np.int32)
    tel = memctl.telemetry_update(tel, torch.from_numpy(idx))
    j_tel = j_memctl.telemetry_update(j_tel, jnp.asarray(idx))
    assert memctl.utilisation_summary(tel) == \
        j_memctl.utilisation_summary(j_tel)


def test_store_telemetry_counts_accesses():
    """A sharded-tiered store's per-shard counts in global order: the
    reference store's on the same gathers."""
    rng = np.random.default_rng(6)
    dense = rng.normal(size=(4096, 8)).astype(np.float32)
    store = ShardedTieredStore.from_dense(
        dense, TieredSpec(shard_rows=256, cache_slots=2), 2)
    j_store = JShardedStore.from_dense(
        dense, JSpec(shard_rows=256, cache_slots=2), num_ranges=2)
    idx = rng.integers(0, 4096, size=(32, 4)).astype(np.int32)
    w = rng.normal(size=idx.shape).astype(np.float32)
    store.gather(torch.from_numpy(idx), torch.from_numpy(w))
    j_store.gather(idx, w)
    tel = memctl.store_telemetry(store)
    assert tel["counts"].shape == (16,) and tel["rows_per_bin"] == 256
    want = np.bincount(idx.reshape(-1) >> 8, minlength=16)
    np.testing.assert_array_equal(tel["counts"].numpy(),
                                  want.astype(np.float32))
    j_tel = j_memctl.store_telemetry(j_store)
    np.testing.assert_array_equal(tel["counts"].numpy(),
                                  np.asarray(j_tel["counts"]))
    assert int(tel["steps"]) == int(j_tel["steps"])
    assert lookup.resolve(make_cfgs("sharded-tiered", "fp32")[0]).row_stats
    assert lookup.resolve(make_cfgs("tiered", "fp32")[0]).row_stats
    assert not lookup.resolve(make_cfgs("dense", "fp32")[0]).row_stats


def test_tiered_store_row_stats_match_reference():
    """A tiered store's `shard_access` after gathers and a reset, as the
    reference store's."""
    rng = np.random.default_rng(7)
    dense = rng.normal(size=(4096, 8)).astype(np.float32)
    store = TieredValueStore.from_dense(
        dense, TieredSpec(shard_rows=256, cache_slots=4))
    j_store = JStore.from_dense(dense, JSpec(shard_rows=256, cache_slots=4))
    for _ in range(3):
        idx = rng.integers(0, 4096, size=(16, 4)).astype(np.int32)
        w = rng.normal(size=idx.shape).astype(np.float32)
        store.gather(torch.from_numpy(idx), torch.from_numpy(w))
        j_store.gather(idx, w)
        np.testing.assert_array_equal(store.row_stats()[0],
                                      j_store.row_stats()[0])
    store.reset_stats()
    assert not store.row_stats()[0].any()


def test_grow_telemetry_appends_dead_bins():
    tel = memctl.telemetry_init(512, rows_per_bin=8)
    tel = memctl.telemetry_update(tel, torch.arange(512, dtype=torch.int32))
    tel2 = memctl.grow_telemetry(tel, 1024)
    counts = tel2["counts"].numpy()
    assert counts.shape == (128,)
    assert (counts[64:] == 0).all() and (counts[:64] > 0).all()
    j_tel = j_memctl.grow_telemetry(j_memctl.telemetry_update(
        j_memctl.telemetry_init(512, rows_per_bin=8),
        jnp.arange(512, dtype=jnp.int32)), 1024)
    np.testing.assert_array_equal(counts, np.asarray(j_tel["counts"]))


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arg,err", [
    ("10:17,20:18", None), ("10", "STEP:NEW_LOG2"),
    ("10:18,20:17", "increase"), ("10:17,10:18", "distinct")])
def test_parse_grow_at(arg, err):
    if err is None:
        assert memctl.parse_grow_at(arg) == j_memctl.parse_grow_at(arg) \
            == ((10, 17), (20, 18))
        return
    for parse in (memctl.parse_grow_at, j_memctl.parse_grow_at):
        with pytest.raises(ValueError, match=err):
            parse(arg)


def test_controller_grows_on_schedule_once():
    model = transformer.init(configs.get_smoke_config("lram-tiered"))
    ctl = memctl.MemoryController(memctl.LifecyclePolicy(
        grow_at=memctl.parse_grow_at("2:17")))
    n0 = model.cfg.lram.num_locations
    assert not ctl.on_train_step(0, model)
    assert model.cfg.lram.num_locations == n0
    assert ctl.on_train_step(2, model)
    assert model.cfg.lram.num_locations == 2**17
    assert not ctl.on_train_step(2, model)  # fires exactly once
    assert [e["event"] for e in ctl.events] == ["grow"]
    (store,) = [s for _, s in lookup.find_stores(model)]
    assert store.num_rows == 2**17


def test_controller_catch_up_applies_past_growths():
    model = transformer.init(configs.get_smoke_config("lram-tiered"))
    ctl = memctl.MemoryController(memctl.LifecyclePolicy(
        grow_at=memctl.parse_grow_at("1:17,5:18")))
    assert ctl.catch_up(3, model)
    assert model.cfg.lram.num_locations == 2**17  # only the step-1 event
    assert not ctl.on_train_step(1, model)  # already applied


def test_controller_hbm_budget_trigger():
    cfg, j_cfg = _smoke_dense_cfgs()
    table_bytes = cfg.lram.num_locations * cfg.lram.table_bytes_per_entry
    assert table_bytes == \
        j_cfg.lram.num_locations * j_cfg.lram.table_bytes_per_entry

    class _Eng:  # the controller reads cfg and ticks only
        pass

    eng = _Eng()
    eng.cfg, eng.ticks = cfg, 0
    for budget, due in ((table_bytes - 1, True), (table_bytes + 1, False)):
        ctl = memctl.MemoryController(memctl.LifecyclePolicy(
            hbm_budget_bytes=budget))
        assert ctl._spill_due(eng) is due


def test_engine_live_spill_preserves_generation():
    """The serve-tick spill (dense -> tiered mid-trace) changes no token:
    the port's engine on converted weights gives the no-spill run's
    tokens and the JAX engine's live-spill tokens; in-flight slots ride
    through the swap, and the stores are found after it."""
    cfg, j_cfg = _smoke_dense_cfgs()
    params, state = j_tf.init(KEY, j_cfg)
    kw = dict(vocab_size=cfg.vocab_size, max_prompt=6, max_gen=6)
    trace = synthetic_trace(np.random.default_rng(0), 4, **kw)
    ecfg = EngineConfig(slots=2, max_len=16)

    def model():
        return convert.model_from_jax(_np(params), _np(state), cfg,
                                      device="cpu")

    want = {r.id: r.tokens for r in ServeEngine(model(), ecfg).run(trace)
            .requests}
    ctl = memctl.MemoryController(memctl.LifecyclePolicy(spill_at_tick=2))
    engine = ServeEngine(model(), ecfg, controller=ctl)
    report = engine.run(trace)
    assert [e["event"] for e in ctl.events] == ["spill"]
    assert ctl.events[0]["tick"] == 2
    assert engine.cfg.lram.interp_impl == "tiered" and engine.stores
    assert report.cache is not None and not report.cuda_graph
    got = {r.id: r.tokens for r in report.requests}
    assert got == want

    j_ctl = j_memctl.MemoryController(j_memctl.LifecyclePolicy(
        spill_at_tick=2))
    j_report = JServeEngine(params, state, j_cfg, JEngineConfig(
        slots=2, max_len=16), controller=j_ctl).run(
            j_synthetic_trace(np.random.default_rng(0), 4, **kw))
    assert got == {r.id: r.tokens for r in j_report.requests}
    assert j_ctl.events[0]["tick"] == ctl.events[0]["tick"]


def test_sharded_tiered_prefetch_pool_matches_serial():
    """The pool's prefetch (8 workers over 16 ranges, the interpreter
    switching threads every microsecond) warms the shards the serial walk
    warms, with the same fill and stat counts."""
    import sys

    rng = np.random.default_rng(8)
    dense = rng.normal(size=(16384, 8)).astype(np.float32)
    spec = TieredSpec(shard_rows=256, cache_slots=2)
    a = ShardedTieredStore.from_dense(dense, spec, 16)
    b = ShardedTieredStore.from_dense(dense, spec, 16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            idx = torch.from_numpy(rng.integers(0, 16384, size=(256, 1))
                                   .astype(np.int32))
            for s in (a, b):
                s.gather(idx, torch.ones(idx.shape))  # primes last_access
            a.prefetch_last()
            for part in b.parts:  # the serial walk
                part.prefetch_last()
            assert a.resident_shards() == b.resident_shards()
            assert a.stats == b.stats
            later = rng.integers(0, 16384, size=(256,)).astype(np.int32)
            a.prefetch(later)  # the indexed variant fans out too
            for part, _, local in b._route(later):
                part.prefetch(local)
            assert a.resident_shards() == b.resident_shards()
            assert a.stats == b.stats
    finally:
        sys.setswitchinterval(interval)
    assert a._pool is not None and a._pool._max_workers == 8


# ---------------------------------------------------------------------------
# the trainer: --grow-at and --telemetry against the JAX trainer
# ---------------------------------------------------------------------------

def test_cli_grow_and_telemetry_track_jax(monkeypatch, capsys):
    """`train.main --grow-at 2:17 --telemetry` on the JAX trainer's
    weights (lram-bert-medium smoke, the reference cell on both sides):
    every step's loss within rtol 1e-4 of the JAX trainer's, one growth
    before step 2, and the utilisation rows at every logged step equal
    to the reference's (the counters count the same indices)."""
    argv = ["--arch", "lram-bert-medium", "--smoke", "--steps", "4",
            "--batch", "2", "--seq", "16", "--grow-at", "2:17",
            "--telemetry", "--log-every", "1"]
    j_cfg = j_configs.get_smoke_config("lram-bert-medium")
    params, state = j_tf.init(jax.random.PRNGKey(0), j_cfg)
    j_train.main(argv)
    j_out = [json.loads(x.split(" STRAGGLER")[0])
             for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    monkeypatch.setattr(train.transformer, "init", lambda cfg, seed=0: (
        convert.model_from_jax(_np(params), _np(state), cfg, device="cpu")))
    run = train.main(argv + ["--device", "cpu", "--json"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    j_losses = [x["loss"] for x in j_out if "loss" in x and "step" in x]
    np.testing.assert_allclose([r["loss"] for r in run.records], j_losses,
                               rtol=1e-4)
    grows = [x for x in out if "grow" in x]
    assert [(g["grow"], g["step"]) for g in grows] == \
        [(g["grow"], g["step"]) for g in j_out if "grow" in g] \
        == [("2^17", 2)]
    assert run.model.cfg.lram.num_locations == 2**17
    util = [x for x in out if "utilisation_report" in x]
    j_util = [x for x in j_out if "utilisation_report" in x]
    assert [u["step"] for u in util] == [0, 1, 2, 3]
    assert [u["utilisation_report"] for u in util] == \
        [u["utilisation_report"] for u in j_util]


def test_train_grow_resume_serve_round_trip(tmp_path, capsys):
    """lram-tiered (smoke) grows at step 2 and checkpoints every 2 steps;
    a failure before step 5, the relaunch grows first (`catch_up`, no
    growth printed) and resumes from the grown step-4 checkpoint with the
    crashed run's step-4 loss; then `serve --grow-to 17 --ckpt-dir`
    serves the grown checkpoint."""
    from repro_torch.distributed import fault

    ckpt = str(tmp_path / "ckpt")
    argv = ["--arch", "lram-tiered", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "16", "--grow-at",
            "2:17", "--ckpt-dir", ckpt, "--ckpt-every", "2", "--json"]
    with pytest.raises(fault.SimulatedFailure):
        train.main(argv + ["--simulate-failure-at", "5"])
    out = capsys.readouterr().out
    assert '"grow": "2^17", "step": 2' in out
    crashed = [json.loads(x) for x in out.splitlines()
               if x.startswith('{"step"')]
    run = train.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and run.start_step == 4
    assert '"grow"' not in out  # caught up before the restore
    assert run.records[0]["loss"] == crashed[4]["loss"]
    (store,) = run.stores
    assert store.num_rows == 2**17
    report = serve.main(["--arch", "lram-tiered", "--smoke", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "4",
                         "--gen", "3", "--grow-to", "17", "--ckpt-dir", ckpt,
                         "--json"])
    out = capsys.readouterr().out
    assert '{"restored_step": 6}' in out.splitlines()
    assert len(report.requests) == 4
    assert json.loads(out.splitlines()[-1])["tokens_per_sec"] > 0


MESH_TELEMETRY_CODE = """
import torch
import torch.distributed as dist
from repro_torch.launch import train
torch.set_num_threads(1)
train.main(["--arch", "lram-bert-medium", "--smoke", "--device", "cpu",
            "--placement", "sharded", "--use-mesh", "--json", "--steps", "2",
            "--batch", "4", "--seq", "16", "--telemetry", "--log-every", "1"])
dist.destroy_process_group()
"""


def test_mesh_telemetry_reports_the_one_process_counts(tmp_path, capsys):
    """`--telemetry` on 4 ranks (data 2 x model 2, the table row-sharded):
    each data rank counts its slice of the batch and the report sums the
    counts over the batch axes, so rank 0 prints the utilisation rows of
    the one-process dense run (the pallas cell, same seed and batches)."""
    outs = run_ranks(MESH_TELEMETRY_CODE, 4, tmp_path, timeout=120)
    assert not any(o.strip() for o in outs[1:])
    util = [json.loads(x) for x in outs[0].splitlines()
            if '"utilisation_report"' in x]
    run = train.main(["--arch", "lram-bert-medium", "--smoke", "--device",
                      "cpu", "--placement", "pallas", "--json", "--steps",
                      "2", "--batch", "4", "--seq", "16", "--telemetry",
                      "--log-every", "1"])
    one = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if '"utilisation_report"' in x]
    assert [u["step"] for u in util] == [0, 1]
    assert util == one
    assert int(run.telemetry["seg1"]["counts"].sum()) == 2 * 4 * 16 * 4 * 32
