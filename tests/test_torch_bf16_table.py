"""Port parity for bfloat16 memory tables (`LRAMConfig.table_dtype =
"bfloat16"`) against the JAX package, on every placement where the
reference builds one.

The reference draws its table in bfloat16; the same bits are carried into
the port by the converter (`convert.tensor_from_numpy`), and each cell's
table is built from them by both packages' plans: a dense bf16 tensor, a
1-byte table quantized from the bf16 values, a tiered store whose host
tier is bf16 (in RAM or memmapped) under an fp32 cache, a tiered int8
store (the bf16 request dropped), and a sharded-tiered store of 2 bf16
ranges.  The port's kernels run their plain versions on the CPU; the
CUDA instances are held against those on the card (`test_torch_cuda.py`,
`chip_smoke.py` path (m)).

Tolerances: forward outputs 1e-6 abs.  The table's gradient (dense cells)
is rounded to bf16 once in both packages; the fp32 sums behind it add in
another order, so each element is within one bf16 ulp of the
reference's, or, where the sum cancels to far below the gradient's scale,
within 1e-3 of its largest magnitude.  d x (through the analytic or
autodiff dq) to rtol 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from repro import configs as j_configs
from repro import data as j_data
from repro import memctl as j_memctl
from repro.memctl.migrate import migrate_table as j_migrate_table
from repro import optim as j_optim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import lookup as j_lookup
from repro.core import lram as j_lram
from repro.launch import train as j_train
from repro.memstore import TieredSpec as JSpec
from repro.memstore import TieredValueStore as JStore
from repro.models import transformer as j_tf
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs, memctl, optim, quant
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import lookup, lram
from repro_torch.launch import convert, train
from repro_torch.memctl.migrate import migrate_table
from repro_torch.memstore import TieredSpec, TieredValueStore
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

BF16 = "bfloat16"
KEY = jax.random.PRNGKey(0)
LOG2, HEADS = 16, 4
SHARD_ROWS = 2048
# cell -> LRAMConfig fields (both packages); "mmap" gets a backing_dir
CELLS = {
    "dense-reference": dict(interp_impl="reference"),
    "dense-pallas": dict(interp_impl="pallas"),
    "int8": dict(interp_impl="pallas", table_quant="int8"),
    "fp8": dict(interp_impl="pallas", table_quant="fp8"),
    "tiered-ram": dict(interp_impl="tiered", tiered="ram"),
    "tiered-mmap": dict(interp_impl="tiered", tiered="mmap"),
    "tiered-pallas": dict(interp_impl="tiered", tiered="pallas"),
    "tiered-int8": dict(interp_impl="tiered", tiered="int8"),
    "sharded-tiered": dict(interp_impl="sharded-tiered", tiered="ram",
                           model_shards=2),
}


def _spec(mod, kind, backing_dir=None):
    """A TieredSpec of `mod` (the port's or the reference's) for a cell."""
    kw = dict(shard_rows=SHARD_ROWS, cache_slots=8)
    if kind == "mmap":
        kw.update(backing="mmap", backing_dir=backing_dir)
    elif kind == "pallas":
        kw.update(use_pallas=True)
    elif kind == "int8":
        kw.update(quant="int8")
    return mod(**kw)


def _cfgs(cell, tmp_path=None, **extra):
    """(port LRAMConfig, reference LRAMConfig) of a cell, bf16 tables."""
    kw = dict(CELLS[cell], **extra)
    kind = kw.pop("tiered", None)
    out = []
    for mod, spec in ((lram, TieredSpec), (j_lram, JSpec)):
        tiered = None
        if kind is not None:
            d = None
            if kind == "mmap":
                d = str(tmp_path / ("port" if mod is lram else "ref"))
            tiered = _spec(spec, kind, d)
        out.append(mod.LRAMConfig(log2_locations=LOG2, heads=HEADS,
                                  query_norm="rms", table_dtype=BF16,
                                  tiered=tiered, **kw))
    return tuple(out)


def _bits(a) -> np.ndarray:
    """Raw 16-bit words of a bf16 array or tensor (uint16 bits pass)."""
    if isinstance(a, torch.Tensor):
        return a.detach().view(torch.int16).numpy().view(np.uint16)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint16)


def _assert_bf16_close(got, want):
    """Each element of two bf16 gradients within one ulp, or within 1e-3
    of the gradient's largest magnitude where an fp32 sum cancels."""
    a = _bits(got).view(np.int16).astype(np.int32)
    b = _bits(want).view(np.int16).astype(np.int32)
    # ulps apart (the sign-magnitude words mapped to a monotone scale)
    a = np.where(a < 0, -32768 - a, a)
    b = np.where(b < 0, -32768 - b, b)
    gf = quant.bf16_to_f32(_bits(got))
    wf = quant.bf16_to_f32(_bits(want))
    near = np.abs(gf - wf) <= 1e-3 * np.abs(wf).max()
    assert np.all((np.abs(a - b) <= 1) | near)
    assert np.count_nonzero(np.abs(a - b) > 1) <= 1e-4 * a.size


def _layer_pair(cell, tmp_path):
    """The reference's layer (its bf16 draw, built into the cell's table
    by its plan) and the port's on the same bits and query norm."""
    cfg, j_cfg = _cfgs(cell, tmp_path)
    dense = dataclasses.replace(j_cfg, interp_impl="reference",
                                table_quant="none", tiered=None,
                                model_shards=0)
    params, state = j_lram.lram_init(KEY, dense)
    assert params["values"].dtype == jnp.bfloat16
    draw = np.asarray(params["values"])
    params = dict(params, values=j_lookup.resolve(j_cfg).build_table(
        params["values"]))
    layer = lram.LRAM(cfg)
    layer.qnorm.load_state_dict({"scale": torch.from_numpy(
        np.array(params["qnorm"]["scale"]))})
    lookup.set_table(layer, lookup.resolve(cfg).build_table(
        convert.tensor_from_numpy(draw)))
    return cfg, j_cfg, params, state, layer, draw


@pytest.mark.parametrize("cell", list(CELLS))
def test_bf16_cells_match_reference(cell, tmp_path):
    """Each cell from the same bf16 bits: the table in the reference's
    storage (bf16 bits, payloads and scales, host tiers bit for bit; a
    memmap's `.npy` holds the same bytes after its header, `<u2` against
    the reference's `<V2`), the layer's output within 1e-6, and in the
    trainable dense cells the bf16 table gradient (see the module) and
    d x (rtol 1e-4) of a sum of squares.  `table_bytes_per_entry` and a
    store's `bytes_per_entry` equal the reference's."""
    cfg, j_cfg, params, state, layer, draw = _layer_pair(cell, tmp_path)
    assert cfg.table_bytes_per_entry == j_cfg.table_bytes_per_entry
    table, j_table = layer.values, params["values"]
    if lookup.is_store(table):
        assert table.bytes_per_entry() == j_table.bytes_per_entry()
        parts = getattr(table, "parts", [table])
        j_parts = getattr(j_table, "parts", [j_table])
        for p, jp in zip(parts, j_parts):
            assert p.dtype == (torch.float32 if p.quant != "none"
                               else torch.bfloat16)
            np.testing.assert_array_equal(
                np.ascontiguousarray(p._host).view(np.uint8),
                np.ascontiguousarray(np.asarray(jp._host)).view(np.uint8))
        if cell == "tiered-mmap":
            with open(table._host.filename, "rb") as f, \
                    open(j_table._host.filename, "rb") as g:
                a, b = f.read(), g.read()
            assert b"'descr': '<u2'" in a[:128]
            assert b"'descr': '<V2'" in b[:128]
            n = table._host.nbytes
            assert len(a) - n == len(b) - n == 128 and a[-n:] == b[-n:]
    elif isinstance(table, quant.QuantizedTable):
        q, scale = lookup.host_quantized(table)
        np.testing.assert_array_equal(
            q.view(np.uint8), np.asarray(j_table.q).view(np.uint8))
        np.testing.assert_array_equal(scale, np.asarray(j_table.scale))
    else:
        assert table.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(table), _bits(draw))
    x = np.random.default_rng(5).normal(size=(3, 9, 64)).astype(np.float32)
    trainable = cell.startswith("dense")

    def j_loss(p, xx):
        y, _ = j_lram.lram_apply(p, state, xx, j_cfg)
        return jnp.sum(y * y), y

    xt = torch.from_numpy(x).requires_grad_(trainable)
    y = lram.lram_apply(layer, xt)
    if not trainable:
        jy = j_lram.lram_apply(params, state, jnp.asarray(x), j_cfg)[0]
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   rtol=0, atol=1e-6)
        return
    (_, jy), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-6)
    (y * y).sum().backward()
    assert layer.values.grad.dtype == torch.bfloat16
    assert j_gp["values"].dtype == jnp.bfloat16
    _assert_bf16_close(layer.values.grad, j_gp["values"])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx),
                               rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", BF16])
@pytest.mark.parametrize("storage", ["none", "int8", "fp8"])
def test_table_bytes_per_entry_matches_reference(dtype, storage):
    """Bytes a row: m * 4 or m * 2 in the table's dtype, m + 4 for a 1-byte
    row and its scale, as the reference's `table_bytes_per_entry`."""
    kw = dict(log2_locations=LOG2, heads=HEADS, table_dtype=dtype,
              table_quant=storage)
    assert lram.LRAMConfig(**kw).table_bytes_per_entry == \
        j_lram.LRAMConfig(**kw).table_bytes_per_entry


@pytest.mark.parametrize("dtype", ["float16", "float64", "int8"])
def test_unsupported_table_dtype_raises_naming_a6_part_2(dtype):
    """The reference takes any jnp dtype; the port float32 and bfloat16,
    and refuses the rest naming the ROADMAP item that ports them."""
    with pytest.raises(ValueError, match="A6 part 2"):
        lram.LRAMConfig(log2_locations=LOG2, table_dtype=dtype)


# ---------------------------------------------------------------------------
# the bf16 host tier: fills, evictions and the write-back
# ---------------------------------------------------------------------------

ROWS, SMALL_SHARD, M = 16 * 64, 64, 8


def _store_pair(seed=0, slots=4):
    """A reference store and a port store over the same bf16 table."""
    rng = np.random.default_rng(seed)
    dense = (rng.normal(size=(ROWS, M)) * 0.02).astype(ml_dtypes.bfloat16)
    kw = dict(shard_rows=SMALL_SHARD, cache_slots=slots)
    j_store = JStore.from_dense(dense, JSpec(**kw))
    store = TieredValueStore.from_dense(convert.tensor_from_numpy(dense),
                                        TieredSpec(**kw))
    return j_store, store


def _same_store(store, j_store):
    assert store.stats == j_store.stats
    assert store._dirty == j_store._dirty
    assert store.resident_shards() == j_store.resident_shards()
    np.testing.assert_array_equal(_bits(store._host), _bits(j_store._host))
    np.testing.assert_array_equal(store.cache_np, j_store.cache_np)


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.tuples(
    st.sampled_from(["gather", "writeback", "dup_writeback", "prefetch",
                     "flush"]),
    st.integers(0, 2**31 - 1)), min_size=1, max_size=8))
def test_bf16_host_tier_tracks_reference(ops):
    """A bf16 host tier under the fp32 cache (4 slots, 16 shards) through
    random lookups (fills, evictions of dirty slots, overflow batches),
    write-backs (resident rows into the fp32 cache; the others into the
    bf16 tier, each (index, update) pair rounded in turn, duplicates
    included), prefetches and flushes: after every step the host bits,
    the cache mirror, the stats and the dirty set equal the reference
    store's; `to_dense()` holds the reference's bf16 values."""
    j_store, store = _store_pair()
    j_store.writeback_lr = store.writeback_lr = 0.5
    for kind, seed in ops:
        rng = np.random.default_rng(seed)
        shards = rng.choice(16, size=rng.integers(1, 7), replace=False)
        idx = (shards[rng.integers(0, len(shards), (4, 8))] * SMALL_SHARD
               + rng.integers(0, SMALL_SHARD, (4, 8))).astype(np.int32)
        if kind == "dup_writeback":  # a few rows, each many times
            idx = rng.choice(idx.reshape(-1)[:3], size=(6, 8)).astype(
                np.int32)
        if kind == "gather":
            w = rng.uniform(0, 1, size=idx.shape).astype(np.float32)
            got = store.gather(torch.from_numpy(idx), torch.from_numpy(w))
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(j_store.gather(idx, w)),
                                       rtol=1e-6, atol=1e-6)
        elif kind == "prefetch":
            store.prefetch(idx)
            j_store.prefetch(idx)
        elif kind == "flush":
            store.flush()
            j_store.flush()
        else:
            wg = rng.normal(size=idx.shape + (M,)).astype(np.float32)
            store.apply_writeback(idx, wg)
            j_store.apply_writeback(idx, wg)
        _same_store(store, j_store)
    np.testing.assert_array_equal(
        store.to_dense(), j_store.to_dense().astype(np.float32))
    for i in range(store.num_shards):
        np.testing.assert_array_equal(_bits(store.shard_host(i)),
                                      _bits(j_store.shard_host(i)))


def test_bf16_writeback_rounds_each_duplicate_in_turn():
    """Two updates of one non-resident bf16 row, each below half an ulp
    of it: the reference's np.add.at rounds after each add, so the row
    does not move; a sum taken first would have moved it."""
    j_store, store = _store_pair(slots=1)
    row = 5 * SMALL_SHARD + 3
    base = quant.bf16_to_f32(store._host[5, 3])
    ulp = 2.0 ** (np.floor(np.log2(np.abs(base))) - 7)  # bf16: 8 bits
    wg = np.zeros((2, M), np.float32)
    wg[:] = -0.3 * ulp / 0.5  # -lr * wg = +0.3 ulp each
    for s in (store, j_store):
        s.writeback_lr = 0.5
        s.apply_writeback(np.array([row, row], np.int32), wg)
    np.testing.assert_array_equal(_bits(store._host[5, 3]), _bits(
        j_store._host[5, 3]))
    np.testing.assert_array_equal(quant.bf16_to_f32(store._host[5, 3]),
                                  base)


# ---------------------------------------------------------------------------
# serving, the spill, training and checkpoints on a bf16 table
# ---------------------------------------------------------------------------

def _tiny_cfgs(**lram_kw):
    """The reference's tiny overlay model (2 layers, d_model 32, the
    memory layer at 1) with a bf16 table, port and JAX."""
    lram_kw = dict(dict(query_norm="rms", interp_impl="reference",
                        table_dtype=BF16), **lram_kw)
    tiered = lram_kw.pop("tiered", None)
    out = []
    for mod, mc, spec in ((lram, ModelConfig, TieredSpec),
                          (j_lram, JModelConfig, JSpec)):
        out.append(mc(
            name="tiny-bf16", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=97,
            objective="clm", remat=False, lram_layers=(1,),
            lram=mod.memffn_config(32, 16, tiered=None if tiered is None
                                   else spec(**tiered), **lram_kw)))
    return tuple(out)


def _np(tree):
    """The reference's tree as the converter takes it: numpy leaves, a
    tiered store as its host table (bf16 bits read shard by shard)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, JStore):
        return np.concatenate([tree.shard_host(i)
                               for i in range(tree.num_shards)])
    return np.asarray(tree)


def _trace(seed, n, **kw):
    kw = dict(dict(vocab_size=97, max_prompt=6, max_gen=5), **kw)
    return (synthetic_trace(np.random.default_rng(seed), n, **kw),
            j_synthetic_trace(np.random.default_rng(seed), n, **kw))


@pytest.mark.parametrize("case", ["dense", "tiered", "tenants"])
def test_engine_tokens_match_jax_on_a_bf16_table(case):
    """The serve engine on the tiny model's converted weights with a bf16
    table: the same trace's tokens as the JAX engine's, on the dense
    table, on a tiered store with a bf16 host tier (8 of 32 shards
    cached), and with 2 tenants' overlays (fp32 deltas) over the dense
    bf16 base; first logits within 1e-5."""
    kw = {}
    if case == "tiered":
        kw = dict(interp_impl="tiered",
                  tiered=dict(shard_rows=SHARD_ROWS, cache_slots=8))
    cfg, j_cfg = _tiny_cfgs(**kw)
    params, state = j_tf.init(KEY, j_cfg)
    model = convert.model_from_jax(_np(params), _np(state), cfg,
                                   device="cpu")
    (layer,) = [m for m in model.modules() if isinstance(m, lram.LRAM)]
    assert (layer.values.dtype == torch.bfloat16)
    ecfg = dict(slots=2, max_len=12,
                overlay_rows=4 if case == "tenants" else 0)
    trace, j_trace = _trace(3, 4, tenants=2 if case == "tenants" else 0)
    report = ServeEngine(model, EngineConfig(**ecfg)).run(trace)
    ref = JServeEngine(params, state, j_cfg, JEngineConfig(**ecfg)) \
        .run(j_trace)
    assert [r.tokens for r in report.requests] == \
        [r.tokens for r in ref.requests]
    for a, b in zip(report.requests, ref.requests):
        np.testing.assert_allclose(a.first_logits, b.first_logits,
                                   atol=1e-5)
    if case == "tenants":
        assert report.overlay["writebacks"] == ref.overlay["writebacks"] > 0


def test_spill_of_a_dense_bf16_table_matches_jax():
    """A dense bf16 table spilled to the tiered placement: a bf16 host tier
    holding the table's bits (2 bytes a value), whose values are the
    reference's migrated store's (a float32 host tier there); the
    serve-tick spill at tick 2 changes no token (the no-spill run's and
    the JAX engine's live-spill tokens)."""
    cfg, j_cfg = _tiny_cfgs()
    params, state = j_tf.init(KEY, j_cfg)

    def model():
        return convert.model_from_jax(_np(params), _np(state), cfg,
                                      device="cpu")

    m = model()
    (layer,) = [x for x in m.modules() if isinstance(x, lram.LRAM)]
    bits = _bits(layer.values).copy()
    dst = dataclasses.replace(cfg.lram, interp_impl="tiered")
    j_dst = dataclasses.replace(j_cfg.lram, interp_impl="tiered")
    store = migrate_table(layer.values, cfg.lram, dst)
    (seg,) = [k for k in params["segments"] if "memffn" in
              params["segments"][k]]
    j_store = j_migrate_table(
        params["segments"][seg]["memffn"]["lram"]["values"], j_cfg.lram,
        j_dst)
    assert store.dtype == torch.bfloat16 and store.bytes_per_entry() == 128
    np.testing.assert_array_equal(_bits(store._host).reshape(bits.shape),
                                  bits)
    # the reference's migration target is a float32 store (its
    # `build_empty` takes no dtype): the same values, widened
    assert j_store.dtype == np.float32
    np.testing.assert_array_equal(store.to_dense(), j_store.to_dense())
    kw = dict(vocab_size=97, max_prompt=6, max_gen=6)
    trace = synthetic_trace(np.random.default_rng(0), 4, **kw)
    want = [r.tokens for r in ServeEngine(model(), EngineConfig(
        slots=2, max_len=16)).run(trace).requests]
    ctl = memctl.MemoryController(memctl.LifecyclePolicy(spill_at_tick=2))
    engine = ServeEngine(model(), EngineConfig(slots=2, max_len=16),
                         controller=ctl)
    got = [r.tokens for r in engine.run(trace).requests]
    assert [e["event"] for e in ctl.events] == ["spill"]
    (_, spilled), = lookup.find_stores(engine.model)
    assert spilled.dtype == torch.bfloat16
    j_ctl = j_memctl.MemoryController(j_memctl.LifecyclePolicy(
        spill_at_tick=2))
    j_report = JServeEngine(params, state, j_cfg, JEngineConfig(
        slots=2, max_len=16), controller=j_ctl).run(
            j_synthetic_trace(np.random.default_rng(0), 4, **kw))
    assert got == want == [r.tokens for r in j_report.requests]


def test_three_train_steps_match_jax_losses():
    """lram-bert-medium's smoke config with a bf16 table on the pallas
    cell (the kernels' plain versions; the table's gradient rounded to
    bf16 once, Adam's moments fp32 and the update cast back): three steps
    from the converted weights on the reference's batches, every loss
    within rtol 1e-5 of the reference's train step; the table stays
    bf16 and moves."""
    j_cfg = j_configs.get_smoke_config("lram-bert-medium")
    j_cfg = dataclasses.replace(j_cfg, lram=dataclasses.replace(
        j_cfg.lram, table_dtype=BF16))
    cfg = configs.get_smoke_config("lram-bert-medium")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, table_dtype=BF16, interp_impl="pallas"))
    params, state = j_tf.init(KEY, j_cfg)
    model = convert.model_from_jax(_np(params), _np(state), cfg,
                                   device="cpu")
    (layer,) = [m for m in model.modules() if isinstance(m, lram.LRAM)]
    before = layer.values.detach().clone()
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=32,
                             global_batch=4, objective=j_cfg.objective,
                             seed=0)
    j_step = j_train.build_train_step(j_cfg, j_optim.OptimConfig(lr=1e-4))
    j_opt, residual = j_optim.adam_init(params), jnp.zeros(())
    opt_state = optim.adam_init(dict(model.named_parameters()))
    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4))
    losses, j_losses = [], []
    for s in range(3):
        b = j_data.get_batch(dcfg, step=s)
        params, j_opt, state, residual, jm = j_step(
            params, j_opt, state, residual, jax.tree.map(jnp.asarray, b))
        j_losses.append(float(jm["loss"]))
        losses.append(step(opt_state, train.batch_to(b, "cpu"))["loss"]
                      .item())
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert layer.values.dtype == torch.bfloat16
    assert not torch.equal(layer.values, before)


@pytest.mark.parametrize("placement", ["dense", "tiered"])
def test_reference_checkpoint_of_a_bf16_table_restores(placement,
                                                       tmp_path):
    """The reference's checkpoint of the tiny model with a bf16 table
    (a `<V2` leaf, or a tiered store's `<V2` shards under manifest dtype
    "bfloat16") restores into the port bit for bit; the port's save of
    the same model writes the reference's files byte for byte."""
    kw = {} if placement == "dense" else dict(
        interp_impl="tiered", tiered=dict(shard_rows=SHARD_ROWS,
                                          cache_slots=8))
    cfg, j_cfg = _tiny_cfgs(**kw)
    params, state = j_tf.init(KEY, j_cfg)
    JCheckpointManager(str(tmp_path / "jax")).save(
        1, {"params": params, "model_state": state})
    model = transformer.init(cfg, seed=1)  # other weights, then restored
    step, tree = CheckpointManager(str(tmp_path / "jax")).restore(
        convert.reference_tree(model, like=True))
    assert step == 1
    convert.load_reference_tree(model, tree)
    (layer,) = [m for m in model.modules() if isinstance(m, lram.LRAM)]
    (seg,) = [k for k in params["segments"] if "memffn" in
              params["segments"][k]]
    want = _np(params)["segments"][seg]["memffn"]["lram"]["values"]
    table = layer.values
    got = (np.concatenate([table.shard_host(i)
                           for i in range(table.num_shards)])
           if lookup.is_store(table) else _bits(table))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    CheckpointManager(str(tmp_path / "port")).save(
        1, convert.reference_tree(model))
    for root, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            mine = os.path.join(root.replace(str(tmp_path / "jax"),
                                             str(tmp_path / "port")), f)
            if f.endswith(".npy") and ("lram" in root + f):
                with open(os.path.join(root, f), "rb") as a, \
                        open(mine, "rb") as b:
                    assert a.read() == b.read(), f


RANK_CODE = """
import os
import numpy as np, torch
import torch.distributed as dist
from repro_torch import quant
from repro_torch.core import lram
from repro_torch.distributed import context, sharding
from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)
out = os.environ["OUT"]
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["TEST_INIT_METHOD"],
                        world_size=2, rank=rank)
context.set_mesh(mesh_lib.make_host_mesh((1, 2)))
inp = np.load(os.path.join(out, "inputs.npz"))
res = {}
for kernel in ("pallas", "reference"):
    cfg = lram.LRAMConfig(log2_locations=16, heads=4, query_norm="rms",
                          interp_impl="sharded", lookup_kernel=kernel,
                          table_dtype="bfloat16")
    layer = lram.LRAM(cfg)
    layer.load_state_dict({
        "qnorm.scale": torch.from_numpy(inp["scale"]),
        "values": torch.from_numpy(inp["bits"].view(np.int16)).view(
            torch.bfloat16)})
    sharding.shard_params(layer, context.get_mesh())
    x = torch.from_numpy(inp["x"]).requires_grad_()
    for _ in range(2):  # two forwards, then one backward
        y = lram.lram_apply(layer, x, train=True)
    (y * torch.from_numpy(inp["g"])).sum().backward()
    res[f"y_{kernel}"] = y.detach().numpy()
    res[f"dx_{kernel}"] = x.grad.numpy()
    res[f"dvalues_{kernel}"] = quant.bf16_bits(layer.values.grad)
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
dist.destroy_process_group()
"""


def test_sharded_bf16_table_on_two_ranks_matches_dense_jax(tmp_path):
    """The `sharded` placement with a bf16 table on 2 gloo ranks (the
    rows split over model 2): each rank's output within 1e-6 and d x to
    rtol 1e-4 of the reference's dense bf16 cell under jax.grad, and the
    two bf16 shards of d values put back in order within one ulp (see the
    module), in both kernel cells (the reference's own sharded gradient is
    red under jax 0.9.0, ROADMAP C1)."""
    from _ranks import run_ranks

    j_cfg = j_lram.LRAMConfig(log2_locations=LOG2, heads=HEADS,
                              query_norm="rms", table_dtype=BF16)
    params, state = j_lram.lram_init(KEY, j_cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 16 * HEADS)).astype(np.float32)
    g = rng.normal(size=(2, 3, 64 * HEADS)).astype(np.float32)

    def j_loss(p, xx):
        y, _ = j_lram.lram_apply(p, state, xx, j_cfg, train=True)
        return jnp.sum(y * g), y

    (_, j_y), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    np.savez(tmp_path / "inputs.npz", x=x, g=g,
             bits=_bits(params["values"]),
             scale=np.asarray(params["qnorm"]["scale"]))
    run_ranks(RANK_CODE, 2, tmp_path, timeout=120,
              env={"OUT": str(tmp_path)})
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for kernel in ("pallas", "reference"):
        dvalues = np.concatenate([r[f"dvalues_{kernel}"] for r in ranks])
        _assert_bf16_close(dvalues, j_gp["values"])
        for r in ranks:
            np.testing.assert_allclose(r[f"y_{kernel}"], np.asarray(j_y),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(r[f"dx_{kernel}"], np.asarray(j_gx),
                                       rtol=1e-4, atol=1e-9)
