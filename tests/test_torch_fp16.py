"""Port parity for float16 memory tables (`LRAMConfig.table_dtype =
"float16"`) against the JAX package, on every placement where the
reference builds one (float16 models of every family are in
`test_torch_fp16_models.py`; float16 training and the PKM in a 2-byte
model in `test_torch_fp16_train.py`).

The reference draws its table in float16; the converter carries the same
bits into the port, and each cell's table is built from them by both
packages' plans: a dense fp16 tensor, a 1-byte table quantized from the
fp16 values, a tiered store whose host tier is fp16 (in RAM or
memmapped: a numpy float16 array in both packages, a `<f2` `.npy`) under
an fp32 cache, a tiered int8 store, a sharded-tiered store of 2 fp16
ranges, and the row-sharded table on 2 gloo ranks.  The port's kernels
run their plain versions on the CPU; the CUDA instances are held against
those on the card (`test_torch_cuda.py`, `chip_smoke.py` path (q)).

Tolerances: forward outputs 1e-6 abs.  The table's gradient is rounded
to float16 once in both packages; the fp32 sums behind it add in another
order, so each element is within one fp16 ulp of the reference's or,
where a sum cancels to far below the gradient's scale, within 1e-3 of
its largest magnitude.  d x to rtol 1e-4.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from test_torch_bf16_table import CELLS, SHARD_ROWS, _np, _spec, _trace
from repro import configs as j_configs
from repro import data as j_data
from repro import optim as j_optim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import lookup as j_lookup
from repro.core import lram as j_lram
from repro.launch import train as j_train
from repro.memctl.migrate import migrate_table as j_migrate_table
from repro.memstore import TieredSpec as JSpec
from repro.memstore import TieredValueStore as JStore
from repro.models import transformer as j_tf
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs, optim, quant
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import lookup, lram
from repro_torch.kernels import gather_interp, ops, sharded_gather
from repro_torch.launch import convert, train
from repro_torch.memctl.migrate import migrate_table
from repro_torch.memstore import TieredSpec, TieredValueStore
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

F16 = "float16"
KEY = jax.random.PRNGKey(0)
LOG2, HEADS = 16, 4
def _cfgs(cell, tmp_path=None):
    """(port LRAMConfig, reference LRAMConfig) of a cell, fp16 tables."""
    kw = dict(CELLS[cell])
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
                                  query_norm="rms", table_dtype=F16,
                                  tiered=tiered, **kw))
    return tuple(out)


def _words(a) -> np.ndarray:
    """The 16-bit words of an fp16 array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float16)).view(np.uint16)


def _assert_f16_close(got, want):
    """Each element of two fp16 gradients within one ulp, or within 1e-3
    of the gradient's largest magnitude where an fp32 sum cancels."""
    a = _words(got).view(np.int16).astype(np.int32)
    b = _words(want).view(np.int16).astype(np.int32)
    # ulps apart (the sign-magnitude words mapped to a monotone scale)
    a = np.where(a < 0, -32768 - a, a)
    b = np.where(b < 0, -32768 - b, b)
    gf = np.asarray(got, np.float32) if not isinstance(got, torch.Tensor) \
        else got.float().numpy()
    wf = np.asarray(want).astype(np.float32)
    near = np.abs(gf - wf) <= 1e-3 * np.abs(wf).max()
    assert np.all((np.abs(a - b) <= 1) | near)
    assert np.count_nonzero(np.abs(a - b) > 1) <= 1e-4 * a.size


def _layer_pair(cell, tmp_path):
    """The reference's layer (its fp16 draw, built into the cell's table
    by its plan) and the port's on the same bits and query norm."""
    cfg, j_cfg = _cfgs(cell, tmp_path)
    dense = dataclasses.replace(j_cfg, interp_impl="reference",
                                table_quant="none", tiered=None,
                                model_shards=0)
    params, state = j_lram.lram_init(KEY, dense)
    assert params["values"].dtype == jnp.float16
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
def test_fp16_cells_match_reference(cell, tmp_path):
    """Each cell from the same fp16 bits: the table in the reference's
    storage (fp16 values, payloads and scales, host tiers bit for bit; a
    memmap's `.npy` is the reference's file byte for byte, `<f2` both),
    the layer's output within 1e-6, and in the trainable dense cells the
    fp16 table gradient (see the module) and d x (rtol 1e-4) of a sum of
    squares.  `table_bytes_per_entry` and a store's `bytes_per_entry`
    equal the reference's (2m)."""
    cfg, j_cfg, params, state, layer, draw = _layer_pair(cell, tmp_path)
    assert cfg.table_bytes_per_entry == j_cfg.table_bytes_per_entry
    table, j_table = layer.values, params["values"]
    if lookup.is_store(table):
        assert table.bytes_per_entry() == j_table.bytes_per_entry()
        parts = getattr(table, "parts", [table])
        j_parts = getattr(j_table, "parts", [j_table])
        for p, jp in zip(parts, j_parts):
            assert p.dtype == (torch.float32 if p.quant != "none"
                               else torch.float16)
            assert p._host.dtype == np.asarray(jp._host).dtype
            np.testing.assert_array_equal(
                np.ascontiguousarray(p._host).view(np.uint8),
                np.ascontiguousarray(np.asarray(jp._host)).view(np.uint8))
        if cell == "tiered-mmap":
            with open(table._host.filename, "rb") as f, \
                    open(j_table._host.filename, "rb") as g:
                a, b = f.read(), g.read()
            assert b"'descr': '<f2'" in a[:128] and a == b
    elif isinstance(table, quant.QuantizedTable):
        q, scale = lookup.host_quantized(table)
        np.testing.assert_array_equal(
            q.view(np.uint8), np.asarray(j_table.q).view(np.uint8))
        np.testing.assert_array_equal(scale, np.asarray(j_table.scale))
    else:
        assert table.dtype == torch.float16
        np.testing.assert_array_equal(_words(table), _words(draw))
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
    assert layer.values.grad.dtype == torch.float16
    assert j_gp["values"].dtype == jnp.float16
    _assert_f16_close(layer.values.grad, j_gp["values"])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx),
                               rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("storage", ["none", "int8", "fp8"])
def test_fp16_table_bytes_per_entry_matches_reference(storage):
    """Bytes a row of an fp16 table: 2m, or m + 4 for a 1-byte row and its
    scale, as the reference's `table_bytes_per_entry`."""
    kw = dict(log2_locations=LOG2, heads=HEADS, table_dtype=F16,
              table_quant=storage)
    got = lram.LRAMConfig(**kw).table_bytes_per_entry
    assert got == j_lram.LRAMConfig(**kw).table_bytes_per_entry
    assert storage != "none" or got == 2 * 64


# ---------------------------------------------------------------------------
# the kernels' fp16 wrappers on the CPU
# ---------------------------------------------------------------------------

def test_fp16_wrappers_take_plain_versions_on_cpu_and_check_dtypes():
    """The fp16 wrappers take a float16 table (its instance's plain
    version on a CPU tensor: the rows widened, an fp32 sum, the fp32
    output the fp32 path gives on the widened table bit for bit; the
    backward's dvalues fp32) and raise on any other dtype, never cast;
    no launch is counted on the CPU."""
    spec = lram.LRAMConfig(log2_locations=LOG2).torus_spec
    rng = np.random.default_rng(0)
    values = torch.from_numpy((rng.normal(size=(2**LOG2, 8)) * 0.02)
                              .astype(np.float16))
    q = torch.from_numpy(rng.uniform(0, 8, (5, 8)).astype(np.float32))
    idx, w = ops.e8_lookup.lram_query(q, spec)
    g = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    wide = values.float()
    counts = [f.launches for f in (gather_interp.gather_interp_f16,
                                   ops.lookup_bwd_f16,
                                   sharded_gather.sharded_gather_f16,
                                   ops.lookup_bwd_range_f16)]
    out = gather_interp.gather_interp_f16(values, idx, w)
    assert out.dtype == torch.float32
    assert torch.equal(out, gather_interp.gather_interp(wide, idx, w))
    dv, dq = ops.lookup_bwd_f16(values, idx, w, g, q, spec)
    dv32, dq32 = ops.lookup_bwd(wide, idx, w, g, q, spec)
    assert dv.dtype == torch.float32
    assert torch.equal(dv, dv32) and torch.equal(dq, dq32)
    half = 2**LOG2 // 2
    shard = values[half:]
    part = sharded_gather.sharded_gather_f16(shard, idx, w, half)
    assert torch.equal(part, sharded_gather.sharded_gather(
        shard.float(), idx, w, half))
    dvr, dqr = ops.lookup_bwd_range_f16(shard, idx, w, g, half, q=q,
                                        spec=spec)
    assert dvr.shape == shard.shape and dvr.dtype == torch.float32
    assert counts == [f.launches for f in (
        gather_interp.gather_interp_f16, ops.lookup_bwd_f16,
        sharded_gather.sharded_gather_f16, ops.lookup_bwd_range_f16)]
    for other in (torch.float32, torch.bfloat16, torch.float64):
        v = values.to(other)
        for call in (lambda: gather_interp.gather_interp_f16(v, idx, w),
                     lambda: ops.lookup_bwd_f16(v, idx, w, g),
                     lambda: sharded_gather.sharded_gather_f16(v, idx, w, 0),
                     lambda: ops.lookup_bwd_range_f16(v, idx, w, g, 0)):
            with pytest.raises(TypeError, match="float16"):
                call()
    with pytest.raises(TypeError, match="float32"):
        gather_interp.gather_interp(values, idx, w.half())


# ---------------------------------------------------------------------------
# the fp16 host tier: fills, evictions and the write-back
# ---------------------------------------------------------------------------

ROWS, SMALL_SHARD, M = 16 * 64, 64, 8


def _store_pair(seed=0, slots=4):
    """A reference store and a port store over the same fp16 table."""
    rng = np.random.default_rng(seed)
    dense = (rng.normal(size=(ROWS, M)) * 0.02).astype(np.float16)
    kw = dict(shard_rows=SMALL_SHARD, cache_slots=slots)
    j_store = JStore.from_dense(dense, JSpec(**kw))
    store = TieredValueStore.from_dense(torch.from_numpy(dense),
                                        TieredSpec(**kw))
    return j_store, store


def _same_store(store, j_store):
    assert store.stats == j_store.stats
    assert store._dirty == j_store._dirty
    assert store.resident_shards() == j_store.resident_shards()
    assert store._host.dtype == j_store._host.dtype == np.float16
    np.testing.assert_array_equal(_words(store._host), _words(j_store._host))
    np.testing.assert_array_equal(store.cache_np, j_store.cache_np)


@settings(max_examples=25, deadline=None)
@given(ops_=st.lists(st.tuples(
    st.sampled_from(["gather", "writeback", "dup_writeback", "prefetch",
                     "flush"]),
    st.integers(0, 2**31 - 1)), min_size=1, max_size=8))
def test_fp16_host_tier_tracks_reference(ops_):
    """An fp16 host tier under the fp32 cache (4 slots, 16 shards) through
    random lookups (fills, evictions of dirty slots, overflow batches),
    write-backs (resident rows into the fp32 cache; the others into the
    fp16 tier, the reference's `np.add.at` on its float16 array,
    duplicates included), prefetches and flushes: after every step the
    host bits, the cache mirror, the stats and the dirty set equal the
    reference store's; `to_dense()` holds the reference's fp16 values."""
    j_store, store = _store_pair()
    j_store.writeback_lr = store.writeback_lr = 0.5
    for kind, seed in ops_:
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
        np.testing.assert_array_equal(_words(store.shard_host(i)),
                                      _words(j_store.shard_host(i)))


def test_fp16_writeback_rounds_each_duplicate_in_turn():
    """Two updates of one non-resident fp16 row, each 0.3 of an ulp of
    it: the reference's np.add.at rounds after each add, so the row does
    not move, where a sum taken first would have moved it; the port's
    tier is the reference's bit for bit."""
    j_store, store = _store_pair(slots=1)
    row = 5 * SMALL_SHARD + 3
    base = store._host[5, 3].astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(base))) - 10)  # fp16: 11 bits
    wg = np.zeros((2, M), np.float32)
    wg[:] = -0.3 * ulp / 0.5  # -lr * wg = +0.3 ulp each
    for s in (store, j_store):
        s.writeback_lr = 0.5
        s.apply_writeback(np.array([row, row], np.int32), wg)
    np.testing.assert_array_equal(_words(store._host[5, 3]),
                                  _words(j_store._host[5, 3]))
    np.testing.assert_array_equal(store._host[5, 3].astype(np.float32),
                                  base)


def test_bf16_rows_load_into_an_fp16_tier_as_values():
    """bf16 rows loaded into an fp16 tiered store, as a restore or a
    migration of a bf16 table does: a shard given as its bits (uint16,
    or the reference's 2-byte void type), resident or not, and a whole
    table given as a bf16 tensor land in the fp16 tier as the reference's
    `astype` of the bf16 values puts them, and a resident shard's cached
    copy holds those values widened."""
    j_store, store = _store_pair(slots=2)
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(
        (rng.normal(size=(ROWS, M)) * 0.02).astype(np.float32)
    ).to(torch.bfloat16)
    bits = vals.view(torch.int16).numpy().view(np.uint16)
    j_vals = vals.float().numpy().astype(jnp.bfloat16)
    resident = (2 * SMALL_SHARD + np.arange(4, dtype=np.int32))[None]
    store.prefetch(resident)
    j_store.prefetch(resident)
    for i, arr in ((2, bits), (5, bits.view(np.dtype("V2")))):
        sl = slice(i * SMALL_SHARD, (i + 1) * SMALL_SHARD)
        store.load_shard(i, arr[sl])
        j_store.load_shard(i, j_vals[sl])
        _same_store(store, j_store)
    assert np.abs(store._host[2].astype(np.float32)).max() < 1
    store.load_dense(vals)
    j_store.load_dense(j_vals)
    _same_store(store, j_store)


# ---------------------------------------------------------------------------
# serving, the spill, training and checkpoints on an fp16 table
# ---------------------------------------------------------------------------

def _tiny_cfgs(**lram_kw):
    """The reference's tiny overlay model (2 layers, d_model 32, the
    memory layer at 1) with an fp16 table, port and JAX."""
    lram_kw = dict(dict(query_norm="rms", interp_impl="reference",
                        table_dtype=F16), **lram_kw)
    tiered = lram_kw.pop("tiered", None)
    out = []
    for mod, mc, spec in ((lram, ModelConfig, TieredSpec),
                          (j_lram, JModelConfig, JSpec)):
        out.append(mc(
            name="tiny-f16", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=97,
            objective="clm", remat=False, lram_layers=(1,),
            lram=mod.memffn_config(32, 16, tiered=None if tiered is None
                                   else spec(**tiered), **lram_kw)))
    return tuple(out)


@pytest.mark.parametrize("case", ["dense", "tiered"])
def test_engine_tokens_match_jax_on_an_fp16_table(case):
    """The serve engine on the tiny model's converted weights with an fp16
    table: the same trace's tokens as the JAX engine's, on the dense
    table and on a tiered store with an fp16 host tier (8 of 32 shards
    cached); first logits within 1e-5."""
    kw = {}
    if case == "tiered":
        kw = dict(interp_impl="tiered",
                  tiered=dict(shard_rows=SHARD_ROWS, cache_slots=8))
    cfg, j_cfg = _tiny_cfgs(**kw)
    params, state = j_tf.init(KEY, j_cfg)
    m = convert.model_from_jax(_np(params), _np(state), cfg, device="cpu")
    (layer,) = [x for x in m.modules() if isinstance(x, lram.LRAM)]
    assert layer.values.dtype == torch.float16
    ecfg = dict(slots=2, max_len=12)
    trace, j_trace = _trace(3, 4)
    report = ServeEngine(m, EngineConfig(**ecfg)).run(trace)
    ref = JServeEngine(params, state, j_cfg, JEngineConfig(**ecfg)) \
        .run(j_trace)
    assert [r.tokens for r in report.requests] == \
        [r.tokens for r in ref.requests]
    for a, b in zip(report.requests, ref.requests):
        np.testing.assert_allclose(a.first_logits, b.first_logits,
                                   atol=1e-5)


def test_spill_of_a_dense_fp16_table_keeps_an_fp16_tier():
    """A dense fp16 table spilled to the tiered placement: an fp16 host
    tier holding the table's bits (2 bytes a value), whose values are the
    reference's migrated store's (a float32 host tier there: its
    `build_empty` takes no dtype)."""
    cfg, j_cfg = _tiny_cfgs()
    params, state = j_tf.init(KEY, j_cfg)
    m = convert.model_from_jax(_np(params), _np(state), cfg, device="cpu")
    (layer,) = [x for x in m.modules() if isinstance(x, lram.LRAM)]
    words = _words(layer.values).copy()
    dst = dataclasses.replace(cfg.lram, interp_impl="tiered")
    j_dst = dataclasses.replace(j_cfg.lram, interp_impl="tiered")
    store = migrate_table(layer.values, cfg.lram, dst)
    (seg,) = [k for k in params["segments"] if "memffn" in
              params["segments"][k]]
    j_store = j_migrate_table(
        params["segments"][seg]["memffn"]["lram"]["values"], j_cfg.lram,
        j_dst)
    assert store.dtype == torch.float16 and store.bytes_per_entry() == 128
    np.testing.assert_array_equal(_words(store._host).reshape(words.shape),
                                  words)
    assert j_store.dtype == np.float32
    np.testing.assert_array_equal(store.to_dense(), j_store.to_dense())


def test_three_train_steps_on_an_fp16_table_match_jax_losses():
    """lram-bert-medium's smoke config with an fp16 table on the pallas
    cell (the kernels' plain versions; the table's gradient rounded to
    fp16 once, Adam's moments fp32 and the update cast back): three steps
    from the converted weights on the reference's batches, every loss
    within rtol 1e-5 of the reference's train step; the table stays fp16
    and moves."""
    j_cfg = j_configs.get_smoke_config("lram-bert-medium")
    j_cfg = dataclasses.replace(j_cfg, lram=dataclasses.replace(
        j_cfg.lram, table_dtype=F16))
    cfg = configs.get_smoke_config("lram-bert-medium")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, table_dtype=F16, interp_impl="pallas"))
    params, state = j_tf.init(KEY, j_cfg)
    m = convert.model_from_jax(_np(params), _np(state), cfg, device="cpu")
    (layer,) = [x for x in m.modules() if isinstance(x, lram.LRAM)]
    before = layer.values.detach().clone()
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=32,
                             global_batch=4, objective=j_cfg.objective,
                             seed=0)
    j_step = j_train.build_train_step(j_cfg, j_optim.OptimConfig(lr=1e-4))
    j_opt, residual = j_optim.adam_init(params), jnp.zeros(())
    opt_state = optim.adam_init(dict(m.named_parameters()))
    step = train.build_train_step(m, optim.OptimConfig(lr=1e-4))
    losses, j_losses = [], []
    for s in range(3):
        b = j_data.get_batch(dcfg, step=s)
        params, j_opt, state, residual, jm = j_step(
            params, j_opt, state, residual, jax.tree.map(jnp.asarray, b))
        j_losses.append(float(jm["loss"]))
        losses.append(step(opt_state, train.batch_to(b, "cpu"))["loss"]
                      .item())
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert layer.values.dtype == torch.float16
    assert not torch.equal(layer.values, before)


def _same_files(a_dir, b_dir):
    """Every `.npy` under a_dir equals the one at the same place under
    b_dir byte for byte; returns how many there were."""
    n = 0
    for root, _, files in os.walk(a_dir):
        for f in files:
            if f.endswith(".npy"):
                other = os.path.join(root.replace(str(a_dir), str(b_dir)), f)
                with open(os.path.join(root, f), "rb") as x, \
                        open(other, "rb") as y:
                    assert x.read() == y.read(), f
                n += 1
    return n


@pytest.mark.parametrize("placement", ["dense", "tiered"])
def test_fp16_table_checkpoints_cross_both_ways(placement, tmp_path):
    """The tiny model with an fp16 table: the reference's checkpoint (a
    `<f2` leaf, or a tiered store's `<f2` shards under manifest dtype
    "float16") restores into the port bit for bit, the port's save of
    the same model writes the reference's files byte for byte, and the
    reference restores the port's checkpoint to its own table."""
    kw = {} if placement == "dense" else dict(
        interp_impl="tiered", tiered=dict(shard_rows=SHARD_ROWS,
                                          cache_slots=8))
    cfg, j_cfg = _tiny_cfgs(**kw)
    params, state = j_tf.init(KEY, j_cfg)
    j_dir, t_dir = tmp_path / "jax", tmp_path / "port"
    JCheckpointManager(str(j_dir)).save(
        1, {"params": params, "model_state": state})
    m = transformer.init(cfg, seed=1)  # other weights, then restored
    step, tree = CheckpointManager(str(j_dir)).restore(
        convert.reference_tree(m, like=True))
    assert step == 1
    convert.load_reference_tree(m, tree)
    (layer,) = [x for x in m.modules() if isinstance(x, lram.LRAM)]
    (seg,) = [k for k in params["segments"] if "memffn" in
              params["segments"][k]]
    want = _np(params)["segments"][seg]["memffn"]["lram"]["values"]
    table = layer.values
    got = (np.concatenate([table.shard_host(i)
                           for i in range(table.num_shards)])
           if lookup.is_store(table) else table.detach().numpy())
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_array_equal(_words(got), _words(want))
    CheckpointManager(str(t_dir)).save(1, convert.reference_tree(m))
    assert _same_files(j_dir, t_dir) > 0
    manifests = [json.load(open(d / "step_000000000001" / "manifest.json"))
                 for d in (j_dir, t_dir)]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    j_params, j_state = j_tf.init(jax.random.PRNGKey(9), j_cfg)
    j_step, j_tree = JCheckpointManager(str(t_dir)).restore(
        {"params": j_params, "model_state": j_state})
    assert j_step == 1
    back = _np(j_tree["params"])["segments"][seg]["memffn"]["lram"]["values"]
    np.testing.assert_array_equal(_words(back), _words(want))


RANK_CODE = """
import os
import numpy as np, torch
import torch.distributed as dist
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
                          table_dtype="float16")
    layer = lram.LRAM(cfg)
    layer.load_state_dict({
        "qnorm.scale": torch.from_numpy(inp["scale"]),
        "values": torch.from_numpy(inp["values"])})
    sharding.shard_params(layer, context.get_mesh())
    x = torch.from_numpy(inp["x"]).requires_grad_()
    for _ in range(2):  # two forwards, then one backward
        y = lram.lram_apply(layer, x, train=True)
    (y * torch.from_numpy(inp["g"])).sum().backward()
    assert layer.values.dtype == layer.values.grad.dtype == torch.float16
    res[f"y_{kernel}"] = y.detach().numpy()
    res[f"dx_{kernel}"] = x.grad.numpy()
    res[f"dvalues_{kernel}"] = layer.values.grad.numpy()
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
dist.destroy_process_group()
"""


def test_sharded_fp16_table_on_two_ranks_matches_dense_jax(tmp_path):
    """The `sharded` placement with an fp16 table on 2 gloo ranks (the
    rows split over model 2): each rank's output within 1e-6 and d x to
    rtol 1e-4 of the reference's dense fp16 cell under jax.grad, and the
    two fp16 shards of d values put back in order within one ulp (see the
    module), in both kernel cells (the reference's own sharded gradient is
    red under jax 0.9.0, ROADMAP C1)."""
    from _ranks import run_ranks

    j_cfg = j_lram.LRAMConfig(log2_locations=LOG2, heads=HEADS,
                              query_norm="rms", table_dtype=F16)
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
             values=np.asarray(params["values"]),
             scale=np.asarray(params["qnorm"]["scale"]))
    run_ranks(RANK_CODE, 2, tmp_path, timeout=120,
              env={"OUT": str(tmp_path)})
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for kernel in ("pallas", "reference"):
        dvalues = np.concatenate([r[f"dvalues_{kernel}"] for r in ranks])
        _assert_f16_close(dvalues, j_gp["values"])
        for r in ranks:
            np.testing.assert_allclose(r[f"y_{kernel}"], np.asarray(j_y),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(r[f"dx_{kernel}"], np.asarray(j_gx),
                                       rtol=1e-4, atol=1e-9)
