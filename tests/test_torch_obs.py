"""The port's observability layer (`repro_torch.obs`) against the JAX
package's (`repro.obs`): the same registry operations give the same
snapshots, quantiles and Prometheus text byte for byte; the device
accumulators give the reference's counts (and raise where it drops);
spans nest and carry counter deltas as the reference tracer's do; the
JSONL files and summary documents cross both ways; the tiered stores,
the serve engine and the lifecycle controller emit the reference's
counters, spans and events on the same weights and trace; obs off is
free (tokens, losses and launch counts); both CLIs write files the
reference validates.  Every test arms obs itself, and a fixture disarms
both packages around it."""

import importlib
import json
import math
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from repro import configs as j_configs
from repro import memctl as j_memctl
from repro import memstore as j_memstore
from repro import obs as j_obs
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs, kernels, memctl, obs
from repro_torch.distributed.sharded_lram import ShardedTieredStore
from repro_torch.launch import convert, serve, train
from repro_torch.memstore import TieredSpec, TieredValueStore
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

# `obs.registry` the accessor shadows the submodule on both packages
reg = importlib.import_module("repro_torch.obs.registry")
j_reg = importlib.import_module("repro.obs.registry")
j_export = j_obs.export
KEY = jax.random.PRNGKey(0)
STORE_COUNTERS = ("memstore.hits", "memstore.misses", "memstore.uncached",
                  "memstore.fills", "memstore.evictions",
                  "memstore.writebacks")


@pytest.fixture(autouse=True)
def _obs_off():
    """Each test starts and ends with both packages' default: off."""
    obs.disable()
    j_obs.disable()
    yield
    obs.disable()
    j_obs.disable()


@pytest.fixture
def one_thread():
    """One intra-op thread, for engine comparisons bit for bit (several
    may split a CPU product's sum another way from run to run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _values(snapshot: dict) -> dict:
    return {k: v["value"] for k, v in snapshot.items() if "value" in v}


def _span_names(tracer) -> set:
    return {s.name for s in tracer.finished}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

BUCKETS = (0.001, 0.01, 0.1, 1.0)
LATENCY = obs.LATENCY_BUCKETS_S
_NAMES = {"inc": "c", "set": "g", "add": "g", "observe": "h", "merge": "h"}
_op = st.one_of(
    st.tuples(st.just("inc"), st.integers(0, 2),
              st.floats(0, 1e3, allow_nan=False)),
    st.tuples(st.sampled_from(["set", "add"]), st.integers(0, 2),
              st.floats(-1e3, 1e3, allow_nan=False)),
    st.tuples(st.just("observe"), st.integers(0, 2),
              st.floats(0, 20, allow_nan=False)),
    st.tuples(st.just("merge"), st.integers(0, 2),
              st.lists(st.integers(0, 5), min_size=5, max_size=5)),
)


@settings(max_examples=60, deadline=None)
@given(st.lists(_op, max_size=40))
def test_registry_ops_match_reference(ops):
    """A random sequence of inc / set / add / observe / merge_counts on
    both registries: equal snapshots and quantiles, and the Prometheus
    text byte for byte."""
    regs = (reg.MetricsRegistry(), j_reg.MetricsRegistry())
    for r in regs:  # the first histogram on the default latency buckets
        r.counter("c.0", help="the first counter")
        r.histogram("h.0")
    for kind, i, v in ops:
        name = f"{_NAMES[kind]}.{i}"
        for r in regs:
            if kind == "inc":
                r.counter(name).inc(v)
            elif kind in ("set", "add"):
                getattr(r.gauge(name), kind)(v)
            else:
                h = r.histogram(name, buckets=LATENCY if i == 0
                                else BUCKETS)
                if kind == "observe":
                    h.observe(v)
                else:
                    h.merge_counts(v + [0] * (len(h.bounds) - 4),
                                   total=sum(v) * 0.01)
    port, ref = regs
    assert port.snapshot() == ref.snapshot()
    for name, m in ((m.name, m) for m in port.metrics()
                    if m.kind == "histogram"):
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert m.quantile(q) == ref.histogram(name).quantile(q)
    text = obs.prometheus_text(port)
    assert text == j_export.prometheus_text(ref)
    j_export.validate_prometheus_text(text)


@pytest.mark.parametrize("case", ["kind", "empty", "order", "drain",
                                  "negative"])
def test_registry_rules_raise_as_reference(case):
    """Kind conflicts, bad buckets, a bad drain and a negative increment
    raise ValueError with the reference's message."""
    def run(mod):
        r = mod.MetricsRegistry()
        if case == "kind":
            r.counter("x")
            r.gauge("x")
        elif case == "empty":
            mod.Histogram("h", buckets=())
        elif case == "order":
            mod.Histogram("h", buckets=(1.0, 1.0))
        elif case == "drain":
            mod.Histogram("h", buckets=(1.0, 2.0)).merge_counts([1, 2])
        else:
            r.counter("c").inc(-1)

    with pytest.raises(ValueError) as ref:
        run(j_reg)
    with pytest.raises(ValueError) as got:
        run(reg)
    assert str(got.value) == str(ref.value)


def test_disabled_registry_is_the_shared_null_metric():
    r = reg.MetricsRegistry(enabled=False)
    c = r.counter("c")
    assert c is reg.NULL_METRIC and c is r.histogram("h") is r.gauge("g")
    c.inc()
    c.observe(1.0)
    c.set(2.0)
    assert c.get() == 0.0 and r.snapshot() == {}
    assert not obs.enabled()
    assert obs.counter("anything") is reg.NULL_METRIC
    with obs.span("nothing") as sp:
        sp.set_attr("k", 1)
    assert obs.tracer().span_count() == 0
    doc = obs.metrics_doc()
    assert doc == j_obs.metrics_doc()
    assert doc["enabled"] is False and doc["metrics"] == {}


def test_metrics_exact_under_threads():
    """8 threads against one counter, gauge and histogram, the interpreter
    switching every microsecond: no update lost."""
    r = reg.MetricsRegistry()
    c, g, h = r.counter("c"), r.gauge("g"), r.histogram("h")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker():
        for _ in range(1000):
            c.inc()
            g.add(1)
            h.observe(0.003)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert c.get() == g.get() == 8000.0 and h.count == 8000


# ---------------------------------------------------------------------------
# the device accumulators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_accum_add_matches_reference(weighted):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 64, size=(3, 40)).astype(np.int32)
    w = rng.uniform(0, 1, size=idx.shape).astype(np.float32)
    got = reg.accum_init(64)
    want = j_reg.accum_init(64)
    for _ in range(2):
        got = reg.accum_add(got, torch.from_numpy(idx),
                            torch.from_numpy(w) if weighted else None)
        want = j_reg.accum_add(want, idx, w if weighted else None)
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if not weighted:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hist_bucket_add_drains_as_reference():
    """Bucketed on the device and drained through `merge_counts`: the
    reference's accumulator, and the histogram of observing each value
    (bounds binary-exact, as the reference's test picks them)."""
    bounds = (0.25, 1.0, 4.0)
    values = np.asarray([0.125, 0.25, 2.0, 100.0, 0.5, 4.0, 1.0],
                        np.float32)
    acc = reg.accum_init(len(bounds) + 1)
    j_acc = j_reg.accum_init(len(bounds) + 1)
    for _ in range(2):
        acc = reg.hist_bucket_add(acc, torch.from_numpy(values), bounds)
        j_acc = j_reg.hist_bucket_add(j_acc, values, bounds)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    h = reg.Histogram("h", buckets=bounds)
    h.merge_counts(acc, total=2 * float(values.sum()))
    ref = j_reg.Histogram("ref", buckets=bounds)
    for v in values.tolist() * 2:
        ref.observe(v)
    assert h.snapshot()["counts"] == ref.snapshot()["counts"]
    assert h.sum == pytest.approx(ref.sum, rel=1e-6)


@pytest.mark.parametrize("bad", [-1, 16])
def test_accumulators_raise_where_the_reference_drops(bad):
    """JAX wraps -1 and drops 16 on 16 slots; the port raises on both,
    and on a histogram accumulator of the wrong size."""
    acc = reg.accum_init(16)
    with pytest.raises(IndexError, match="out of range"):
        reg.accum_add(acc, torch.tensor([0, bad, 3]))
    assert float(acc.sum()) == 0.0  # the input is never changed
    with pytest.raises(ValueError, match="needs 3 slots"):
        reg.hist_bucket_add(acc, torch.tensor([0.5]), (1.0, 2.0))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _span_script(o):
    """One sequence of spans, counters and attributes (both packages)."""
    with o.span("outer", tag="a") as so:
        o.counter("work.items").inc(3)
        with o.span("inner"):
            o.counter("work.items").inc(2)
            o.counter("work.bytes").inc(64)
        with o.span("quiet", k=1) as sq:
            sq.set_attr("late", "x")
        so.set_attr("n", 2)
    with o.span("second"):
        o.counter("work.items").inc(1)


def test_spans_match_reference_tracer(tmp_path):
    """Nesting, parent ids, attributes and counter deltas: the events of
    the same sequence equal the reference tracer's, apart from t0_s and
    dur_s, in memory and in the JSONL file."""
    docs = []
    for pkg, sub in ((obs, "port"), (j_obs, "ref")):
        pkg.configure(metrics_dir=str(tmp_path / sub))
        _span_script(pkg)
        docs.append([{k: v for k, v in s.to_event().items()
                      if k not in ("t0_s", "dur_s")}
                     for s in pkg.tracer().finished])
        pkg.disable()
    assert docs[0] == docs[1]
    spans = {d["name"]: d for d in docs[0]}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["outer"]["metrics"] == {"work.items": 5.0,
                                         "work.bytes": 64.0}
    assert spans["quiet"]["metrics"] == {}
    assert spans["second"]["parent"] is None
    files = [[{k: v for k, v in e.items() if k not in ("t0_s", "dur_s")}
              for e in obs.read_jsonl(str(tmp_path / sub / obs.JSONL_NAME))]
             for sub in ("port", "ref")]
    assert files[0] == files[1] == docs[0]


def test_max_spans_counts_the_dropped():
    tracer = obs.Tracer(reg.MetricsRegistry(), max_spans=2)
    for i in range(5):
        with tracer.span("s", i=i):
            pass
    assert len(tracer.finished) == 2 and tracer.dropped == 3
    assert tracer.span_count() == 5


# ---------------------------------------------------------------------------
# files and documents across the packages
# ---------------------------------------------------------------------------

def _write_files(pkg, path):
    pkg.configure(metrics_dir=str(path))
    with pkg.span("serve.run", mode="continuous"):
        with pkg.span("serve.decode_tick", tick=0):
            pkg.counter("serve.tokens").inc(4)
            pkg.histogram("serve.decode_step_s").observe(0.002)
    pkg.gauge("memctl.num_locations").set(65536)
    pkg.emit_event("memctl.spill", tick=0, placement="dense->tiered")
    pkg.flush()
    doc = pkg.metrics_doc()
    pkg.disable()
    return doc


def test_files_cross_both_ways(tmp_path):
    """The port's metrics.jsonl reads (and validates) with the reference's
    `read_jsonl` and the reference's with the port's; both textfiles pass
    both validators and are equal; each `validate_metrics_doc` accepts
    the other's document."""
    port_doc = _write_files(obs, tmp_path / "port")
    ref_doc = _write_files(j_obs, tmp_path / "ref")
    strip = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                          if k not in ("t0_s", "dur_s", "t_s")}
                         for e in evs]
    port_jsonl = str(tmp_path / "port" / obs.JSONL_NAME)
    ref_jsonl = str(tmp_path / "ref" / j_obs.JSONL_NAME)
    assert strip(j_export.read_jsonl(port_jsonl)) == \
        strip(obs.read_jsonl(ref_jsonl))
    assert {e["kind"] for e in obs.read_jsonl(ref_jsonl)} == {
        "span", "event", "metrics"}
    prom = [(tmp_path / sub / obs.PROM_NAME).read_text()
            for sub in ("port", "ref")]
    assert prom[0] == prom[1]
    assert "repro_serve_tokens_total 4.0" in prom[0]
    for text in prom:
        obs.export.validate_prometheus_text(text)
        j_export.validate_prometheus_text(text)
    j_export.validate_metrics_doc(port_doc)
    obs.validate_metrics_doc(ref_doc)
    assert port_doc == ref_doc


MALFORMED = [
    "not a dict",
    {"kind": "nope"},
    {"kind": "span", "name": "bad name!", "id": 1, "t0_s": 0, "dur_s": 0},
    {"kind": "span", "name": "s", "id": "one", "t0_s": 0, "dur_s": 0},
    {"kind": "span", "name": "s", "id": 1, "t0_s": 0, "dur_s": -1},
    {"kind": "span", "name": "s", "id": 1, "t0_s": 0, "dur_s": 0,
     "metrics": {"m": float("nan")}},
    {"kind": "event", "name": "e"},
    {"kind": "metrics", "t_s": 0, "metrics": {"m": {"kind": "alien"}}},
    {"kind": "metrics", "t_s": 0,
     "metrics": {"h": {"kind": "histogram", "buckets": [1.0],
                       "counts": [1], "sum": 0.0}}},
]


@pytest.mark.parametrize("bad", MALFORMED)
def test_malformed_events_rejected_by_both(bad):
    """The reference's malformed events: each package's `validate_event`
    rejects each with the same message."""
    with pytest.raises(ValueError) as ref:
        j_export.validate_event(bad)
    with pytest.raises(ValueError) as got:
        obs.validate_event(bad)
    assert str(got.value) == str(ref.value)


def test_malformed_metrics_docs_rejected_by_both():
    obs.configure(enabled=True)
    obs.counter("a.b").inc()
    obs.histogram("a.lat").observe(0.01)
    doc = obs.metrics_doc()
    for corrupt in ({**doc, "schema": "v0"}, {**doc, "enabled": "yes"},
                    {**doc, "spans": -1},
                    {**doc, "metrics": {"x": {"kind": "counter",
                                              "value": None}}}, []):
        for validate in (obs.validate_metrics_doc,
                         j_export.validate_metrics_doc):
            with pytest.raises(ValueError):
                validate(corrupt)


# ---------------------------------------------------------------------------
# the stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant_kind", ["none", "int8", "fp8"])
def test_store_counters_match_reference_store(quant_kind):
    """The same table and index sequence through a port store and a JAX
    store, obs armed in both: every `memstore.*` counter equal, and each
    equal to the store's own stats."""
    rng = np.random.default_rng(3)
    dense = (rng.normal(size=(16 * 64, 16)) * 0.02).astype(np.float32)
    kw = dict(shard_rows=64, cache_slots=4, use_pallas=True,
              quant=quant_kind)
    obs.configure(enabled=True)
    j_obs.configure(enabled=True)
    j_store = j_memstore.TieredValueStore.from_dense(
        dense, j_memstore.TieredSpec(**kw))
    store = TieredValueStore.from_dense(j_store.to_dense(), TieredSpec(**kw))
    for s in (store, j_store):
        s.writeback_lr = 0.1
        s.warm()
    for shards, n in (([0, 1, 2], 4), ([3, 5, 6], 4),
                      (list(range(8, 16)), 6), ([1, 2, 12], 4)):
        idx = (np.asarray(shards)[rng.integers(0, len(shards), (n, 8))]
               * 64 + rng.integers(0, 64, (n, 8))).astype(np.int32)
        w = rng.uniform(0, 1, size=idx.shape).astype(np.float32)
        store.gather(torch.from_numpy(idx), torch.from_numpy(w))
        j_store.gather(idx, w)
        wg = rng.normal(size=idx.shape + (16,)).astype(np.float32)
        store.apply_writeback(idx, wg)
        j_store.apply_writeback(idx, wg)
        store.prefetch_last()
        j_store.prefetch_last()
    got = _values(obs.registry().snapshot())
    want = _values(j_obs.registry().snapshot())
    assert got == want
    for name in STORE_COUNTERS + ("memstore.fill_bytes",):
        assert got[name] == store.stats[name.split(".")[1]] > 0
    for name in ("memstore.fill_s", "memstore.device_sync_s"):
        assert obs.registry().snapshot()[name]["count"] == \
            j_obs.registry().snapshot()[name]["count"] > 0


def test_sharded_store_gauge_and_counters():
    """A `ShardedTieredStore`'s prefetch fans out to its ranges on the
    pool (switching threads every microsecond): the queue-depth gauge is
    the ranges a fan-out reached, and the counters are the ranges' stats
    summed."""
    rng = np.random.default_rng(8)
    dense = rng.normal(size=(16384, 8)).astype(np.float32)
    obs.configure(enabled=True)
    store = ShardedTieredStore.from_dense(
        dense, TieredSpec(shard_rows=256, cache_slots=2), 16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            idx = torch.from_numpy(rng.integers(0, 16384, size=(256, 1))
                                   .astype(np.int32))
            store.gather(idx, torch.ones(idx.shape))
            store.prefetch_last()
            assert obs.gauge("memstore.prefetch_queue_depth").get() == 16
    finally:
        sys.setswitchinterval(interval)
    got = _values(obs.registry().snapshot())
    for name in STORE_COUNTERS[:5] + ("memstore.fill_bytes",):
        key = name.split(".")[1]
        assert got.get(name, 0.0) == sum(p.stats[key] for p in store.parts)
    assert got["memstore.hits"] + got["memstore.misses"] \
        + got["memstore.uncached"] == 3 * 256


# ---------------------------------------------------------------------------
# the serve engine against the JAX engine
# ---------------------------------------------------------------------------

def _tiered_models(placement, tenants=0):
    """lram-tiered's smoke config on `placement`, the JAX engine and a
    port engine on its converted weights, and the same trace for both."""
    import dataclasses

    cfgs = []
    for mod in (configs, j_configs):
        cfg = mod.get_smoke_config("lram-tiered")
        cfgs.append(dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, interp_impl=placement)))
    cfg, j_cfg = cfgs
    params, state = j_tf.init(KEY, j_cfg)

    def np_tree(tree):
        if isinstance(tree, dict):
            return {k: np_tree(v) for k, v in tree.items()}
        if isinstance(tree, j_memstore.TieredValueStore):
            return tree.to_dense()
        return np.asarray(tree)

    model = convert.model_from_jax(np_tree(params), np_tree(state), cfg,
                                   device="cpu")
    kw = dict(vocab_size=256, max_prompt=9, max_gen=5, tenants=tenants)
    ecfg = dict(slots=2, max_len=14, overlay_rows=4 if tenants else 0)
    return (ServeEngine(model, EngineConfig(**ecfg)),
            synthetic_trace(np.random.default_rng(4), 4, **kw),
            JServeEngine(params, state, j_cfg, JEngineConfig(**ecfg)),
            j_synthetic_trace(np.random.default_rng(4), 4, **kw))


@pytest.mark.parametrize("placement,tenants", [
    ("tiered", 0), ("reference", 0), ("pallas", 2)])
def test_engine_obs_matches_jax_engine(placement, tenants, one_thread):
    """The same weights and trace through both engines, obs armed in
    both: equal tokens; `serve.tokens`, `admitted`, `retired` (and
    `overlay_writebacks` with tenants) and every `memstore.*` counter
    equal; the same metric and span names.  `memstore.fill_bytes` is not
    held equal: the reference's jitted lookups read the host mirror and
    copy nothing to the device after the warm fill, the port's gather on
    the device from the cache they keep in sync, so the port counts the
    warm fill's bytes (the reference's whole count) plus its stores'."""
    engine, trace, j_engine, j_trace = _tiered_models(placement, tenants)
    obs.configure(enabled=True)
    j_obs.configure(enabled=True)
    report = engine.run(trace)
    j_report = j_engine.run(j_trace)
    assert [r.tokens for r in report.requests] == \
        [r.tokens for r in j_report.requests]
    got = obs.registry().snapshot()
    want = j_obs.registry().snapshot()
    assert set(got) == set(want)
    assert _span_names(obs.tracer()) == _span_names(j_obs.tracer()) == {
        "serve.run", "serve.admit", "serve.prefill", "serve.decode_tick",
        "serve.retire"}
    got_v, want_v = _values(got), _values(want)
    names = ["serve.tokens", "serve.admitted", "serve.retired"]
    if tenants:
        names.append("serve.overlay_writebacks")
    if placement == "tiered":
        names += [n for n in STORE_COUNTERS if n in want_v]
        (store,) = [s for _, s in engine.stores]
        assert got_v["memstore.fill_bytes"] == \
            want_v["memstore.fill_bytes"] + store.stats["fill_bytes"]
    for name in names:
        assert got_v[name] == want_v[name] > 0, name
    for name in ("serve.decode_step_s", "serve.prefill_s",
                 "serve.request_latency_s"):
        assert got[name]["count"] == want[name]["count"] > 0
    assert got_v["serve.tokens"] == report.generated_tokens - len(trace)
    ticks = [s for s in obs.tracer().finished
             if s.name == "serve.decode_tick"]
    assert len(ticks) == len(report.step_s) == \
        got["serve.decode_step_s"]["count"]
    (run,) = [s for s in obs.tracer().finished if s.name == "serve.run"]
    assert all(s.parent_id == run.span_id for s in ticks)
    if placement == "tiered":  # the stores' counters land on the spans
        for name in ("memstore.hits", "memstore.misses",
                     "memstore.uncached"):
            assert sum(s.metrics.get(name, 0.0)
                       for s in obs.tracer().finished
                       if s.name in ("serve.decode_tick", "serve.prefill")
                       ) == got_v[name]
    summary = report.summary("lram-tiered")
    obs.validate_metrics_doc(summary["metrics"])
    j_export.validate_metrics_doc(summary["metrics"])


def _serve_once(model_seed=0):
    cfg = configs.get_smoke_config("lram-tiered")
    model = transformer.init(cfg, seed=model_seed)
    trace = synthetic_trace(np.random.default_rng(3), 4,
                            vocab_size=cfg.vocab_size, max_prompt=6,
                            max_gen=5)
    counters = kernels.launch_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    report = ServeEngine(model, EngineConfig(slots=2, max_len=11)).run(trace)
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    return ([r.tokens for r in report.requests],
            [r.first_logits for r in report.requests], launches)


def test_obs_on_serving_is_free(tmp_path, one_thread):
    """A serve with obs armed gives the tokens, first logits (bit for
    bit) and kernel launch counts of the same serve with it off, and the
    instrumented layers reported."""
    off = _serve_once()
    obs.configure(metrics_dir=str(tmp_path))
    on = _serve_once()
    assert on[0] == off[0] and on[2] == off[2]
    for a, b in zip(on[1], off[1]):
        np.testing.assert_array_equal(a, b)
    doc = obs.metrics_doc()
    assert doc["metrics"]["serve.tokens"]["value"] > 0
    assert doc["metrics"]["memstore.fills"]["value"] > 0


def test_obs_on_training_is_free(tmp_path):
    """The train CLI with and without `--metrics-dir`: every loss and
    gradient norm bit for bit, one `train.step` span a step."""
    argv = ["--arch", "lram-bert-medium", "--smoke", "--device", "cpu",
            "--placement", "pallas", "--steps", "3", "--batch", "2",
            "--seq", "16"]
    off = train.main(argv)
    on = train.main(argv + ["--metrics-dir", str(tmp_path)])
    for key in ("loss", "grad_norm"):
        assert [r[key] for r in on.records] == [r[key] for r in off.records]
    steps = [e for e in obs.read_jsonl(str(tmp_path / obs.JSONL_NAME))
             if e["kind"] == "span"]
    assert [(e["name"], e["attrs"]["step"]) for e in steps] == \
        [("train.step", i) for i in range(3)]


# ---------------------------------------------------------------------------
# the lifecycle controller
# ---------------------------------------------------------------------------

def _events(path):
    return [(e["name"], {k: v for k, v in e["attrs"].items()
                         if k != "pause_s"})
            for e in obs.read_jsonl(str(path)) if e["kind"] == "event"]


def test_spill_events_match_reference(tmp_path, one_thread):
    """A live spill at tick 2 on the same weights and trace: the
    reference controller's events, attributes equal apart from pause_s;
    one `memctl.spill` span; `memctl.table_device_bytes` ends at the
    tiered caches' bytes and the `memctl.util_*` gauges are set, as the
    reference's."""
    engine, trace, j_engine, j_trace = _tiered_models("reference")
    for pkg, sub, e in ((obs, "port", engine), (j_obs, "ref", j_engine)):
        pkg.configure(metrics_dir=str(tmp_path / sub))
        e.controller = (memctl if pkg is obs else j_memctl).MemoryController(
            (memctl if pkg is obs else j_memctl).LifecyclePolicy(
                spill_at_tick=2))
    report = engine.run(trace)
    j_report = j_engine.run(j_trace)
    assert [r.tokens for r in report.requests] == \
        [r.tokens for r in j_report.requests]
    got = _values(obs.registry().snapshot())
    want = _values(j_obs.registry().snapshot())
    assert [s.name for s in obs.tracer().finished
            if s.name.startswith("memctl")] == ["memctl.spill"]
    for name in ("memctl.table_device_bytes", "memctl.util_dead_frac",
                 "memctl.util_hot_mass", "memctl.util_cold_frac"):
        assert got[name] == want[name], name
    assert got["memctl.table_device_bytes"] > 0
    obs.disable()
    j_obs.disable()
    events = _events(tmp_path / "port" / obs.JSONL_NAME)
    assert events == _events(tmp_path / "ref" / obs.JSONL_NAME) == [
        ("memctl.spill", {"tick": 2, "placement": "dense->tiered"})]


def test_grow_events_match_reference(tmp_path):
    """A growth at step 2 through both controllers: the reference's
    events and span, attributes equal apart from pause_s, and
    `memctl.num_locations` at the grown size."""
    cfgs = []
    for mod in (configs, j_configs):
        cfgs.append(mod.get_smoke_config("lram-bert-medium"))
    params, state = j_tf.init(KEY, cfgs[1])
    model = transformer.init(cfgs[0])
    obs.configure(metrics_dir=str(tmp_path / "port"))
    j_obs.configure(metrics_dir=str(tmp_path / "ref"))
    ctl = memctl.MemoryController(memctl.LifecyclePolicy(
        grow_at=memctl.parse_grow_at("2:17")))
    j_ctl = j_memctl.MemoryController(j_memctl.LifecyclePolicy(
        grow_at=j_memctl.parse_grow_at("2:17")))
    for step in range(3):
        ctl.on_train_step(step, model)
        j_ctl.on_train_step(step, params, cfgs[1])
    assert obs.gauge("memctl.num_locations").get() == \
        j_obs.gauge("memctl.num_locations").get() == 2**17
    assert [s.name for s in obs.tracer().finished] == \
        [s.name for s in j_obs.tracer().finished] == ["memctl.grow"]
    obs.disable()
    j_obs.disable()
    events = _events(tmp_path / "port" / obs.JSONL_NAME)
    assert events == _events(tmp_path / "ref" / obs.JSONL_NAME) == [
        ("memctl.grow", {"step": 2, "new_log2": 17})]


def test_overlay_events_coerce_as_reference(tmp_path):
    """Each overlay lifecycle event becomes a `memctl.overlay` event,
    values that are not scalars written as strings, as the reference
    controller writes it."""

    class _Manager:
        def enforce(self, **kw):
            return [{"event": "overlay_spill", "tenant": 3,
                     "path": ["a", "b"], "bytes": 1.5}]

    class _Engine:
        overlays, ticks, stores = _Manager(), 4, []

    for pkg, mod, sub in ((obs, memctl, "port"), (j_obs, j_memctl, "ref")):
        pkg.configure(metrics_dir=str(tmp_path / sub))
        mod.MemoryController(mod.LifecyclePolicy(
            tenant_ttl_ticks=1))._overlay_tick(_Engine())
        pkg.disable()
    assert _events(tmp_path / "port" / obs.JSONL_NAME) == \
        _events(tmp_path / "ref" / obs.JSONL_NAME) == [
            ("memctl.overlay", {"event": "overlay_spill", "tenant": 3,
                                "path": "['a', 'b']", "bytes": 1.5})]


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _validated_by_reference(path):
    events = j_export.read_jsonl(str(path / obs.JSONL_NAME))
    j_export.validate_prometheus_text((path / obs.PROM_NAME).read_text())
    return events


def test_serve_cli_writes_files_the_reference_validates(tmp_path, capsys):
    report = serve.main(["--arch", "lram-tiered", "--smoke", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "6",
                         "--gen", "4", "--requests", "3", "--json",
                         "--metrics-dir", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    j_export.validate_metrics_doc(summary["metrics"])
    events = _validated_by_reference(tmp_path)
    snap = [e for e in events if e["kind"] == "metrics"][-1]["metrics"]
    assert snap["serve.tokens"]["value"] + 3 == report.generated_tokens
    assert snap == summary["metrics"]["metrics"]
    assert sum(e.get("name") == "serve.run" for e in events) == 1


def test_train_cli_writes_files_the_reference_validates(tmp_path, capsys):
    """`train --metrics-dir --telemetry --grow-at`: both files validate;
    the `train.util_*` gauges are the last utilisation report's."""
    run = train.main(["--arch", "lram-bert-medium", "--smoke", "--device",
                      "cpu", "--placement", "pallas", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--grow-at", "1:17",
                      "--telemetry", "--log-every", "1", "--metrics-dir",
                      str(tmp_path)])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith('{"step"')]
    last = [x for x in out if "utilisation_report" in x][-1]
    events = _validated_by_reference(tmp_path)
    snap = [e for e in events if e["kind"] == "metrics"][-1]["metrics"]
    for row, name in zip(last["utilisation_report"],
                         ("dead_frac", "hot_mass", "cold_frac")):
        assert snap[f"train.util_{name}"]["value"] == float(
            row[2].split()[0])
    assert snap["memctl.num_locations"]["value"] == 2**17
    assert [e["name"] for e in events if e["kind"] == "span"] == [
        "train.step", "memctl.grow", "train.step", "train.step"]
    assert len(run.records) == 3


@pytest.mark.parametrize("cli", [serve, train])
def test_profile_dir_needs_metrics_dir(cli, tmp_path):
    with pytest.raises(SystemExit, match="--profile-dir needs "
                                         "--metrics-dir"):
        cli.main(["--smoke", "--device", "cpu", "--profile-dir",
                  str(tmp_path)])
    assert not os.listdir(tmp_path) and not obs.enabled()


def test_profile_dir_writes_a_torch_trace_on_cpu(tmp_path):
    """`serve --profile-dir` on the CPU: one torch.profiler Chrome trace
    of the `serve.run` span (CPU activities; the engine's ops in it),
    named by the span's `profile_trace` attribute."""
    serve.main(["--arch", "lram-tiered", "--smoke", "--device", "cpu",
                "--batch", "1", "--prompt-len", "4", "--gen", "2",
                "--requests", "1", "--metrics-dir", str(tmp_path / "m"),
                "--profile-dir", str(tmp_path / "p")])
    (name,) = os.listdir(tmp_path / "p")
    assert name.startswith("serve.run.") and name.endswith(".pt.trace.json")
    trace = json.loads((tmp_path / "p" / name).read_text())
    assert any(str(e.get("name")).startswith("aten::")
               for e in trace["traceEvents"])
    (run,) = [e for e in obs.read_jsonl(str(tmp_path / "m" / obs.JSONL_NAME))
              if e.get("name") == "serve.run"]
    assert run["attrs"]["profile_trace"] == str(tmp_path / "p" / name)
    assert math.isfinite(run["dur_s"])
