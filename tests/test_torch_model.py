"""Port parity for the slice as a whole: the `lram-tiered` smoke config on
weights converted from the JAX package, against the JAX model and engine
with `--placement reference` (the same function, fast on the CPU)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs
from repro_torch.launch import convert, serve
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

ATOL = 1e-4  # logits: float32 sums in another order, top-k tie swaps


def _placed(cfg, impl):
    return dataclasses.replace(
        cfg, lram=dataclasses.replace(cfg.lram, interp_impl=impl))


@pytest.fixture(scope="module")
def pair():
    j_cfg = _placed(j_configs.get_smoke_config("lram-tiered"), "reference")
    cfg = _placed(configs.get_smoke_config("lram-tiered"), "pallas")
    params, state = jax.jit(j_tf.init, static_argnums=1)(
        jax.random.PRNGKey(0), j_cfg)
    model = convert.model_from_jax(jax.tree.map(np.asarray, params),
                                   jax.tree.map(np.asarray, state), cfg,
                                   device="cpu")
    return j_cfg, params, state, model.eval()


def test_config_shape_matches_reference():
    for get in ("get_config", "get_smoke_config"):
        t, j = (getattr(configs, get)("lram-tiered"),
                getattr(j_configs, get)("lram-tiered"))
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "act", "norm",
                  "pos_scheme", "objective", "lram_layers", "head_dim"):
            assert getattr(t, f) == getattr(j, f), f
        for f in ("log2_locations", "m", "heads", "top_k", "query_norm",
                  "interp_impl"):
            assert getattr(t.lram, f) == getattr(j.lram, f), f
        assert t.param_count() == j.param_count()


def test_cache_layout_matches_reference():
    cfg = configs.get_smoke_config("lram-tiered")
    j_cfg = j_configs.get_smoke_config("lram-tiered")
    shapes = transformer.cache_shapes(cfg, 3, 20)
    j_shapes = j_tf.cache_shapes(j_cfg, 3, 20)
    assert {n: {k: v[0] for k, v in s.items()} for n, s in shapes.items()} \
        == {n: {k: v[0] for k, v in s.items()} for n, s in j_shapes.items()}
    assert transformer.cache_batch_axes(cfg, 20) == \
        j_tf.cache_batch_axes(j_cfg, 20)


def test_forward_matches(pair):
    j_cfg, params, state, model = pair
    toks = np.random.default_rng(0).integers(0, 256, (2, 10))
    jl = jax.jit(lambda x: j_tf.forward(params, state, {"tokens": x},
                                        j_cfg)[0])(jnp.asarray(toks))
    with torch.no_grad():
        tl = transformer.forward(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_prefill_and_per_slot_decode_match(pair):
    """Prefill logits and caches, then three decode steps with one
    position per slot (slots at different depths), to 1e-4."""
    j_cfg, params, state, model = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (3, 8)).astype(np.int32)
    jl, jc = jax.jit(lambda x: j_tf.prefill(
        params, state, {"tokens": x}, j_cfg, 16))(jnp.asarray(toks))
    j_decode = jax.jit(lambda tok, pos, cache: j_tf.decode_step(
        params, state, tok, pos, cache, j_cfg))
    with torch.no_grad():
        tl, tc = transformer.prefill(model, torch.from_numpy(toks).long(),
                                     16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for name in tc:
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[name][k].numpy(),
                                       np.asarray(jc[name][k]), atol=ATOL)
    pos = np.array([8, 3, 15], np.int32)  # 15 = cache end: clamped write
    for _ in range(3):
        tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
        jd, jc = j_decode(jnp.asarray(tok), jnp.asarray(pos), jc)
        with torch.no_grad():
            td = transformer.decode_step(model, torch.from_numpy(tok).long(),
                                         torch.from_numpy(pos).long(), tc)
        assert td.shape == (3, 1, 256)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
        pos = np.minimum(pos + 1, 15)


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_engine_greedy_tokens_match(pair, mode):
    """ServeEngine's greedy tokens equal the JAX engine's on one rate-0
    trace; every request's first logits to 1e-4."""
    j_cfg, params, state, model = pair
    kw = dict(vocab_size=256, max_prompt=9, max_gen=6)
    j_rep = JServeEngine(params, state, j_cfg, JEngineConfig(
        slots=2, max_len=15, mode=mode)).run(
            j_synthetic_trace(np.random.default_rng(4), 5, **kw))
    rep = ServeEngine(model, EngineConfig(slots=2, max_len=15,
                                          mode=mode)).run(
        synthetic_trace(np.random.default_rng(4), 5, **kw))
    assert [r.id for r in rep.requests] == [r.id for r in j_rep.requests]
    for a, b in zip(rep.requests, j_rep.requests):
        assert a.tokens == b.tokens
        np.testing.assert_allclose(a.first_logits, b.first_logits,
                                   atol=ATOL)
    assert rep.generated_tokens == j_rep.generated_tokens
    assert len(rep.step_s) == len(j_rep.step_s)


def test_serve_cli_on_cpu(capsys):
    rep = serve.main(["--arch", "lram-tiered", "--smoke", "--placement",
                      "pallas", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen", "3", "--json"])
    assert len(rep.requests) == 4
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["arch"] == "lram-tiered" and doc["cache"] is None


@pytest.mark.parametrize("arch", ["lram-tiered", "lram-tiered-q8"])
def test_serve_cli_tiered_on_cpu(capsys, arch):
    """Both archs on their own tiered placement (no --placement); `--json`
    carries the store's cache summary and per-request hit rates."""
    rep = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6", "--gen", "3",
                      "--json"])
    assert len(rep.requests) == 4
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["arch"] == arch
    cache = doc["cache"]
    assert cache["hits"] + cache["misses"] + cache["uncached"] > 0
    assert 0.0 <= cache["hit_rate"] <= 1.0 and cache["fills"] > 0
    assert all(r["cache_hit_rate"] is not None for r in doc["requests"])


def test_serve_cli_refuses_unported_and_missing_device():
    from repro_torch.core.lookup import LookupPlanError

    # the reference's serve CLI builds no mesh either: sharded cannot serve
    with pytest.raises(LookupPlanError, match="needs an ambient mesh"):
        serve.main(["--smoke", "--device", "cpu", "--placement", "sharded"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--smoke", "--placement", "pallas"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_convert_defaults_to_the_card_and_refuses_without_one(pair):
    """model_from_jax runs on cuda unless asked for the CPU: with no card
    and no device it raises instead of building a CPU model."""
    _, params, state, _ = pair
    cfg = _placed(configs.get_smoke_config("lram-tiered"), "pallas")
    args = (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.model_from_jax(*args)
    assert convert.model_from_jax(*args, device="cpu") \
        .embed.embedding.device.type == "cpu"


def test_engine_warmup_leaves_tokens_unchanged(pair):
    """A warmed engine serves the same greedy tokens and first logits as a
    cold one: warm-up writes only cache rows that admission overwrites."""
    *_, model = pair
    kw = dict(vocab_size=256, max_prompt=9, max_gen=6)
    reports = []
    for warm in (False, True):
        engine = ServeEngine(model, EngineConfig(slots=2, max_len=15))
        if warm:  # every length a prompt of the trace can have
            engine.warmup(range(1, 10))
        reports.append(engine.run(
            synthetic_trace(np.random.default_rng(4), 5, **kw)))
    cold, warm = reports
    assert [r.tokens for r in warm.requests] == \
        [r.tokens for r in cold.requests]
    for a, b in zip(warm.requests, cold.requests):
        np.testing.assert_array_equal(a.first_logits, b.first_logits)
