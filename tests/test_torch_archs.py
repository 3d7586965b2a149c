"""The dense public archs in the port (yi-9b, qwen2-1.5b, starcoder2-3b,
h2o-danube-3-4b), each with the paper's memory FFN (`with_lram`), held
against the JAX package on weights converted by `launch/convert.py`:
forward logits and a grad step's memory-table gradient in float32 and
bfloat16, decode against the full forward (past the sliding window too),
the serve engine's tokens, bfloat16 conversion and checkpoints both ways,
and the refusals (the serve engine on an enc-dec arch, bfloat16
training, non-float32 queries).

Tolerances: float32 logits to 1e-5 (rtol and atol).  bfloat16 logits to
`bf16_tol`: 2^-8 (one bfloat16 rounding) times (layers + 1) times the
largest reference logit, one rounding's worth a layer plus the head's; the
two packages round different intermediates, and one ulp of the normed
query can swap a top-32 candidate of the memory read.  A bfloat16
memory-table gradient is held in relative Frobenius norm to 2^-8 times
2 (layers + 1): the backward rounds as many intermediates again, and the
swapped candidates (2-3% of the rows touched, measured) move their rows'
gradient whole.  Tokens are compared in float32 only (bfloat16 logits
tie more often)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.launch import serve as j_serve
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import e8_lookup, gather_interp
from repro_torch.launch import convert, serve, train
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

ARCHS = ("yi-9b", "qwen2-1.5b", "starcoder2-3b", "h2o-danube-3-4b")
DTYPES = ("float32", "bfloat16")
LOG2 = 16  # the smallest table the torus allows: a quick CPU lookup
TOL32 = 1e-5


def bf16_tol(cfg, ref) -> float:
    return 2.0**-8 * (cfg.num_layers + 1) * float(np.abs(ref).max())


def assert_close(cfg, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if cfg.dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32)
    else:
        err = float(np.abs(got - want).max())
        assert err <= bf16_tol(cfg, want), (err, bf16_tol(cfg, want))


def _cfgs(arch, dtype, impl="reference"):
    j_cfg = j_configs.with_lram(j_configs.get_smoke_config(arch, dtype=dtype),
                                LOG2)
    cfg = configs.with_lram(configs.get_smoke_config(arch, dtype=dtype),
                            LOG2)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl=impl))
    return j_cfg, cfg


_CACHE = {}


def _pair(arch, dtype):
    """(JAX cfg, params, state, port cfg (pallas placement)), memoised;
    `_model` converts a fresh port model from them."""
    key = (arch, dtype)
    if key not in _CACHE:
        j_cfg, cfg = _cfgs(arch, dtype, "pallas")
        params, state = jax.jit(j_tf.init, static_argnums=1)(
            jax.random.PRNGKey(0), j_cfg)
        _CACHE[key] = (j_cfg, params, state, cfg)
    return _CACHE[key]


def _model(cfg, params, state):
    return convert.model_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, state), cfg,
                                  device="cpu").eval()


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Full (bfloat16) and smoke (float32) configs field for field, with
    and without the memory FFN, and the parameter count."""
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(configs, get)(arch), getattr(j_configs, get)(arch)
        for f in dataclasses.fields(j):
            if f.name not in ("lram", "pkm"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
        t, j = configs.with_lram(t), j_configs.with_lram(j)
        assert (t.name, t.lram_layers) == (j.name, j.lram_layers)
        for f in ("log2_locations", "m", "heads", "top_k", "query_norm",
                  "interp_impl"):
            assert getattr(t.lram, f) == getattr(j.lram, f), f
        assert t.lram.heads == t.d_model // 16
        assert t.param_count() == j.param_count()
    assert configs.get_config(arch).dtype == "bfloat16"
    assert configs.get_smoke_config(arch).dtype == "float32"


def test_arch_lists_cover_the_reference():
    """Every public arch of the reference is registered, in its order."""
    assert configs.ARCHS == j_configs.ARCHS


# ---------------------------------------------------------------------------
# forward, grad step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, dtype):
    j_cfg, params, state, cfg = _pair(arch, dtype)
    model = _model(cfg, params, state)
    assert model.embed.embedding.dtype == cfg.torch_dtype
    memory = next(f"seg{i}" for i, seg in enumerate(
        transformer.layer_plan(cfg)) if seg[0] == "memory")
    assert model.segments[memory].memffn.lram.values.dtype == torch.float32
    toks = _tokens(cfg, 2, 24)
    jl = jax.jit(lambda x: j_tf.forward(params, state, {"tokens": x},
                                        j_cfg)[0])(jnp.asarray(toks))
    with torch.no_grad():
        tl = transformer.forward(model, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == cfg.torch_dtype
    assert_close(cfg, tl.float(), np.asarray(jl).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step_matches(arch, dtype):
    """One train-mode loss and its memory-table gradient (the backward's
    scatter-add): finite, non-zero, and the JAX package's."""
    j_cfg, params, state, cfg = _pair(arch, dtype)
    model = _model(cfg, params, state).train()
    toks, labels = _tokens(cfg, 2, 16, 1), _tokens(cfg, 2, 16, 2)
    (j_loss, _), j_grads = jax.value_and_grad(j_tf.loss_fn, has_aux=True)(
        params, state, {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)}, j_cfg, train=True)
    loss, _ = transformer.loss_fn(model, {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(labels).long()}, train=True)
    loss.backward()
    seg = [k for k in j_grads["segments"]
           if "memffn" in j_grads["segments"][k]][0]
    jg = np.asarray(j_grads["segments"][seg]["memffn"]["lram"]["values"])
    tg = model.segments[seg].memffn.lram.values.grad.numpy()
    assert np.isfinite(tg).all() and np.abs(tg).sum() > 0
    assert (tg != 0).any(axis=1).sum() > 0
    if dtype == "float32":
        assert abs(loss.item() - float(j_loss)) <= TOL32 * abs(float(j_loss))
        np.testing.assert_allclose(tg, jg, rtol=TOL32,
                                   atol=TOL32 * np.abs(jg).max())
    else:
        assert abs(loss.item() - float(j_loss)) <= bf16_tol(
            cfg, np.float32(j_loss))
        rel = np.linalg.norm(tg - jg) / np.linalg.norm(jg)
        assert rel <= 2.0**-8 * 2 * (cfg.num_layers + 1), rel


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Token-by-token decode from an empty cache reproduces the causal
    forward (danube's window 8 wraps its ring at 16 tokens), and each
    step the JAX package's decode logits (float32)."""
    j_cfg, params, state, cfg = _pair(arch, "float32")
    model = _model(cfg, params, state)
    b, s = 2, 16
    toks = _tokens(cfg, b, s, 3)
    with torch.no_grad():
        full = transformer.forward(model, {"tokens": torch.from_numpy(toks)})
    cache = transformer.init_cache(cfg, b, s)
    j_cache = j_tf.init_cache(j_cfg, b, s)
    j_step = jax.jit(lambda tok, pos, c: j_tf.decode_step(
        params, state, tok, pos, c, j_cfg))
    for t in range(s):
        pos = np.full((b,), t, np.int32)
        jd, j_cache = j_step(jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(pos), j_cache)
        with torch.no_grad():
            td = transformer.decode_step(
                model, torch.from_numpy(toks[:, t:t + 1]).long(),
                torch.from_numpy(pos).long(), cache)
        assert_close(cfg, td, np.asarray(jd))
        np.testing.assert_allclose(td[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch, dtype):
    """prefill(prompt) then decode(tail) against the JAX package's, and
    (float32) against the full forward: a 10-token prompt past danube's
    window of 8 fills its ring permuted, and the tail decodes past it."""
    j_cfg, params, state, cfg = _pair(arch, dtype)
    model = _model(cfg, params, state)
    b, s, split = 2, 16, 10
    toks = _tokens(cfg, b, s, 4)
    jl, jc = jax.jit(lambda x: j_tf.prefill(
        params, state, {"tokens": x}, j_cfg, s))(jnp.asarray(toks[:, :split]))
    with torch.no_grad():
        tl, tc = transformer.prefill(
            model, torch.from_numpy(toks[:, :split]).long(), s)
        full = transformer.forward(model, {"tokens": torch.from_numpy(toks)})
    assert_close(cfg, tl.float(), np.asarray(jl).astype(np.float32))
    for name in tc:
        for k in ("k", "v"):
            assert tc[name][k].shape == jc[name][k].shape
            assert tc[name][k].dtype == cfg.torch_dtype
            assert_close(cfg, tc[name][k].float(),
                         np.asarray(jc[name][k]).astype(np.float32))
    j_step = jax.jit(lambda tok, pos, c: j_tf.decode_step(
        params, state, tok, pos, c, j_cfg))
    for t in range(split, s):
        pos = np.full((b,), t, np.int32)
        jd, jc = j_step(jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos), jc)
        with torch.no_grad():
            td = transformer.decode_step(
                model, torch.from_numpy(toks[:, t:t + 1]).long(),
                torch.from_numpy(pos).long(), tc)
        assert_close(cfg, td.float(), np.asarray(jd).astype(np.float32))
        if dtype == "float32":
            np.testing.assert_allclose(td[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_like_reference(arch, dtype):
    """ServeEngine (the memory read on the `pallas` placement: the
    kernels' plain versions here) against the JAX engine on one trace:
    greedy tokens equal in float32, every request's first logits to the
    dtype's tolerance.  Prompts up to 12 tokens pass danube's window, so
    its exact-length prefills fill a wrapped ring."""
    j_cfg, params, state, cfg = _pair(arch, dtype)
    model = _model(cfg, params, state)
    kw = dict(vocab_size=cfg.vocab_size, max_prompt=12, max_gen=6)
    j_rep = JServeEngine(params, state, j_cfg, JEngineConfig(
        slots=2, max_len=18)).run(
            j_synthetic_trace(np.random.default_rng(5), 5, **kw))
    engine = ServeEngine(model, EngineConfig(slots=2, max_len=18))
    trace = synthetic_trace(np.random.default_rng(5), 5, **kw)
    engine.warmup([r.prompt_len for r in trace])
    rep = engine.run(trace)
    assert [r.id for r in rep.requests] == [r.id for r in j_rep.requests]
    for a, b in zip(rep.requests, j_rep.requests):
        assert_close(cfg, a.first_logits, b.first_logits.astype(np.float32))
        if dtype == "float32":
            assert a.tokens == b.tokens
    assert rep.generated_tokens == j_rep.generated_tokens


def test_swa_engine_prefills_at_exact_length():
    _, _, _, cfg = _pair("h2o-danube-3-4b", "float32")
    engine = ServeEngine(transformer.init(cfg), EngineConfig(max_len=40))
    assert [engine.prefill_len(n) for n in (3, 9, 17)] == [3, 9, 17]
    _, _, _, cfg = _pair("yi-9b", "float32")
    engine = ServeEngine(transformer.init(cfg), EngineConfig(max_len=40))
    assert [engine.prefill_len(n) for n in (3, 9, 17)] == [4, 16, 32]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke_arch_on_cpu(capsys, arch):
    """`serve --arch <public arch> --smoke --device cpu --json` (no memory
    layer: plain torch) with `--warmup` over the trace's lengths."""
    rep = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen", "3",
                      "--warmup", "--json"])
    assert len(rep.requests) == 4
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["arch"] == f"{arch}-smoke" and doc["cache"] is None


def test_serve_cli_refusals():
    with pytest.raises(SystemExit, match="no LRAM layer"):
        serve.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                    "--placement", "pallas"])
    # continuous batching serves decoder-only families, as the reference's
    with pytest.raises(ValueError, match="decoder-only families"):
        serve.main(["--arch", "whisper-small", "--smoke", "--device", "cpu"])
    # tenants need a memory layer: the reference's own error, by both CLIs
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--tenants", "2"]
    with pytest.raises(ValueError, match="overlay_rows needs a memory arch"):
        j_serve.main(argv)
    with pytest.raises(ValueError, match="overlay_rows needs a memory arch"):
        serve.main(argv + ["--device", "cpu"])


def test_train_cli_trains_smoke_in_float32_and_bfloat16(monkeypatch):
    """The float32 smoke config trains, and so does the bfloat16 one (the
    registry replaced: `--smoke` is float32, and a full config is too
    large for the CPU): its weights stay bfloat16."""
    run = train.main(["--arch", "starcoder2-3b", "--smoke", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "8"])
    assert len(run.records) == 2
    assert all(np.isfinite(r["loss"]) for r in run.records)
    smoke = configs.get_smoke_config
    monkeypatch.setattr(configs, "get_smoke_config",
                        lambda name: smoke(name, dtype="bfloat16"))
    run = train.main(["--arch", "starcoder2-3b", "--smoke", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "8"])
    assert run.model.embed.embedding.dtype == torch.bfloat16
    assert len(run.records) == 2
    assert all(np.isfinite(r["loss"]) for r in run.records)


# ---------------------------------------------------------------------------
# bfloat16 across the packages: convert, checkpoints, the wrappers
# ---------------------------------------------------------------------------

def test_convert_carries_bfloat16_bits():
    """The JAX package's bfloat16 leaves (ml_dtypes arrays) reach the port
    bit for bit, through int16, without ml_dtypes on the port's side."""
    _, params, state, cfg = _pair("qwen2-1.5b", "bfloat16")
    model = _model(cfg, params, state)
    j_emb = np.asarray(params["embed"]["embedding"])
    assert j_emb.dtype == ml_dtypes.bfloat16
    t_emb = model.embed.embedding.detach()
    assert t_emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_emb.view(torch.int16).numpy(),
                                  j_emb.view(np.int16))
    void = j_emb.view("V2")  # how an .npy of it loads without ml_dtypes
    assert convert.is_bfloat16(void) and convert.is_bfloat16(j_emb)
    assert torch.equal(convert.tensor_from_numpy(void), t_emb)


def test_bfloat16_checkpoints_cross_both_ways(tmp_path):
    """A bfloat16 smoke model's checkpoint: the JAX package's files
    restore into the port bit for bit, and the port writes the same files
    (`<V2` headers, manifest dtypes and crc32s) for the same weights, so
    they restore wherever the JAX package's own do."""
    _, params, state, cfg = _pair("yi-9b", "bfloat16")
    model = _model(cfg, params, state)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JCheckpointManager(j_dir).save(3, {"params": params,
                                       "model_state": state})
    CheckpointManager(t_dir).save(3, convert.reference_tree(model))
    step_dir = "step_000000000003"
    manifests = [json.load(open(os.path.join(d, step_dir, "manifest.json")))
                 for d in (j_dir, t_dir)]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert any(m["dtype"] == "bfloat16"
               for m in manifests[0]["leaves"].values())
    for meta in manifests[0]["leaves"].values():
        a, b = (open(os.path.join(d, step_dir, meta["file"]), "rb").read()
                for d in (j_dir, t_dir))
        assert a == b, meta["file"]
    # the JAX package's files into a fresh port model, bit for bit
    fresh = transformer.init(cfg, seed=7)
    step, tree = CheckpointManager(j_dir).restore(
        convert.reference_tree(fresh, like=True))
    assert step == 3
    convert.load_reference_tree(fresh, tree)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # and the port's own files restore the same
    step, tree = CheckpointManager(t_dir).restore(
        convert.reference_tree(fresh, like=True))
    convert.load_reference_tree(fresh, tree)
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values()))
    # the files hold the JAX package's bfloat16 values
    emb = np.load(os.path.join(t_dir, step_dir,
                               "params__embed__embedding.npy"))
    np.testing.assert_array_equal(
        emb.view(ml_dtypes.bfloat16).astype(np.float32),
        np.asarray(params["embed"]["embedding"]).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
def test_wrappers_raise_for_non_float32_queries(dtype):
    """K2's and K1's wrappers take float32 queries and weights on either
    device and never cast: the memory layer casts before `torus_map`.  K1
    takes a float32, bfloat16 or float16 table (`LRAMConfig.table_dtype`)
    and returns float32; a float64 table raises."""
    spec = configs.with_lram(configs.get_smoke_config("yi-9b"),
                             LOG2).lram.torus_spec
    q = torch.rand(5, 8) * 8
    with pytest.raises(TypeError, match="float32"):
        e8_lookup.lram_query(q.to(dtype), spec)
    idx, w = e8_lookup.lram_query(q, spec)
    values = torch.randn(spec.num_locations, 4)
    with pytest.raises(TypeError, match="float32"):
        gather_interp.gather_interp(values, idx, w.to(dtype))
    if dtype in (torch.bfloat16, torch.float16):
        out = gather_interp.gather_interp(values.to(dtype), idx, w)
        assert out.dtype == torch.float32
    else:
        with pytest.raises(TypeError, match="float32"):
            gather_interp.gather_interp(values.to(dtype), idx, w)
    assert gather_interp.gather_interp(values, idx, w).dtype == torch.float32


def test_cuda_init_draws_on_the_device_leaf_by_leaf():
    """`init(device=...)` builds every leaf on the device from a generator
    there (here the CPU: the same draw as the default), in the config's
    dtype, with the table float32."""
    cfg = configs.with_lram(configs.get_smoke_config(
        "h2o-danube-3-4b", dtype="bfloat16"), LOG2)
    a, b = transformer.init(cfg, seed=3), transformer.init(
        cfg, seed=3, device="cpu")
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
        want = torch.float32 if k.endswith(("values", "mean", "var")) \
            else torch.bfloat16
        assert x.dtype == want, k
