"""The SSM family in the port (mamba2-1.3b), with the paper's memory FFN
(`with_lram`) on the residual stream, held against the JAX package on
weights converted by `launch/convert.py`: the config, the Mamba-2 pieces
(`ssd_chunked`, `ssd_sequential`, the causal conv, `mamba_apply`,
`mamba_decode`), the float32 leaves of a bfloat16 model, forward logits,
a train-mode loss and the table gradient, prefill (the conv tail shorter
than the kernel too) then decode with the SSM state and conv window,
decode against the full forward, the serve engine at exact-length
prefills, checkpoints both ways, and the CLIs.

Tolerances (`tests/_families.py`): float32 to 1e-5 against the compiled
JAX package; bfloat16 to `bf16_tol` (2^-8 x (layers + 1) x the largest
reference logit) against the JAX package run op by op."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (TOL32, assert_close, f32, model, oracle, pair,
                       tokens)
from repro import configs as j_configs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.models import mamba2 as j_mamba
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import convert, serve, train
from repro_torch.models import mamba2, transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

ARCH = "mamba2-1.3b"
DTYPES = ("float32", "bfloat16")


def test_configs_match_reference():
    """Full (bfloat16) and smoke (float32) configs field for field, with
    and without the memory FFN, and the parameter counts."""
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(configs, get)(ARCH), getattr(j_configs, get)(ARCH)
        for f in dataclasses.fields(j):
            if f.name not in ("lram", "pkm"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
        assert (t.d_inner, t.ssm_heads) == (j.d_inner, j.ssm_heads)
        t, j = configs.with_lram(t), j_configs.with_lram(j)
        assert (t.name, t.lram_layers) == (j.name, j.lram_layers)
        assert t.lram.heads == j.lram.heads == t.d_model // 16
        assert t.param_count() == j.param_count()
    cfg = configs.get_config(ARCH)
    assert (cfg.dtype, cfg.family, cfg.ssm_heads) == ("bfloat16", "ssm", 64)
    assert configs.get_smoke_config(ARCH).dtype == "float32"


# ---------------------------------------------------------------------------
# the Mamba-2 pieces
# ---------------------------------------------------------------------------

def _scan_inputs(b, s, h, p, g, n, seed=0):
    """x, B, C, dt (positive, ~softplus range), A (negative) as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, (h,)).astype(np.float32)
    return x, B, C, dt, A


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches(with_h0):
    """The chunked scan (4 chunks of 8, 2 groups of 4 heads) against the
    JAX package's and against the sequential recurrence: outputs and
    final state, float32; with and without an initial state."""
    ins = _scan_inputs(2, 32, 8, 4, 2, 6)
    h0 = (np.random.default_rng(9).standard_normal((2, 8, 6, 4)).astype(
        np.float32) if with_h0 else None)
    y, hf = mamba2.ssd_chunked(*_t(*ins), chunk=8,
                               h0=None if h0 is None else torch.from_numpy(h0))
    jy, jh = j_mamba.ssd_chunked(*_j(*ins), chunk=8,
                                 h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), f32(jy), rtol=TOL32, atol=TOL32)
    np.testing.assert_allclose(hf.numpy(), f32(jh), rtol=TOL32, atol=TOL32)
    ys, hs = mamba2.ssd_sequential(
        *_t(*ins), h0=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), ys.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hf.numpy(), hs.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        mamba2.ssd_chunked(*_t(*ins), chunk=7)


def test_ssd_sequential_matches():
    """The sequential recurrence against the JAX package's, from a state."""
    ins = _scan_inputs(2, 5, 4, 3, 1, 6, seed=1)
    h0 = np.random.default_rng(2).standard_normal((2, 4, 6, 3)).astype(
        np.float32)
    y, hf = mamba2.ssd_sequential(*_t(*ins), h0=torch.from_numpy(h0))
    jy, jh = j_mamba.ssd_sequential(*_j(*ins), h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), f32(jy), rtol=TOL32, atol=TOL32)
    np.testing.assert_allclose(hf.numpy(), f32(jh), rtol=TOL32, atol=TOL32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [2, 7])
def test_causal_conv_matches(s, dtype):
    """The depthwise causal conv (float32 inside, cast to the input's
    dtype) against the JAX package's: bit for bit in bfloat16 (one
    rounding of the same float32 sums, up to their order: 1e-5 before
    it), S shorter and longer than the kernel."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    out = mamba2.causal_conv(torch.from_numpy(f32(jx)).to(tdt),
                             torch.from_numpy(f32(jw)).to(tdt))
    want = j_mamba._causal_conv(jx, jw)
    assert out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), f32(want), rtol=TOL32,
                                   atol=TOL32)
    else:
        err = np.abs(out.float().numpy() - f32(want))
        assert err.max() <= 2.0**-8 * np.abs(f32(want)).max()


def _mixer(dtype, seed=1):
    """(JAX cfg, JAX mamba params, port Mamba) with the same leaves."""
    j_cfg = j_configs.get_smoke_config(ARCH, dtype=dtype)
    cfg = configs.get_smoke_config(ARCH, dtype=dtype)
    params = j_mamba.mamba_init(jax.random.PRNGKey(seed), j_cfg,
                                dtype=jnp.dtype(dtype))
    m = mamba2.Mamba(cfg)
    m.load_state_dict({k: convert.tensor_from_numpy(v) for k, v in
                       convert._flatten(jax.tree.map(np.asarray,
                                                     params)).items()})
    return j_cfg, params, m


def test_mixer_leaves_keep_the_reference_dtypes_and_draws():
    """In a bfloat16 model A_log, D and dt_bias stay float32, and the
    port's own draw of A_log and dt_bias (numpy's default_rng(0)) equals
    the reference's in every layer; the other leaves take the dtype."""
    j_cfg, params, _ = _mixer("bfloat16")
    own = mamba2.Mamba(configs.get_smoke_config(ARCH, dtype="bfloat16"))
    for name in ("A_log", "D", "dt_bias"):
        leaf = getattr(own, name)
        assert leaf.dtype == torch.float32, name
        np.testing.assert_array_equal(leaf.detach().numpy(),
                                      np.asarray(params[name]))
    for name in ("conv", "in_proj.kernel", "norm.scale", "out_proj.kernel"):
        assert own.state_dict()[name].dtype == torch.bfloat16, name
    cfg = configs.get_smoke_config(ARCH)
    assert own.in_proj.kernel.shape == (
        cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
    assert own.conv.shape == (cfg.ssm_conv, cfg.d_inner + 2 * cfg.ssm_state)


@pytest.mark.parametrize("chunked", [True, False])
def test_mamba_apply_matches(chunked):
    """The mixer over 8 positions (a multiple of the smoke chunk 4: the
    chunked form, or the sequential one when asked), float32."""
    j_cfg, params, m = _mixer("float32")
    u = np.random.default_rng(3).standard_normal(
        (2, 8, j_cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        got = mamba2.mamba_apply(m, torch.from_numpy(u), chunked=chunked)
    want = j_mamba.mamba_apply(params, jnp.asarray(u), j_cfg,
                               chunked=chunked)
    np.testing.assert_allclose(got.numpy(), f32(want), rtol=TOL32,
                               atol=TOL32)


def test_mamba_decode_matches():
    """One decode step from a random state and conv window: output, new
    state and window against the JAX package's; the port writes the
    state and window in place."""
    j_cfg, params, m = _mixer("float32")
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 1, j_cfg.d_model)).astype(np.float32)
    shapes = j_mamba.mamba_cache_shapes(j_cfg, 2)
    assert shapes == mamba2.mamba_cache_shapes(configs.get_smoke_config(
        ARCH), 2)
    cache = {k: rng.standard_normal(v).astype(np.float32)
             for k, v in shapes.items()}
    want, j_new = j_mamba.mamba_decode(params, jnp.asarray(u), j_cfg,
                                       {k: jnp.asarray(v)
                                        for k, v in cache.items()})
    t_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    views = dict(t_cache)
    with torch.no_grad():
        got = mamba2.mamba_decode(m, torch.from_numpy(u), t_cache)
    np.testing.assert_allclose(got.numpy(), f32(want), rtol=TOL32,
                               atol=TOL32)
    for k in shapes:
        assert t_cache[k] is views[k]
        np.testing.assert_allclose(t_cache[k].numpy(), f32(j_new[k]),
                                   rtol=TOL32, atol=TOL32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_memory_layer_on_the_residual_stream():
    """The memory layer of an SSM host has no attention and no decode
    cache, but owns the attention leaves the reference builds (the two
    trees hold as many parameters); the runs' caches are the float32 SSM
    state and conv window."""
    _, params, _, cfg = pair(ARCH, "bfloat16")
    plan = transformer.layer_plan(cfg)
    m = transformer.init(cfg)
    mem = next(f"seg{i}" for i, seg in enumerate(plan) if seg[0] == "memory")
    layer = m.segments[mem]
    assert layer.attention_free and hasattr(layer, "attn")
    shapes = transformer.cache_shapes(cfg, 3, 10)
    assert shapes[mem] == {}
    run = shapes["seg0"]
    n = plan[0][1]
    assert run["ssm"] == ((n, 3, cfg.ssm_heads, cfg.ssm_state,
                           cfg.ssm_headdim), torch.float32)
    assert run["conv"] == ((n, 3, cfg.ssm_conv - 1,
                            cfg.d_inner + 2 * cfg.ssm_state), torch.float32)
    assert transformer.cache_batch_axes(cfg, 10) == {
        "seg0": {"ssm": 1, "conv": 1}, mem: {}, "seg2": {"ssm": 1,
                                                          "conv": 1}}
    assert sum(p.numel() for p in m.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))


@pytest.mark.parametrize("dtype,s", [("float32", 16), ("float32", 6),
                                     ("bfloat16", 16)])
def test_forward_matches(dtype, s):
    """Logits of a (2, s) batch: 16 = 4 smoke chunks (the chunked scan),
    6 the sequential one."""
    j_cfg, params, state, cfg = pair(ARCH, dtype)
    m = model(cfg, params, state)
    toks = tokens(cfg, 2, s)
    with oracle(cfg):
        jl = j_tf.forward(params, state, {"tokens": jnp.asarray(toks)},
                          j_cfg)[0]
    with torch.no_grad():
        tl = transformer.forward(m, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == cfg.torch_dtype
    assert_close(cfg, tl.float(), f32(jl))


def test_loss_and_table_gradient_match():
    """A train-mode loss (no router: aux 0) and the memory table's
    gradient, float32."""
    j_cfg, params, state, cfg = pair(ARCH, "float32")
    m = model(cfg, params, state).train()
    toks, labels = tokens(cfg, 2, 8, 1), tokens(cfg, 2, 8, 2)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_tf.loss_fn(p, state, b, j_cfg, train=True),
        has_aux=True))(params, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})
    loss, met = transformer.loss_fn(m, {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(labels).long()}, train=True)
    loss.backward()
    assert met["aux"].item() == 0.0
    assert abs(loss.item() - float(j_loss)) <= TOL32 * abs(float(j_loss))
    seg = next(k for k in j_grads["segments"]
               if "memffn" in j_grads["segments"][k])
    jg = np.asarray(j_grads["segments"][seg]["memffn"]["lram"]["values"])
    tg = m.segments[seg].memffn.lram.values.grad.numpy()
    assert (tg != 0).any(axis=1).sum() > 0
    np.testing.assert_allclose(tg, jg, rtol=TOL32,
                               atol=TOL32 * np.abs(jg).max())
    jd = np.asarray(j_grads["segments"]["seg0"]["mamba"]["dt_bias"][0])
    np.testing.assert_allclose(m.segments["seg0"][0].mamba.dt_bias.grad,
                               jd, rtol=1e-4, atol=1e-4 * np.abs(jd).max())


def test_decode_matches_full_forward():
    """Token-by-token decode from an empty cache against each step of
    the JAX package's decode (1e-5) and against the causal forward,
    float32."""
    j_cfg, params, state, cfg = pair(ARCH, "float32")
    m = model(cfg, params, state)
    b, s = 2, 12
    toks = tokens(cfg, b, s, 3)
    with torch.no_grad():
        full = transformer.forward(m, {"tokens": torch.from_numpy(toks)})
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
                m, torch.from_numpy(toks[:, t:t + 1]).long(),
                torch.from_numpy(pos).long(), cache)
        assert_close(cfg, td, f32(jd))
        np.testing.assert_allclose(td[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split,dtype", [(2, "float32"), (8, "float32"),
                                         (16, "bfloat16")])
def test_prefill_then_decode(split, dtype):
    """prefill(split tokens) then decode 3 more against the JAX
    package's: the logits, the caches (the SSM state; the conv window,
    left-padded when 2 < K-1 = 3; 8 and 16 multiples of the smoke chunk:
    the chunked scan) and each decode step."""
    j_cfg, params, state, cfg = pair(ARCH, dtype)
    m = model(cfg, params, state)
    b, s = 2, split + 3
    toks = tokens(cfg, b, s, 4)
    with oracle(cfg):
        jl, jc = (j_tf.prefill if dtype == "bfloat16" else jax.jit(
            j_tf.prefill, static_argnums=(3, 4)))(
            params, state, {"tokens": jnp.asarray(toks[:, :split])}, j_cfg,
            s)
    with torch.no_grad():
        tl, tc = transformer.prefill(
            m, torch.from_numpy(toks[:, :split]).long(), s)
    assert_close(cfg, tl.float(), f32(jl))
    assert set(tc) == set(jc)
    for name in tc:
        assert set(tc[name]) == set(jc[name])
        for k in tc[name]:
            assert tc[name][k].shape == jc[name][k].shape
            assert tc[name][k].dtype == torch.float32
            np.testing.assert_allclose(
                tc[name][k].numpy(), f32(jc[name][k]),
                rtol=TOL32 if dtype == "float32" else 2.0**-8,
                atol=(TOL32 if dtype == "float32" else 2.0**-8)
                * max(1.0, np.abs(f32(jc[name][k])).max()))
    if split == 2:  # the window holds 2 inputs after a zero row
        assert not tc["seg0"]["conv"][:, :, 0].any()
    j_step = (j_tf.decode_step if dtype == "bfloat16" else jax.jit(
        j_tf.decode_step, static_argnums=5))
    for t in range(split, s):
        pos = np.full((b,), t, np.int32)
        with oracle(cfg):
            jd, jc = j_step(params, state, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(pos), jc, j_cfg)
        with torch.no_grad():
            td = transformer.decode_step(
                m, torch.from_numpy(toks[:, t:t + 1]).long(),
                torch.from_numpy(pos).long(), tc)
        assert_close(cfg, td.float(), f32(jd))


# ---------------------------------------------------------------------------
# the serve engine, checkpoints, CLIs
# ---------------------------------------------------------------------------

def test_engine_prefills_at_exact_length():
    _, _, _, cfg = pair(ARCH, "float32")
    engine = ServeEngine(transformer.init(cfg), EngineConfig(max_len=40))
    assert [engine.prefill_len(n) for n in (1, 3, 9, 17)] == [1, 3, 9, 17]


def test_engine_serves_like_reference():
    """ServeEngine against the JAX engine on one mixed trace, both
    prefilling at exact lengths, float32: greedy tokens equal and every
    request's first logits to 1e-5."""
    j_cfg, params, state, cfg = pair(ARCH, "float32")
    kw = dict(vocab_size=cfg.vocab_size, max_prompt=8, max_gen=5)
    engine = ServeEngine(model(cfg, params, state),
                         EngineConfig(slots=2, max_len=14))
    trace = synthetic_trace(np.random.default_rng(5), 4, **kw)
    engine.warmup([r.prompt_len for r in trace])
    rep = engine.run(trace)
    j_rep = JServeEngine(params, state, j_cfg, JEngineConfig(
        slots=2, max_len=14)).run(
            j_synthetic_trace(np.random.default_rng(5), 4, **kw))
    assert [r.id for r in rep.requests] == [r.id for r in j_rep.requests]
    for a, b in zip(rep.requests, j_rep.requests):
        assert_close(cfg, a.first_logits, b.first_logits)
        assert a.tokens == b.tokens
    assert rep.generated_tokens == j_rep.generated_tokens


def test_engine_first_logits_bfloat16():
    """ServeEngine in bfloat16: each request's first logits (its batch-1
    prefill at the prompt's exact length) against the JAX package's
    forward of the same prompts run op by op, to `bf16_tol`.  Four
    prompts of 16 tokens, two to a forward."""
    j_cfg, params, state, cfg = pair(ARCH, "bfloat16")
    engine = ServeEngine(model(cfg, params, state),
                         EngineConfig(slots=2, max_len=20))
    trace = synthetic_trace(np.random.default_rng(6), 4,
                            vocab_size=cfg.vocab_size, max_prompt=16,
                            max_gen=3, mixed=False)
    rep = engine.run(trace)
    assert len(rep.requests) == 4
    for i in (0, 2):
        toks = np.stack([r.prompt for r in trace[i:i + 2]]).astype(np.int32)
        with oracle(cfg):
            jl = f32(j_tf.forward(params, state,
                                  {"tokens": jnp.asarray(toks)}, j_cfg)[0])
        first = np.stack([d.first_logits for d in rep.requests[i:i + 2]])
        assert_close(cfg, first, jl[:, -1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoints_cross_both_ways(dtype, tmp_path):
    """The JAX package's checkpoint of the SSM model restores into the
    port bit for bit, and the port writes the same files (the float32
    A_log / D / dt_bias of a bfloat16 model stay float32, the memory
    layer's unused attention leaves cross too)."""
    _, params, state, cfg = pair(ARCH, dtype)
    m = model(cfg, params, state)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JCheckpointManager(j_dir).save(2, {"params": params,
                                       "model_state": state})
    CheckpointManager(t_dir).save(2, convert.reference_tree(m))
    step_dir = "step_000000000002"
    manifests = [json.load(open(os.path.join(d, step_dir, "manifest.json")))
                 for d in (j_dir, t_dir)]
    leaves = manifests[0]["leaves"]
    assert leaves == manifests[1]["leaves"]
    assert leaves["params/segments/seg0/mamba/A_log"]["dtype"] == "float32"
    assert leaves["params/segments/seg0/mamba/conv"]["dtype"] == dtype
    assert "params/segments/seg1/attn/wq/kernel" in leaves
    for meta in leaves.values():
        a, b = (open(os.path.join(d, step_dir, meta["file"]), "rb").read()
                for d in (j_dir, t_dir))
        assert a == b, meta["file"]
    for d in (j_dir, t_dir):
        fresh = transformer.init(cfg, seed=7)
        step, tree = CheckpointManager(d).restore(
            convert.reference_tree(fresh, like=True))
        assert step == 2
        convert.load_reference_tree(fresh, tree)
        for (k, a), (_, b) in zip(m.state_dict().items(),
                                  fresh.state_dict().items()):
            assert a.dtype == b.dtype and torch.equal(a, b), k


def test_serve_cli_smoke_arch_on_cpu(capsys):
    """`serve --arch mamba2-1.3b --smoke --device cpu --json --warmup`."""
    rep = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "9", "--gen", "3",
                      "--warmup", "--json"])
    assert len(rep.requests) == 4
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["arch"] == "mamba2-1.3b-smoke" and doc["cache"] is None


def test_train_cli_trains_the_smoke_ssm():
    run = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "8"])
    assert len(run.records) == 2
    assert all(np.isfinite(r["loss"]) for r in run.records)
