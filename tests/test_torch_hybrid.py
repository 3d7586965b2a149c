"""The hybrid family in the port (zamba2-2.7b: units of Mamba-2 layers,
each unit followed by ONE shared attention + MLP block), held against the
JAX package on weights converted by `launch/convert.py`: the configs and
the segment plan, the refusal of a memory layer inside hybrid units (the
reference's rule: `with_lram(zamba2)` fails at init in both), the module
tree (the shared block one module, its leaves once), forward logits,
`loss_fn` with the gradient of every leaf (the shared block's summed over
its calls), prefill then decode with the two-axis Mamba caches beside the
shared block's K/V, decode against the full forward, the converter's two
stacked axes both ways, checkpoints both ways, the serve engine against
the JAX engine, and the CLIs.  No memory layer: no kernel of the port
runs on this path.

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

from _families import (TOL32, assert_close, assert_grads_match, f32, model,
                       oracle, pair, reference_logits, tokens)
from repro import configs as j_configs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core.pkm import PKMConfig as JPKMConfig
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.pkm import PKMConfig
from repro_torch.launch import convert, serve, train
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

ARCH = "zamba2-2.7b"
DTYPES = ("float32", "bfloat16")


def _pair(dtype):
    return pair(ARCH, dtype, lram=False)


def test_configs_match_reference():
    """Full (bfloat16) and smoke (float32) configs field for field, their
    parameter counts and segment plans."""
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(configs, get)(ARCH), getattr(j_configs, get)(ARCH)
        for f in dataclasses.fields(j):
            if f.name not in ("lram", "pkm"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
        assert transformer.layer_plan(t) == j_tf.layer_plan(j)
    cfg = configs.get_config(ARCH)
    assert (cfg.dtype, cfg.family, cfg.hybrid_pattern) == ("bfloat16",
                                                           "hybrid", 6)
    assert transformer.layer_plan(cfg) == [("hybrid", 9)]
    assert configs.get_smoke_config(ARCH).dtype == "float32"


@pytest.mark.parametrize("kind", ["lram", "pkm"])
def test_memory_layers_in_hybrid_units_raise_as_reference(kind):
    """The reference's rule: no memory layer inside hybrid units.
    `with_lram(zamba2)` builds a config in both packages, and both fail
    when the model is built (the reference's assert, the port's
    ValueError naming the rule)."""
    t, j = (configs.get_smoke_config(ARCH), j_configs.get_smoke_config(ARCH))
    if kind == "lram":
        t, j = configs.with_lram(t, 16), j_configs.with_lram(j, 16)
    else:
        t = dataclasses.replace(t, pkm_layers=(1,), pkm=PKMConfig())
        j = dataclasses.replace(j, pkm_layers=(1,), pkm=JPKMConfig())
    with pytest.raises(AssertionError, match="hybrid units"):
        j_tf.init(jax.random.PRNGKey(0), j)
    with pytest.raises(ValueError, match="memory layers inside hybrid units"):
        transformer.init(t)


def test_module_tree_is_the_reference_tree():
    """Every leaf of the converted model has the reference's path, shape
    and dtype: the Mamba leaves split over (unit, layer), the shared
    block once (one module, called after every unit), the parameter
    counts equal; the caches the reference's shapes and batch axes."""
    j_cfg, params, state, cfg = _pair("bfloat16")
    flat = convert.state_dict_from_jax(jax.tree.map(np.asarray, params),
                                       jax.tree.map(np.asarray, state), cfg)
    m = transformer.init(cfg)
    sd = m.state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k
    units = cfg.num_layers // cfg.hybrid_pattern
    assert len(m.segments["seg0"]) == units
    assert all(len(u) == cfg.hybrid_pattern for u in m.segments["seg0"])
    assert "segments.seg0.1.1.mamba.A_log" in sd
    assert sd["segments.seg0.1.1.mamba.A_log"].dtype == torch.float32
    assert "shared_attn.attn.wq.kernel" in sd and "shared_attn.mlp.wi.kernel" \
        in sd
    assert sum(p.numel() for p in m.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))
    shapes = transformer.cache_shapes(cfg, 3, 10)
    j_shapes = j_tf.cache_shapes(j_cfg, 3, 10)
    assert {k: {n: (s, str(d).split(".")[-1]) for n, (s, d) in v.items()}
            for k, v in shapes.items()} == {
        k: {n: (s, np.dtype(d).name) for n, (s, d) in v.items()}
        for k, v in j_shapes.items()}
    assert transformer.cache_batch_axes(cfg, 10) == \
        j_tf.cache_batch_axes(j_cfg, 10) == {
            "seg0": {"ssm": 2, "conv": 2, "k": 1, "v": 1}}


@pytest.mark.parametrize("dtype,s", [("float32", 16), ("float32", 6),
                                     ("bfloat16", 16)])
def test_forward_matches(dtype, s):
    """Logits of a (2, s) batch: 16 = 4 smoke chunks (the chunked scan),
    6 the sequential one."""
    j_cfg, params, state, cfg = _pair(dtype)
    m = model(cfg, params, state)
    toks = tokens(cfg, 2, s)
    jl = reference_logits(j_cfg, params, state, {"tokens": toks})
    with torch.no_grad():
        tl = transformer.forward(m, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == cfg.torch_dtype
    assert_close(cfg, tl.float(), jl)


def test_loss_and_every_gradient_match():
    """A train-mode loss and the gradient of every leaf against
    `jax.grad`, float32: the shared block's is summed over its calls
    (one per unit), as the reference's closure over the scan sums it."""
    j_cfg, params, state, cfg = _pair("float32")
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
    assert_grads_match(m, j_grads, cfg)
    assert m.shared_attn.attn.wq.kernel.grad.abs().sum() > 0


def test_decode_matches_full_forward():
    """Token-by-token decode from an empty cache against each step of
    the JAX package's decode (1e-5) and against the causal forward,
    float32."""
    j_cfg, params, state, cfg = _pair("float32")
    m = model(cfg, params, state)
    b, s = 2, 10
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
    package's: the logits, every cache leaf (each unit's Mamba state and
    conv window, (units, pattern, ...) float32; the shared block's K/V,
    (units, ...)) and each decode step."""
    j_cfg, params, state, cfg = _pair(dtype)
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
    assert set(tc) == set(jc) == {"seg0"}
    assert set(tc["seg0"]) == set(jc["seg0"]) == {"ssm", "conv", "k", "v"}
    tol = TOL32 if dtype == "float32" else 2.0**-8
    for k, leaf in tc["seg0"].items():
        assert leaf.shape == jc["seg0"][k].shape
        want = f32(jc["seg0"][k])
        np.testing.assert_allclose(leaf.float().numpy(), want, rtol=tol,
                                   atol=tol * max(1.0, np.abs(want).max()))
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
# the converter, checkpoints, the serve engine, CLIs
# ---------------------------------------------------------------------------

def test_reference_tree_stacks_both_axes():
    """`reference_tree` gives the reference's params back leaf for leaf
    (the Mamba leaves stacked (units, pattern, ...), the shared block
    and the rest as they are), `reference_path` names (unit, layer), and
    `like=True` the stacked shapes."""
    _, params, state, cfg = _pair("float32")
    m = model(cfg, params, state)
    tree = convert.reference_tree(m)
    like = convert.reference_tree(m, like=True)
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(tree["params"])[0])
    assert set(map(str, got)) == set(map(str, want))
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree["params"])[0]:
        ref = np.asarray(want[path])
        np.testing.assert_array_equal(leaf.numpy(), ref)
        node = like["params"]
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == ref.shape
    assert convert.reference_path("segments.seg0.1.0.mamba.conv", cfg) == (
        "params/segments/seg0/mamba/conv", (1, 0))
    assert convert.reference_path("shared_attn.mlp.wo.kernel", cfg) == (
        "params/shared_attn/mlp/wo/kernel", None)


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoints_cross_both_ways(dtype, tmp_path):
    """The JAX package's checkpoint of the hybrid model restores into the
    port bit for bit, and the port writes the same files (two stacked
    axes, the shared block, the float32 A_log / D / dt_bias of a
    bfloat16 model)."""
    _, params, state, cfg = _pair(dtype)
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
    assert "params/shared_attn/attn/wq/kernel" in leaves
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


def test_engine_prefills_at_exact_length():
    _, _, _, cfg = _pair("float32")
    engine = ServeEngine(transformer.init(cfg), EngineConfig(max_len=40))
    assert [engine.prefill_len(n) for n in (1, 3, 9, 17)] == [1, 3, 9, 17]


def test_engine_serves_like_reference():
    """ServeEngine against the JAX engine on one mixed trace, both
    prefilling at exact lengths, float32: greedy tokens equal and every
    request's first logits to 1e-5."""
    j_cfg, params, state, cfg = _pair("float32")
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
    """ServeEngine in bfloat16: each request's first logits against the
    JAX package's forward of the same prompts run op by op, to
    `bf16_tol` (the forward test's shape: two prompts of 16 tokens)."""
    j_cfg, params, state, cfg = _pair("bfloat16")
    engine = ServeEngine(model(cfg, params, state),
                         EngineConfig(slots=2, max_len=20))
    trace = synthetic_trace(np.random.default_rng(6), 2,
                            vocab_size=cfg.vocab_size, max_prompt=16,
                            max_gen=3, mixed=False)
    rep = engine.run(trace)
    toks = np.stack([r.prompt for r in trace]).astype(np.int32)
    jl = reference_logits(j_cfg, params, state, {"tokens": toks})
    first = np.stack([d.first_logits for d in rep.requests])
    assert_close(cfg, first, jl[:, -1])


def test_serve_cli_smoke_arch_on_cpu(capsys):
    """`serve --arch zamba2-2.7b --smoke --device cpu --json --warmup`."""
    rep = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "9", "--gen", "3",
                      "--warmup", "--json"])
    assert len(rep.requests) == 4
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["arch"] == "zamba2-2.7b-smoke" and doc["cache"] is None


def test_train_cli_trains_the_smoke_hybrid():
    run = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "8"])
    assert len(run.records) == 2
    assert all(np.isfinite(r["loss"]) for r in run.records)
