"""The enc-dec family in the port (whisper-small: a non-causal encoder
over precomputed frame embeddings, a decoder whose run layers attend
over the encoder's output through their own cross keys and values), with
and without the paper's memory FFN (`with_lram`, which has no cross
attention, as the reference's), held against the JAX package on weights
converted by `launch/convert.py`: the configs, plan and cache layout,
the cross attention, forward logits, `loss_fn` with the gradient of every
leaf, prefill (ck / cv cached) then decode, the converter's stacked
encoder both ways, checkpoints both ways, and the refusals (the serve
engine and the serve CLI refuse enc-dec archs, as the reference's do).

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

from _families import (TOL32, assert_close, assert_grads_match, batch,
                       extras, f32, j_batch, model, oracle, pair, prefix,
                       reference_logits, t_batch)
from repro import configs as j_configs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.launch import serve as j_serve
from repro.models import attention as j_attention
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import convert, serve, train
from repro_torch.models import attention, transformer
from repro_torch.serving import EngineConfig, ServeEngine

ARCH = "whisper-small"
LRAM = (True, False)


def test_configs_match_reference():
    """Full (bfloat16) and smoke (float32) configs field for field, the
    parameter counts and segment plans, with and without the memory
    FFN (at decoder layer 6 of 12, 48 heads, in the full config)."""
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(configs, get)(ARCH), getattr(j_configs, get)(ARCH)
        for f in dataclasses.fields(j):
            if f.name not in ("lram", "pkm"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
        t, j = configs.with_lram(t), j_configs.with_lram(j)
        assert transformer.layer_plan(t) == j_tf.layer_plan(j)
        assert t.lram.heads == j.lram.heads == t.d_model // 16
    cfg = configs.with_lram(configs.get_config(ARCH))
    assert (cfg.dtype, cfg.family, cfg.lram_layers, cfg.lram.heads) == (
        "bfloat16", "encdec", (6,), 48)
    assert transformer.layer_plan(cfg) == [("run", 6), ("memory", 6, "lram"),
                                           ("run", 5)]


@pytest.mark.parametrize("lram", LRAM)
def test_module_tree_and_caches_are_the_reference(lram):
    """Every leaf of the converted model has the reference's path, shape
    and dtype (the encoder's split per layer; the memory layer without
    cross attention); the cache leaves and their batch axes the
    reference's: k, v, ck, cv for a run, k, v for the memory layer."""
    j_cfg, params, state, cfg = pair(ARCH, "bfloat16", lram)
    flat = convert.state_dict_from_jax(jax.tree.map(np.asarray, params),
                                       jax.tree.map(np.asarray, state), cfg)
    m = transformer.init(cfg)
    sd = m.state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k
    assert len(m.encoder) == cfg.encoder_layers
    assert sd["enc_pos_embed"].shape == (cfg.encoder_len, cfg.d_model)
    assert "segments.seg0.0.cross.wk.kernel" in sd
    if lram:
        assert not any(k.startswith("segments.seg1.cross") for k in sd)
    shapes = transformer.cache_shapes(cfg, 3, 10)
    j_shapes = j_tf.cache_shapes(j_cfg, 3, 10)
    assert {k: {n: s for n, (s, _) in v.items()} for k, v in shapes.items()} \
        == {k: {n: s for n, (s, _) in v.items()} for k, v in j_shapes.items()}
    run = transformer.layer_plan(cfg)[0][1]
    assert shapes["seg0"]["ck"][0] == (run, 3, cfg.encoder_len,
                                       cfg.num_kv_heads, cfg.head_dim)
    assert transformer.cache_batch_axes(cfg, 10) == \
        j_tf.cache_batch_axes(j_cfg, 10)


def test_cross_attention_matches():
    """The cross attention alone: the encoder output's projections
    (`project_kv`) as keys and values, non-causal, against the
    reference's `attn_apply(cross_kv=...)`, float32."""
    j_cfg = j_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    params = j_attention.attn_init(jax.random.PRNGKey(3), j_cfg)
    attn = attention.Attention(cfg)
    attn.load_state_dict({k: convert.tensor_from_numpy(v) for k, v in
                          convert._flatten(jax.tree.map(
                              np.asarray, params)).items()})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)
    ek = (jnp.asarray(enc) @ params["wk"]["kernel"]).reshape(
        2, -1, cfg.num_kv_heads, cfg.head_dim)
    ev = (jnp.asarray(enc) @ params["wv"]["kernel"]).reshape(
        2, -1, cfg.num_kv_heads, cfg.head_dim)
    pos = np.tile(np.arange(5), (2, 1))
    want, _ = j_attention.attn_apply(params, jnp.asarray(x), j_cfg,
                                     positions=jnp.asarray(pos),
                                     causal=False, cross_kv=(ek, ev))
    with torch.no_grad():
        ckv = attention.project_kv(attn, torch.from_numpy(enc))
        got, _ = attention.attn_apply(attn, torch.from_numpy(x),
                                      positions=torch.from_numpy(pos),
                                      causal=False, cross_kv=ckv)
    np.testing.assert_allclose(got.numpy(), f32(want), rtol=TOL32,
                               atol=TOL32)


@pytest.mark.parametrize("dtype,lram", [("float32", True),
                                        ("float32", False),
                                        ("bfloat16", True)])
def test_forward_matches(dtype, lram):
    """Logits of a (2, 8) batch over the smoke encoder's 12 frames."""
    j_cfg, params, state, cfg = pair(ARCH, dtype, lram)
    m = model(cfg, params, state)
    b = batch(cfg, 2, 8)
    jl = reference_logits(j_cfg, params, state, b)
    with torch.no_grad():
        tl = transformer.forward(m, t_batch(b))
    assert tl.dtype == cfg.torch_dtype
    assert_close(cfg, tl.float(), jl)


@pytest.mark.parametrize("lram", LRAM)
def test_loss_and_every_gradient_match(lram):
    """A train-mode loss and the gradient of every leaf against
    `jax.grad`, float32: the encoder's through every decoder layer's
    cross projections, the memory table's through the lookup."""
    j_cfg, params, state, cfg = pair(ARCH, "float32", lram)
    m = model(cfg, params, state).train()
    b = batch(cfg, 2, 8, 1)
    b["labels"] = batch(cfg, 2, 8, 2)["tokens"]
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, x: j_tf.loss_fn(p, state, x, j_cfg, train=True),
        has_aux=True))(params, j_batch(b))
    loss, _ = transformer.loss_fn(m, t_batch(b), train=True)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= TOL32 * abs(float(j_loss))
    assert_grads_match(m, j_grads, cfg)
    assert m.encoder[0].attn.wq.kernel.grad.abs().sum() > 0


def test_forward_needs_encoder_embeds():
    _, params, state, cfg = pair(ARCH, "float32", False)
    with pytest.raises(ValueError, match="encoder_embeds"):
        transformer.forward(model(cfg, params, state),
                            {"tokens": torch.zeros((1, 4), dtype=torch.long)})


@pytest.mark.parametrize("split,dtype,lram", [(3, "float32", True),
                                              (8, "float32", False),
                                              (8, "bfloat16", True)])
def test_prefill_then_decode(split, dtype, lram):
    """prefill(split tokens, the encoder frames) then decode 3 more
    against the JAX package's: the logits, every cache leaf (k, v; a
    run's ck / cv, the encoder's projections) and each decode step (the
    cross attention over every frame)."""
    j_cfg, params, state, cfg = pair(ARCH, dtype, lram)
    m = model(cfg, params, state)
    b, s = 2, split + 3
    full = batch(cfg, b, s, 4)
    pre = prefix(full, split)
    with oracle(cfg):
        jl, jc = (j_tf.prefill if dtype == "bfloat16" else jax.jit(
            j_tf.prefill, static_argnums=(3, 4)))(
            params, state, j_batch(pre), j_cfg, s)
    tb = t_batch(pre)
    with torch.no_grad():
        tl, tc = transformer.prefill(m, tb["tokens"], s, **extras(tb))
    assert_close(cfg, tl.float(), f32(jl))
    assert {k: set(v) for k, v in tc.items()} == {
        k: set(v) for k, v in jc.items()}
    assert set(tc["seg0"]) == {"k", "v", "ck", "cv"}
    tol = TOL32 if dtype == "float32" else 2.0**-8
    for name in tc:
        for k, leaf in tc[name].items():
            want = f32(jc[name][k])
            np.testing.assert_allclose(
                leaf.float().numpy(), want, rtol=tol,
                atol=tol * max(1.0, np.abs(want).max()))
    j_step = (j_tf.decode_step if dtype == "bfloat16" else jax.jit(
        j_tf.decode_step, static_argnums=5))
    toks = full["tokens"]
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


def test_decode_matches_full_forward():
    """Decode from the prompt's cache against the full forward over the
    same tokens and frames, float32 with the memory FFN."""
    _, params, state, cfg = pair(ARCH, "float32", True)
    m = model(cfg, params, state)
    b, split, s = 2, 4, 9
    full = t_batch(batch(cfg, b, s, 5))
    with torch.no_grad():
        want = transformer.forward(m, full)
        _, cache = transformer.prefill(m, full["tokens"][:, :split], s,
                                       **extras(full))
        for t in range(split, s):
            got = transformer.decode_step(
                m, full["tokens"][:, t:t + 1],
                torch.full((b,), t, dtype=torch.long), cache)
            np.testing.assert_allclose(got[:, 0].numpy(),
                                       want[:, t].numpy(), rtol=1e-4,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# the converter, checkpoints, refusals
# ---------------------------------------------------------------------------

def test_reference_tree_stacks_the_encoder():
    """`reference_tree` gives the reference's params back leaf for leaf
    (the encoder stacked over its layers, `enc_pos_embed`, `enc_norm`);
    `reference_path` names an encoder layer's index."""
    _, params, state, cfg = pair(ARCH, "float32", True)
    m = model(cfg, params, state)
    tree = convert.reference_tree(m)
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    assert {str(p) for p, _ in got} == set(map(str, want))
    for path, leaf in got:
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]))
    assert convert.reference_path("encoder.1.mlp.wo.kernel", cfg) == (
        "params/encoder/mlp/wo/kernel", 1)
    assert convert.reference_path("enc_norm.scale", cfg) == (
        "params/enc_norm/scale", None)


def test_checkpoints_cross_both_ways(tmp_path):
    """The JAX package's checkpoint (the encoder, the cross layers, the
    memory table and its batchnorm state) restores into the port bit for
    bit, and the port writes the same files, float32."""
    _, params, state, cfg = pair(ARCH, "float32", True)
    m = model(cfg, params, state)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JCheckpointManager(j_dir).save(3, {"params": params,
                                       "model_state": state})
    CheckpointManager(t_dir).save(3, convert.reference_tree(m))
    step_dir = "step_000000000003"
    manifests = [json.load(open(os.path.join(d, step_dir, "manifest.json")))
                 for d in (j_dir, t_dir)]
    leaves = manifests[0]["leaves"]
    assert leaves == manifests[1]["leaves"]
    assert leaves["params/encoder/attn/wq/kernel"]["shape"][0] == \
        cfg.encoder_layers
    for meta in leaves.values():
        a, b = (open(os.path.join(d, step_dir, meta["file"]), "rb").read()
                for d in (j_dir, t_dir))
        assert a == b, meta["file"]
    fresh = transformer.init(cfg, seed=7)
    step, tree = CheckpointManager(j_dir).restore(
        convert.reference_tree(fresh, like=True))
    assert step == 3
    convert.load_reference_tree(fresh, tree)
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), k


def test_engine_and_serve_cli_refuse_as_reference():
    """Continuous batching serves decoder-only families: the JAX engine
    and the port's raise the same ValueError for whisper-small, and both
    serve CLIs with it."""
    j_cfg, params, state, cfg = pair(ARCH, "float32", False)
    with pytest.raises(ValueError, match="decoder-only families"):
        JServeEngine(params, state, j_cfg, JEngineConfig())
    with pytest.raises(ValueError, match="decoder-only families"):
        ServeEngine(model(cfg, params, state), EngineConfig())
    argv = ["--arch", ARCH, "--smoke"]
    with pytest.raises(ValueError, match="decoder-only families"):
        j_serve.main(argv)
    with pytest.raises(ValueError, match="decoder-only families"):
        serve.main(argv + ["--device", "cpu"])


def test_train_cli_needs_the_frames():
    """The train CLI feeds no encoder frames (the reference's neither):
    whisper-small's forward raises naming them."""
    with pytest.raises(ValueError, match="encoder_embeds"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "1", "--batch", "2", "--seq", "8"])
