"""The VLM family in the port (qwen2-vl-72b: `vision_embeds` replace the
first `vision_tokens` embeddings; M-RoPE turns the rotation's frequency
bands by the t / h / w position streams), with and without the paper's
memory FFN (`with_lram`), held against the JAX package on weights
converted by `launch/convert.py`: the configs, M-RoPE itself, forward
logits, `loss_fn` with the gradient of every leaf, prefill then decode,
and the serve engine's refusal (as the reference's).

M-RoPE equals RoPE wherever the three streams are equal, so every test
of the model feeds vision embeddings on a frame of 2 x 2 patches (t 0, h
and w the patch's row and column) with the text continuing from the
grid's largest position (`_families.grid_positions`): a wrong band split
would show.  Tolerances (`tests/_families.py`): float32 to 1e-5 against
the compiled JAX package; bfloat16 to `bf16_tol` (2^-8 x (layers + 1) x
the largest reference logit) against the JAX package run op by op."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (TOL32, assert_close, assert_grads_match, batch,
                       extras, f32, grid_positions, j_batch, model, oracle,
                       pair, prefix, reference_logits, t_batch)
from repro import configs as j_configs
from repro.models import attention as j_attention
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.launch import convert, serve
from repro_torch.models import attention, transformer
from repro_torch.serving import EngineConfig, ServeEngine

ARCH = "qwen2-vl-72b"
LRAM = (True, False)


def test_configs_match_reference():
    """Full (bfloat16) and smoke (float32) configs field for field (the
    sections (16, 24, 24) of head_dim 128's 64 bands, qkv bias, theta
    1e6), the parameter counts and segment plans with the memory FFN."""
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(configs, get)(ARCH), getattr(j_configs, get)(ARCH)
        for f in dataclasses.fields(j):
            if f.name not in ("lram", "pkm"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
        assert sum(t.mrope_sections) == t.head_dim // 2
        t, j = configs.with_lram(t), j_configs.with_lram(j)
        assert transformer.layer_plan(t) == j_tf.layer_plan(j)
    cfg = configs.get_config(ARCH)
    assert (cfg.dtype, cfg.family, cfg.pos_scheme, cfg.mrope_sections,
            cfg.qkv_bias, cfg.rope_theta) == ("bfloat16", "vlm", "mrope",
                                              (16, 24, 24), True, 1e6)


def _rotation_inputs(b=2, s=12, h=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, h, d)).astype(np.float32)


@pytest.mark.parametrize("sections,d", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_matches_reference(sections, d):
    """`apply_mrope` against the reference's on the grid's positions (not
    the sequence index on any stream), float32 to 1e-5; a split of the
    bands other than `sections` gives other values."""
    x = _rotation_inputs(d=d)
    pos = grid_positions(3, 2, 12)
    want = j_attention.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                   sections)
    got = attention.apply_mrope(torch.from_numpy(x),
                                torch.from_numpy(pos).long(), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), f32(want), rtol=TOL32,
                               atol=TOL32)
    other = tuple(reversed(sections))
    if other != sections:
        wrong = attention.apply_mrope(torch.from_numpy(x),
                                      torch.from_numpy(pos).long(), 1e6,
                                      other)
        assert np.abs(wrong.numpy() - f32(want)).max() > 1e-2
    with pytest.raises(ValueError, match="sum to"):
        attention.apply_mrope(torch.from_numpy(x),
                              torch.from_numpy(pos).long(), 1e6, (1, 1, 1))


def test_mrope_equals_rope_for_uniform_positions():
    """Equal streams: M-RoPE is RoPE (the reference's own identity),
    bit for bit here (the same angles, selected exactly)."""
    x = torch.from_numpy(_rotation_inputs())
    pos = torch.arange(12).expand(2, 12)
    torch.testing.assert_close(
        attention.apply_mrope(x, pos.expand(3, 2, 12), 1e4, (2, 3, 3)),
        attention.apply_rope(x, pos, 1e4), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,lram", [("float32", True),
                                        ("float32", False),
                                        ("bfloat16", True)])
def test_forward_matches(dtype, lram):
    """Logits of a (2, 10) batch whose first 4 embeddings are vision
    embeddings on a 2 x 2 frame, at the grid's M-RoPE positions."""
    j_cfg, params, state, cfg = pair(ARCH, dtype, lram)
    m = model(cfg, params, state)
    b = batch(cfg, 2, 10)
    jl = reference_logits(j_cfg, params, state, b)
    with torch.no_grad():
        tl = transformer.forward(m, t_batch(b))
    assert tl.dtype == cfg.torch_dtype
    assert_close(cfg, tl.float(), jl)


def test_forward_defaults_match():
    """Without vision embeddings or positions: the tokens' embeddings and
    the sequence index on every stream, as the reference's defaults."""
    j_cfg, params, state, cfg = pair(ARCH, "float32", True)
    m = model(cfg, params, state)
    toks = batch(cfg, 2, 10, 3)["tokens"]
    jl = reference_logits(j_cfg, params, state, {"tokens": toks})
    with torch.no_grad():
        tl = transformer.forward(m, {"tokens": torch.from_numpy(toks)})
    assert_close(cfg, tl, jl)


@pytest.mark.parametrize("lram", LRAM)
def test_loss_and_every_gradient_match(lram):
    """A train-mode loss and the gradient of every leaf against
    `jax.grad` on the vision batch, float32 (the qkv biases' among
    them)."""
    j_cfg, params, state, cfg = pair(ARCH, "float32", lram)
    m = model(cfg, params, state).train()
    b = batch(cfg, 2, 10, 1)
    b["labels"] = batch(cfg, 2, 10, 2)["tokens"]
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, x: j_tf.loss_fn(p, state, x, j_cfg, train=True),
        has_aux=True))(params, j_batch(b))
    loss, _ = transformer.loss_fn(m, t_batch(b), train=True)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= TOL32 * abs(float(j_loss))
    assert_grads_match(m, j_grads, cfg)
    assert m.segments["seg0"][0].attn.wq.bias.grad.abs().sum() > 0


@pytest.mark.parametrize("split,dtype,lram", [(6, "float32", True),
                                              (7, "float32", False),
                                              (10, "bfloat16", True)])
def test_prefill_then_decode(split, dtype, lram):
    """prefill(split tokens: the vision frame, text at the grid's
    positions) then decode 3 more at the cache slots (the reference's
    decode turns every stream by the slot index) against the JAX
    package's: the logits, the K/V caches and each decode step."""
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
    tol = TOL32 if dtype == "float32" else 2.0**-8
    for name in tc:
        assert set(tc[name]) == set(jc[name]) == {"k", "v"}
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


def test_converter_round_trip():
    """`reference_tree` gives the reference's params back leaf for leaf,
    the qkv biases among them."""
    _, params, state, cfg = pair(ARCH, "float32", True)
    tree = convert.reference_tree(model(cfg, params, state))
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    assert {str(p) for p, _ in got} == set(map(str, want))
    for path, leaf in got:
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]))
    assert "wq" in tree["params"]["segments"]["seg0"]["attn"]
    assert "bias" in tree["params"]["segments"]["seg0"]["attn"]["wq"]


def test_engine_and_serve_cli_refuse_as_reference():
    j_cfg, params, state, cfg = pair(ARCH, "float32", False)
    with pytest.raises(ValueError, match="decoder-only families"):
        JServeEngine(params, state, j_cfg, JEngineConfig())
    with pytest.raises(ValueError, match="decoder-only families"):
        ServeEngine(model(cfg, params, state), EngineConfig())
    with pytest.raises(ValueError, match="qwen2-vl-72b-smoke is vlm"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
