"""Attention in the port against the JAX package's: the sliding-window
band mask, the chunked (streaming-softmax) path against the dense one and
against the reference's `chunked_attention`, the ring fill of a prefill
against the reference's `_fill_kv_cache`, and the ring-buffer decode
against the reference's `attn_decode` past the window.  Float32 to 1e-5;
bfloat16 to 2^-8 of the output's scale (one rounding of the result)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro_torch import configs
from repro_torch.models import attention, transformer

TOL = 1e-5


def _qkv(b, s, t, h, kh, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(dtype),
            rng.normal(size=(b, t, kh, d)).astype(dtype),
            rng.normal(size=(b, t, kh, d)).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 8, 5])
def test_chunked_matches_dense(window, causal):
    """At attn_chunk 8 over 32 positions (4 x 4 blocks, some masked
    whole) the streaming softmax equals the dense path's."""
    q, k, v = _t(*_qkv(2, 32, 32, 4, 2, 16, seed=1))
    dense = attention.dense_attention(q, k, v, causal=causal, window=window)
    chunked = attention.chunked_attention(q, k, v, causal=causal,
                                          window=window, q_chunk=8,
                                          kv_chunk=8)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_chunked_matches_reference(window):
    q, k, v = _qkv(2, 32, 32, 4, 2, 16, seed=2)
    want = j_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window, q_chunk=8, kv_chunk=8)
    got = attention.chunked_attention(*_t(q, k, v), causal=True,
                                      window=window, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("q_offset", [0, 6])
@pytest.mark.parametrize("window", [None, 4])
def test_dense_band_mask_matches_reference(window, q_offset):
    q, k, v = _qkv(1, 10, 16, 4, 4, 8, seed=3)
    want = j_attn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  window=window, q_offset=q_offset)
    got = attention.dense_attention(*_t(q, k, v), causal=True,
                                    window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    mask = attention._band_mask(10, 16, causal=True, window=window,
                                q_offset=q_offset)
    np.testing.assert_array_equal(mask.numpy(), j_attn._band_mask(
        10, 16, causal=True, window=window, q_offset=q_offset))


def test_bfloat16_chunked_matches_reference():
    """bfloat16 inputs: the scores and softmax run in float32 in both
    packages; the output rounds once to bfloat16."""
    q, k, v = _qkv(1, 16, 16, 4, 2, 16, seed=4)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(j_attn.chunked_attention(
        *jb, causal=True, window=8, q_chunk=8, kv_chunk=8)).astype(
            np.float32)
    tb = [x.to(torch.bfloat16) for x in _t(q, k, v)]
    got = attention.chunked_attention(*tb, causal=True, window=8,
                                      q_chunk=8, kv_chunk=8)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= \
        2.0**-8 * np.abs(want).max()


@pytest.mark.parametrize("s", [5, 8, 13, 20])
def test_ring_fill_matches_reference(s):
    """A prefill of s positions into a ring of 8 slots (danube's smoke
    window): the last 8 positions, each in slot p % 8, padded when
    shorter, as the reference's `_fill_kv_cache`."""
    cfg = configs.get_smoke_config("h2o-danube-3-4b")
    j_cfg = j_configs.get_smoke_config("h2o-danube-3-4b")
    t_cache = transformer._attn_cache_len(cfg, 32)
    assert t_cache == cfg.window == 8
    k = np.random.default_rng(s).normal(size=(2, s, 2, 4)).astype(
        np.float32)
    jk, _ = j_tf._fill_kv_cache(jnp.asarray(k), jnp.asarray(k), j_cfg,
                                t_cache, s)
    got = torch.zeros(2, t_cache, 2, 4)
    if s > t_cache:
        got.copy_(torch.from_numpy(k)[:, transformer.ring_fill_order(
            s, t_cache)])
    else:
        got[:, :s] = torch.from_numpy(k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jk))


def test_prefill_fills_the_ring_as_reference():
    """`transformer.prefill` of a 13-token prompt keeps the ring the
    reference's `_fill_kv_cache` makes of the full K/V."""
    cfg = configs.get_smoke_config("h2o-danube-3-4b")
    model = transformer.init(cfg, seed=0).eval()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 13)))
    with torch.no_grad():
        _, cache = transformer.prefill(model, toks, 20)
        positions = transformer._positions(toks)
        x = model.embed_tokens(toks, positions)
        layer = model.segments["seg0"][0]
        _, (k, v), _, _ = layer.full(x, positions, causal=True)
    jk, jv = j_tf._fill_kv_cache(
        jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        j_configs.get_smoke_config("h2o-danube-3-4b"), 8, 13)
    assert cache["seg0"]["k"].shape[2] == 8
    np.testing.assert_array_equal(cache["seg0"]["k"][0].numpy(),
                                  np.asarray(jk))
    np.testing.assert_array_equal(cache["seg0"]["v"][0].numpy(),
                                  np.asarray(jv))


def _j_params(attn):
    return {name: {k: jnp.asarray(p.detach().numpy())
                   for k, p in getattr(attn, name).named_parameters()}
            for name in ("wq", "wk", "wv", "wo")}


@pytest.mark.parametrize("per_slot", [True, False])
def test_ring_decode_matches_reference_past_the_window(per_slot):
    """Decode steps into a ring of 8 slots from position 0 to 19: the
    ring wraps twice; each step's output and cache equal the reference's
    `attn_decode` (per-slot positions, or one position for the batch)."""
    cfg = configs.get_smoke_config("h2o-danube-3-4b")
    j_cfg = j_configs.get_smoke_config("h2o-danube-3-4b")
    attn = attention.Attention(cfg, generator=torch.Generator()
                               .manual_seed(0))
    params = _j_params(attn)
    b, t = 2, cfg.window
    kc = torch.zeros(b, t, cfg.num_kv_heads, cfg.head_dim)
    vc = torch.zeros_like(kc)
    jk, jv = jnp.zeros(kc.shape), jnp.zeros(vc.shape)
    rng = np.random.default_rng(0)
    for p in range(20):
        x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        pos = (jnp.full((b,), p, jnp.int32) if per_slot else p)
        jy, jk, jv = j_attn.attn_decode(params, jnp.asarray(x), j_cfg,
                                        pos=pos, k_cache=jk, v_cache=jv)
        with torch.no_grad():
            y = attention.attn_decode(
                attn, torch.from_numpy(x),
                pos=torch.full((b,), p) if per_slot else p,
                k_cache=kc, v_cache=vc)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(kc.numpy(), np.asarray(jk), rtol=TOL,
                                   atol=TOL)


def test_attention_impl_selection():
    """`attn_impl`: `chunked` at any multiple of the chunk, `auto` above
    the chunk only; both equal to `dense` within 1e-5 (the full layer)."""
    base = dataclasses.replace(configs.get_smoke_config("h2o-danube-3-4b"),
                               attn_chunk=8)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 24, base.d_model)).astype(np.float32))
    pos = torch.arange(24)[None]
    out = {}
    for impl in ("dense", "chunked", "auto"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        attn = attention.Attention(cfg, generator=torch.Generator()
                                   .manual_seed(0))
        with torch.no_grad():
            out[impl], _ = attention.attn_apply(attn, x, positions=pos)
    for impl in ("chunked", "auto"):
        np.testing.assert_allclose(out[impl].numpy(), out["dense"].numpy(),
                                   rtol=TOL, atol=TOL)
