"""Port parity: nn layers, the LRAM layer and the memory FFN on weights
converted from the JAX package (eval and train-mode batchnorm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as j_nn
from repro.core import lram as j_lram
from repro_torch import nn as tnn
from repro_torch.core import lram
from repro_torch.launch.convert import _flatten


def _load(module, params, state=None):
    sd = _flatten(jax.tree.map(np.asarray, params))
    sd.update(_flatten(jax.tree.map(np.asarray, state or {})))
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module


def test_dense_and_norms_match():
    """dense ((in, out) kernel), rmsnorm and layernorm (eps 1e-6) to 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    jd = j_nn.dense_init(jax.random.PRNGKey(1), 24, 40)
    jd["bias"] = jnp.asarray(rng.normal(size=40).astype(np.float32))
    d = _load(tnn.Dense(24, 40), jd)
    assert d.kernel.shape == (24, 40)
    np.testing.assert_allclose(d(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(j_nn.dense(jd, jnp.asarray(x))),
                               atol=1e-5)
    scale = rng.normal(size=24).astype(np.float32)
    bias = rng.normal(size=24).astype(np.float32)
    np.testing.assert_allclose(
        tnn.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(j_nn.rmsnorm({"scale": jnp.asarray(scale)},
                                jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(
        tnn.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                      torch.from_numpy(bias)).numpy(),
        np.asarray(j_nn.layernorm({"scale": jnp.asarray(scale),
                                   "bias": jnp.asarray(bias)},
                                  jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches(train):
    """Momentum 0.99, biased variance, eps 1e-5: output and running stats
    to 1e-5."""
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.normal(size=(6, 7, 16))).astype(np.float32)
    params = {"scale": jnp.asarray(rng.normal(size=16).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(size=16).astype(np.float32))}
    state = {"mean": jnp.asarray(rng.normal(size=16).astype(np.float32)),
             "var": jnp.asarray(rng.uniform(0.5, 2, 16).astype(np.float32))}
    bn = _load(tnn.BatchNorm(16), params, state)
    y = bn(torch.from_numpy(x), train=train).detach().numpy()
    jy, jst = j_nn.batchnorm(params, state, jnp.asarray(x), train=train)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(jst["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(jst["var"]),
                               atol=1e-6)


def test_truncated_normal_init():
    """Standard normal truncated to [-2, 2], times stddev (the reference's
    init; the numbers differ from jax.random's, the distribution not)."""
    t = tnn.truncated_normal_(torch.empty(200_000), 0.5,
                              torch.Generator().manual_seed(0))
    assert t.abs().max() <= 1.0
    # std of N(0,1) truncated at +-2 is 0.8796
    assert abs(t.std().item() - 0.5 * 0.8796) < 3e-3
    assert abs(t.mean().item()) < 3e-3


def _lram_pair(query_norm, seed=0):
    j_cfg = j_lram.LRAMConfig(log2_locations=16, heads=4,
                              query_norm=query_norm)
    params, state = jax.jit(j_lram.lram_init, static_argnums=1)(
        jax.random.PRNGKey(seed), j_cfg)
    rng = np.random.default_rng(seed)
    if query_norm == "batch":  # non-trivial running stats
        state = {"qnorm": {
            "mean": jnp.asarray(rng.normal(size=16).astype(np.float32)),
            "var": jnp.asarray(rng.uniform(0.5, 2, 16).astype(np.float32))}}
    cfg = lram.LRAMConfig(log2_locations=16, heads=4, query_norm=query_norm,
                          interp_impl="pallas")
    layer = _load(lram.LRAM(cfg), params, state)
    return j_cfg, params, state, layer


@pytest.mark.parametrize("query_norm,train", [
    ("batch", False), ("batch", True), ("rms", False), ("none", False)])
def test_lram_apply_matches(query_norm, train):
    """Output to 1e-5 (top-k ties may swap equal weights), running stats to
    1e-6; the port's pallas cell runs the kernels' plain versions here."""
    j_cfg, params, state, layer = _lram_pair(query_norm)
    x = np.random.default_rng(5).normal(size=(3, 9, 64)).astype(np.float32)
    y, (idx, w) = lram.lram_apply(layer, torch.from_numpy(x), train=train,
                                  return_access=True)
    jy, jst = jax.jit(lambda p, s, x: j_lram.lram_apply(
        p, s, x, j_cfg, train=train))(params, state, jnp.asarray(x))
    assert y.shape == (3, 9, 256) and idx.shape == (3, 9, 4, 32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    if query_norm == "batch":
        np.testing.assert_allclose(layer.qnorm.mean.numpy(),
                                   np.asarray(jst["qnorm"]["mean"]),
                                   atol=1e-6)
        np.testing.assert_allclose(layer.qnorm.var.numpy(),
                                   np.asarray(jst["qnorm"]["var"]),
                                   atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_memffn_apply_matches(train):
    """The paper's block dense(w->w) . LRAM(w->4w) . dense(4w->w), w=64."""
    j_cfg = j_lram.memffn_config(64, 16, query_norm="batch")
    params, state = jax.jit(j_lram.memffn_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(3), 64, j_cfg)
    block = _load(lram.MemFFN(64, lram.memffn_config(
        64, 16, query_norm="batch", interp_impl="pallas")), params, state)
    x = np.random.default_rng(6).normal(size=(2, 11, 64)).astype(np.float32)
    y = lram.memffn_apply(block, torch.from_numpy(x), train=train)
    jy, jst = jax.jit(lambda p, s, x: j_lram.memffn_apply(
        p, s, x, j_cfg, train=train))(params, state, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(block.lram.qnorm.mean.numpy(),
                               np.asarray(jst["lram"]["qnorm"]["mean"]),
                               atol=1e-6)


def test_reference_and_pallas_cells_agree_on_cpu():
    _, _, _, layer = _lram_pair("batch", seed=2)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(5, 64)).astype(np.float32))
    torch.testing.assert_close(
        lram.lram_apply(layer, x, interp_impl="reference"),
        lram.lram_apply(layer, x, interp_impl="pallas"), rtol=0, atol=0)


def test_cached_tensors_from_a_serve_do_not_break_autograd():
    """The port caches device tensors (candidate tables, RoPE
    frequencies).  When the first call came from a serve, under
    torch.inference_mode, a cached inference tensor used to make every
    later autograd call raise ("Inference tensors cannot be saved for
    backward"); the caches now hold normal tensors."""
    from repro_torch.core import lattice
    from repro_torch.kernels import e8_lookup
    from repro_torch.models import attention

    for cached in (lattice._candidates_on, e8_lookup._padded_candidates,
                   attention._frequencies_on):
        cached.cache_clear()
    _, _, _, layer = _lram_pair("rms", seed=3)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(4, 64)).astype(np.float32))
    with torch.inference_mode():
        lram.lram_apply(layer, x)
        attention.apply_rope(torch.ones(1, 2, 1, 8),
                             torch.zeros(1, 2, dtype=torch.long), 1e4)
        e8_lookup._padded_candidates(torch.device("cpu"))
    xg = x.clone().requires_grad_(True)
    lram.lram_apply(layer, xg).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    r = torch.ones(1, 2, 1, 8, requires_grad=True)
    attention.apply_rope(r, torch.ones(1, 2, dtype=torch.long), 1e4) \
        .sum().backward()
    assert not e8_lookup._padded_candidates(torch.device("cpu"))[0] \
        .is_inference()
