"""Shared pieces of the MoE and SSM parity tests (`test_torch_moe.py`,
`test_torch_ssm.py`): the two packages' configs with the memory FFN,
converted models, the tolerances, and the JAX package run op by op.

Why op by op for bfloat16.  Under `jax.jit` XLA fuses chains of
bfloat16 elementwise ops and keeps their intermediates in float32, so the
JAX package's compiled forward rounds fewer intermediates than its own
forward run op by op (`jax.disable_jit()`), and on the smoke MoE archs
the two can differ by more than `bf16_tol` in the logits (a token's
top-2 experts flip inside the compiled run).  The port rounds after
every op, as JAX's op-by-op run does, so the bfloat16 oracle is the JAX
package under `jax.disable_jit()` (float32 runs agree either way, to
1e-5).  Each new shape there compiles every primitive anew: the bfloat16
tests share their shapes.

The routing rule.  A bfloat16 comparison may differ at a position whose
top-k experts differ between the packages, and only where the router's
margin there (the k-th probability less the (k+1)-th) is below what one
bfloat16 rounding of the two logits can move it: 2^-8 times (p_k |l_k| +
p_(k+1) |l_(k+1)|).  Such a position, and every later one of its
sequence (causal attention reads it), is excused and printed with its
margin; a routing difference with a larger margin fails.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as j_configs
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch import configs
from repro_torch.launch import convert
from repro_torch.models import moe

LOG2 = 16  # the smallest table the torus allows: a quick CPU lookup
TOL32 = 1e-5


def bf16_tol(cfg, ref) -> float:
    """2^-8 (one bfloat16 rounding) times (layers + 1) times the largest
    reference logit, as tests/test_torch_archs.py holds the dense archs."""
    return 2.0**-8 * (cfg.num_layers + 1) * float(np.abs(ref).max())


def assert_close(cfg, got, want, excused=None):
    """float32 to 1e-5 (rtol and atol); bfloat16 to `bf16_tol` on every
    position (leading dims (B, S)) not `excused` by the routing rule."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if cfg.dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32)
        return
    err = np.abs(got - want)
    if excused is not None:
        err = err[~excused]
    assert err.size == 0 or err.max() <= bf16_tol(cfg, want), (
        float(err.max()), bf16_tol(cfg, want))


def cfgs(arch, dtype, **overrides):
    """(JAX cfg on its reference placement, port cfg on `pallas`): the
    smoke config in `dtype` with the memory FFN (2^16 rows)."""
    j_cfg = j_configs.with_lram(
        j_configs.get_smoke_config(arch, dtype=dtype, **overrides), LOG2)
    cfg = configs.with_lram(
        configs.get_smoke_config(arch, dtype=dtype, **overrides), LOG2)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    return j_cfg, cfg


_CACHE = {}


def pair(arch, dtype, **overrides):
    """(JAX cfg, params, state, port cfg), memoised; `model` converts a
    fresh port model from them."""
    key = (arch, dtype, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        j_cfg, cfg = cfgs(arch, dtype, **overrides)
        params, state = jax.jit(j_tf.init, static_argnums=1)(
            jax.random.PRNGKey(0), j_cfg)
        _CACHE[key] = (j_cfg, params, state, cfg)
    return _CACHE[key]


def model(cfg, params, state):
    return convert.model_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, state), cfg,
                                  device="cpu").eval()


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def oracle(cfg):
    """The context the JAX package runs in as the oracle: compiled for
    float32, op by op for bfloat16 (module docstring)."""
    return (contextlib.nullcontext() if cfg.dtype == "float32"
            else jax.disable_jit())


@contextlib.contextmanager
def oracle_routes(cfg, out: list):
    """`oracle(cfg)`, recording the JAX package's routes into `out` where
    it runs op by op (bfloat16; `reference_routes`)."""
    with oracle(cfg):
        if cfg.dtype == "float32":
            yield
        else:
            with reference_routes(out):
                yield


def f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def reference_routes(out: list):
    """Record each MoE block the JAX package runs op by op (under
    `jax.disable_jit()`): its (expert ids, probabilities, logits), as
    numpy arrays."""
    real = j_moe.moe_apply

    def recording(params, x, cfg):
        logits = (x @ params["router"]["kernel"].astype(x.dtype)).astype(
            jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        _, ids = jax.lax.top_k(probs, cfg.top_k_experts)
        out.append((np.asarray(ids), np.asarray(probs), np.asarray(logits)))
        return real(params, x, cfg)

    j_moe.moe_apply = recording
    try:
        yield
    finally:
        j_moe.moe_apply = real


@contextlib.contextmanager
def port_routes(out: list):
    """Record the expert ids of each MoE block the port runs."""
    real = moe.route

    def recording(m, x):
        routed = real(m, x)
        out.append(routed[2].detach().cpu().numpy())
        return routed

    moe.route = recording
    try:
        yield
    finally:
        moe.route = real


def routing_excused(k: int, ref_routes, got_routes, shape) -> np.ndarray:
    """(B, S) bool: the positions the routing rule excuses (module
    docstring).  Fails on a routing difference of a larger margin."""
    assert len(ref_routes) == len(got_routes)
    excused = np.zeros(shape, bool)
    for layer, ((ids, probs, logits), got) in enumerate(
            zip(ref_routes, got_routes)):
        ids, got = ids.reshape(*shape, k), got.reshape(*shape, k)
        differ = (ids != got).any(-1)
        order = np.argsort(-probs, axis=-1, kind="stable")
        p = np.take_along_axis(probs, order, -1).reshape(*shape, -1)
        lg = np.take_along_axis(logits, order, -1).reshape(*shape, -1)
        margin = p[..., k - 1] - p[..., k]
        allowed = 2.0**-8 * (p[..., k - 1] * np.abs(lg[..., k - 1])
                             + p[..., k] * np.abs(lg[..., k]))
        for b, s in np.argwhere(differ):
            print(f"routing differs: MoE block {layer}, position ({b}, {s}),"
                  f" margin {margin[b, s]:.3e}, one rounding "
                  f"{allowed[b, s]:.3e}")
            assert margin[b, s] < allowed[b, s], (layer, b, s)
            excused[b, s:] = True
    return excused
