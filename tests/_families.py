"""Shared pieces of the family parity tests (`test_torch_moe.py`,
`test_torch_ssm.py`, `test_torch_hybrid.py`, `test_torch_encdec.py`,
`test_torch_vlm.py`): the two packages' configs with the memory FFN (or
without), converted models, the families' inputs (encoder frames, vision
embeddings on a frame of patches with their M-RoPE positions), the
tolerances, and the JAX package run op by op.

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
import torch

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


def cfgs(arch, dtype, lram=True, **overrides):
    """(JAX cfg on its reference placement, port cfg on `pallas`): the
    smoke config in `dtype` with the memory FFN (2^16 rows), or without
    it when not `lram`."""
    j_cfg = j_configs.get_smoke_config(arch, dtype=dtype, **overrides)
    cfg = configs.get_smoke_config(arch, dtype=dtype, **overrides)
    if not lram:
        return j_cfg, cfg
    j_cfg = j_configs.with_lram(j_cfg, LOG2)
    cfg = configs.with_lram(cfg, LOG2)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    return j_cfg, cfg


_CACHE = {}


def pair(arch, dtype, lram=True, **overrides):
    """(JAX cfg, params, state, port cfg), memoised; `model` converts a
    fresh port model from them."""
    key = (arch, dtype, lram, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        j_cfg, cfg = cfgs(arch, dtype, lram, **overrides)
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


def grid_positions(grid: int, b: int, s: int) -> np.ndarray:
    """M-RoPE positions (3, b, s): one frame of grid x grid patches,
    patch i at (t, h, w) = (0, i // grid, i % grid), then text at grid,
    grid + 1, ... on every stream (continuing from the grid's largest
    position): not the sequence index, so a wrong band split shows."""
    pos = np.empty((3, s), np.int32)
    patch = np.arange(grid * grid)
    pos[0, :grid * grid] = 0
    pos[1, :grid * grid] = patch // grid
    pos[2, :grid * grid] = patch % grid
    pos[:, grid * grid:] = grid + np.arange(s - grid * grid)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s)))


def batch(cfg, b, s, seed=0) -> dict:
    """numpy inputs of a (b, s) batch: tokens, and the family's extras
    (an enc-dec model's encoder frames, a VLM's vision embeddings on one
    square frame and their positions), drawn from `seed`."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["encoder_embeds"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        grid = int(np.sqrt(cfg.vision_tokens))
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        out["positions"] = grid_positions(grid, b, s)
    return out


def j_batch(np_batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in np_batch.items()}


def t_batch(np_batch: dict) -> dict:
    """The batch as torch tensors (ints as long)."""
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in np_batch.items()}


def prefix(np_batch: dict, s: int) -> dict:
    """The batch's first `s` positions (tokens and M-RoPE positions;
    the encoder frames and vision embeddings whole)."""
    out = dict(np_batch, tokens=np_batch["tokens"][:, :s])
    if "positions" in out:
        out["positions"] = np.ascontiguousarray(out["positions"][..., :s])
    return out


def extras(t: dict) -> dict:
    """`transformer.prefill`'s keyword extras of a torch batch."""
    return {k: v for k, v in t.items() if k != "tokens"}


def assert_grads_match(m, j_grads, cfg, rtol=TOL32):
    """Every parameter's gradient in the port against the JAX package's
    (its tree converted to the port's names, stacked layers split): to
    `rtol` and an atol of `rtol` times the leaf's largest magnitude.
    Returns the number of leaves compared."""
    want = convert.state_dict_from_jax(jax.tree.map(np.asarray, j_grads),
                                       {}, cfg)
    params = dict(m.named_parameters())
    assert set(params) == set(want)
    for key, p in params.items():
        jg = want[key].float().numpy()
        assert p.grad is not None, key
        np.testing.assert_allclose(
            p.grad.float().numpy(), jg, rtol=rtol,
            atol=rtol * max(float(np.abs(jg).max()), 1e-30), err_msg=key)
    return len(params)


def reference_logits(j_cfg, params, state, np_batch: dict) -> np.ndarray:
    """The JAX package's forward logits of a numpy batch as float32, in
    `oracle`'s mode: compiled for float32, op by op for bfloat16."""
    def fwd(p, s, b):
        return j_tf.forward(p, s, b, j_cfg)[0]

    if j_cfg.dtype == "float32":
        return f32(jax.jit(fwd)(params, state, j_batch(np_batch)))
    with jax.disable_jit():
        return f32(fwd(params, state, j_batch(np_batch)))


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
