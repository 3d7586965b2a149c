"""Float16 models of every family against the JAX package: one smoke
config each (dense qwen2-1.5b, MoE phi3.5-moe-42b-a6.6b, SSM mamba2-1.3b
and enc-dec whisper-small and VLM qwen2-vl-72b, each with the paper's
memory FFN; hybrid zamba2-2.7b without, as the reference allows none in
its units) in float16, converted from the reference's weights
(`tests/_families.py`), a prefill then two decode steps against the
reference run op by op (`jax.disable_jit()`: `tests/_families.py` says
why), every logit within 2^-11 x (layers + 1) x the largest |value| of
the reference's: `bf16_tol`'s form at float16's unit roundoff.  An MoE
position whose top-k experts differ is excused only where the router's
margin is below one float16 rounding of the two logits (the routing rule
at 2^-11), and every later position of its sequence with it.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (batch, extras, f32, j_batch, model, pair, prefix,
                       t_batch)
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch.models import moe, transformer

F16 = "float16"
U16 = 2.0**-11  # float16's unit roundoff

# family -> (arch, with the memory FFN): a hybrid takes none in its units
FAMILIES = {"dense": ("qwen2-1.5b", True),
            "moe": ("phi3.5-moe-42b-a6.6b", True),
            "ssm": ("mamba2-1.3b", True),
            "hybrid": ("zamba2-2.7b", False),
            "encdec": ("whisper-small", True),
            "vlm": ("qwen2-vl-72b", True)}


def f16_tol(cfg, ref) -> float:
    """2^-11 (one float16 rounding) x (layers + 1) x the largest |value|
    of the reference's."""
    return U16 * (cfg.num_layers + 1) * float(np.abs(ref).max())


@contextlib.contextmanager
def _routes(ref: list, got: list):
    """Record each MoE block's routes: the reference's (expert ids,
    probabilities, logits), run op by op, and the port's expert ids."""
    real_j, real_t = j_moe.moe_apply, moe.route

    def j_recording(params, x, cfg):
        logits = (x @ params["router"]["kernel"].astype(x.dtype)).astype(
            jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        _, ids = jax.lax.top_k(probs, cfg.top_k_experts)
        ref.append((np.asarray(ids), np.asarray(probs), np.asarray(logits)))
        return real_j(params, x, cfg)

    def t_recording(m, x):
        routed = real_t(m, x)
        got.append(routed[2].detach().cpu().numpy())
        return routed

    j_moe.moe_apply, moe.route = j_recording, t_recording
    try:
        yield
    finally:
        j_moe.moe_apply, moe.route = real_j, real_t


def _excused(k, ref, got, shape) -> np.ndarray:
    """(B, S) bool: positions whose top-k experts differ where the
    router's margin (the k-th probability less the (k+1)-th) is below one
    float16 rounding of the two logits, and every later position of the
    sequence; a difference with a larger margin fails."""
    assert len(ref) == len(got)
    excused = np.zeros(shape, bool)
    for (ids, probs, logits), g in zip(ref, got):
        ids, g = ids.reshape(*shape, k), g.reshape(*shape, k)
        order = np.argsort(-probs, axis=-1, kind="stable")
        p = np.take_along_axis(probs, order, -1).reshape(*shape, -1)
        lg = np.take_along_axis(logits, order, -1).reshape(*shape, -1)
        margin = p[..., k - 1] - p[..., k]
        allowed = U16 * (p[..., k - 1] * np.abs(lg[..., k - 1])
                            + p[..., k] * np.abs(lg[..., k]))
        for b, s in np.argwhere((ids != g).any(-1)):
            assert margin[b, s] < allowed[b, s], (b, s, margin[b, s])
            excused[b, s:] = True
    return excused


def _close(cfg, got, want, excused=None):
    got, want = got.float().numpy(), f32(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.isfinite(want).all(), "the reference overflows float16"
    err = np.abs(got - want)
    if excused is not None:
        err = err[~excused]
    assert err.size == 0 or err.max() <= f16_tol(cfg, want), (
        float(err.max()), f16_tol(cfg, want))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fp16_family_prefill_and_decode_match_reference(family):
    """Each family's smoke config in float16 (the memory FFN in float16
    too, its table float32): prefill of 8 tokens then 2 decode steps
    against the JAX package's run op by op, every logit within `f16_tol`
    (MoE positions under the routing rule at 2^-11); the weights and
    caches stay float16."""
    arch, with_lram = FAMILIES[family]
    j_cfg, params, state, cfg = pair(arch, F16, with_lram)
    m = model(cfg, params, state)
    assert m.embed.embedding.dtype == torch.float16
    b, split = 2, 8
    full = batch(cfg, b, split + 2, 4)
    pre = prefix(full, split)
    moe_k = cfg.top_k_experts if cfg.family == "moe" else 0
    ref, got = [], []

    def routes():
        return _routes(ref, got) if moe_k else contextlib.nullcontext()

    tb = t_batch(pre)
    with routes():
        with jax.disable_jit():
            jl, jc = j_tf.prefill(params, state, j_batch(pre), j_cfg,
                                  split + 2)
        with torch.no_grad():
            tl, tc = transformer.prefill(m, tb["tokens"], split + 2,
                                         **extras(tb))
    excused = _excused(moe_k, ref, got, (b, split)) if moe_k else None
    _close(cfg, tl, jl, excused)
    seq = None if excused is None else excused.any(-1)
    toks = full["tokens"]
    for t in range(split, split + 2):
        pos = np.full((b,), t, np.int32)
        ref.clear()
        got.clear()
        with routes():
            with jax.disable_jit():
                jd, jc = j_tf.decode_step(
                    params, state, jnp.asarray(toks[:, t:t + 1]),
                    jnp.asarray(pos), jc, j_cfg)
            with torch.no_grad():
                td = transformer.decode_step(
                    m, torch.from_numpy(toks[:, t:t + 1]).long(),
                    torch.from_numpy(pos).long(), tc)
        if moe_k:
            seq |= _excused(moe_k, ref, got, (b, 1))[:, 0]
        _close(cfg, td, jd, None if seq is None else seq[:, None])
    for leaves in tc.values():
        for k in ("k", "v"):
            if k in leaves:
                assert leaves[k].dtype == torch.float16
