"""The MoE family in the port (phi3.5-moe-42b-a6.6b, mixtral-8x7b), each
with the paper's memory FFN (`with_lram`), held against the JAX package
on weights converted by `launch/convert.py`: the configs, the MoE block
(capacity drops, the tie rule, the dense oracle), forward logits and the
router loss, a train-mode loss and its gradients, prefill and decode
with their caches, decode against the full forward, the serve engine,
checkpoints both ways, and the CLIs.

Tolerances (`tests/_families.py`): float32 to 1e-5 against the compiled
JAX package; bfloat16 to `bf16_tol` (2^-8 x (layers + 1) x the largest
reference logit) against the JAX package run op by op, under the routing
rule.  Tokens are compared in float32."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _families import (TOL32, assert_close, f32, model,
                       oracle_routes, pair, port_routes, routing_excused,
                       tokens)
from repro import configs as j_configs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import convert, serve, train
from repro_torch.models import moe, transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

ARCHS = ("phi3.5-moe-42b-a6.6b", "mixtral-8x7b")
DTYPES = ("float32", "bfloat16")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Full (bfloat16) and smoke (float32) configs field for field, with
    and without the memory FFN, and the parameter counts (active too)."""
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(configs, get)(arch), getattr(j_configs, get)(arch)
        for f in dataclasses.fields(j):
            if f.name not in ("lram", "pkm"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        t, j = configs.with_lram(t), j_configs.with_lram(j)
        assert (t.name, t.lram_layers) == (j.name, j.lram_layers)
        assert t.lram.heads == j.lram.heads == t.d_model // 16
        assert t.param_count() == j.param_count()
    assert configs.get_config(arch).dtype == "bfloat16"
    assert configs.get_smoke_config(arch).dtype == "float32"
    assert configs.get_config(arch).family == "moe"


@pytest.mark.parametrize("arch", ARCHS)
def test_module_tree_is_the_reference_tree(arch):
    """Every leaf of the converted model has the reference's path, shape
    and dtype (stacked experts (E, d, f) split per layer)."""
    _, params, state, cfg = pair(arch, "bfloat16")
    flat = convert.state_dict_from_jax(jax.tree.map(np.asarray, params),
                                       jax.tree.map(np.asarray, state), cfg)
    m = transformer.init(cfg)
    sd = m.state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert sd["segments.seg0.0.moe.experts.wi_gate"].shape == (e, d, f)
    assert sd["segments.seg0.0.moe.experts.wo"].shape == (e, f, d)
    assert sd["segments.seg0.0.moe.router.kernel"].shape == (d, e)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _block(arch, dtype, **overrides):
    """(JAX cfg, JAX params, port MoE) of one block with the same leaves."""
    j_cfg = j_configs.get_smoke_config(arch, dtype=dtype, **overrides)
    cfg = configs.get_smoke_config(arch, dtype=dtype, **overrides)
    params = j_moe.moe_init(jax.random.PRNGKey(1), j_cfg,
                            dtype=jnp.dtype(dtype))
    block = moe.MoE(cfg)
    block.load_state_dict({k: convert.tensor_from_numpy(v) for k, v in
                           convert._flatten(jax.tree.map(
                               np.asarray, params)).items()})
    return j_cfg, params, block


def _inputs(cfg, b, s, seed=0):
    """The same (B, S, d) input for both, rounded to the config's dtype."""
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(cfg.dtype))
    return jx, torch.from_numpy(f32(jx)).to(cfg.torch_dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_with_capacity_drops(arch, dtype):
    """`moe_apply` against the JAX package's at capacity_factor 0.5 (a
    capacity of 4 copies an expert for 16 tokens x top-2 over 4 experts,
    so copies ARE dropped): expert ids equal, y and the aux loss to 1e-5
    in float32; in bfloat16 y to one rounding (2^-8 x max |y|) under the
    routing rule, against the block run op by op."""
    j_cfg, params, block = _block(arch, dtype, capacity_factor=0.5)
    jx, tx = _inputs(block.cfg, 2, 16)
    with torch.no_grad():
        _, _, ids = moe.route(block, tx)
        slot, keep = moe.dispatch(block.cfg, ids)
        assert moe.capacity(block.cfg, 16) == 4
        assert (~keep).sum() > 0, "no copy was dropped"
        assert ((slot == 0) | keep).all()
        y, aux = moe.moe_apply(block, tx)
    routes = []
    with oracle_routes(block.cfg, routes):
        jy, jaux = j_moe.moe_apply(params, jx, j_cfg)
    if dtype == "float32":
        _, j_ids = jax.lax.top_k(jax.nn.softmax((jx @ params["router"][
            "kernel"]).astype(jnp.float32)), j_cfg.top_k_experts)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(y.numpy(), f32(jy), rtol=TOL32,
                                   atol=TOL32)
        assert abs(aux.item() - float(jaux)) <= TOL32 * abs(float(jaux))
        return
    excused = routing_excused(j_cfg.top_k_experts, routes,
                              [ids.numpy()], (2, 16))
    err = np.abs(y.float().numpy() - f32(jy))[~excused]
    assert err.size == 0 or err.max() <= 2.0**-8 * np.abs(f32(jy)).max()
    assert abs(aux.item() - float(jaux)) <= 2.0**-8 * abs(float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_without_drops_is_the_dense_oracle(arch):
    """At capacity_factor 64 nothing is dropped: `moe_apply` equals the
    every-expert oracle (`moe_apply_dense_reference`) and the JAX
    package's oracle, float32."""
    j_cfg, params, block = _block(arch, "float32", capacity_factor=64.0)
    jx, tx = _inputs(block.cfg, 2, 12, seed=3)
    with torch.no_grad():
        _, keep = moe.dispatch(block.cfg, moe.route(block, tx)[2])
        assert keep.all()
        y, _ = moe.moe_apply(block, tx)
        dense = moe.moe_apply_dense_reference(block, tx)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=TOL32,
                               atol=TOL32)
    np.testing.assert_allclose(
        dense.numpy(), f32(j_moe.moe_apply_dense_reference(params, jx,
                                                           j_cfg)),
        rtol=TOL32, atol=TOL32)


def test_top_k_orders_ties_as_jax():
    """Equal probabilities: the lower expert first, as `jax.lax.top_k`."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.1, 0.3, 0.3], [0.2, 0.2, 0.5, 0.1]],
                     np.float32)
    for k in (1, 2, 3):
        vals, ids = moe.top_k(torch.from_numpy(probs), k)
        j_vals, j_ids = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


def test_position_in_expert_is_token_major():
    """Copies fill an expert in token order (copy k of token t before
    token t+1's), past the capacity dropped: hand-checked."""
    cfg = configs.get_smoke_config("mixtral-8x7b", capacity_factor=0.5)
    ids = torch.tensor([[[0, 1], [1, 0], [0, 2], [0, 3]]])  # 4 tokens, k=2
    slot, keep = moe.dispatch(cfg, ids)
    assert moe.capacity(cfg, 4) == 1
    # expert 0 takes token 0's copy only, expert 1 token 0's second copy
    assert keep.tolist() == [[True, True, False, False, False, True,
                              False, True]]
    assert slot.tolist() == [[0, 1, 0, 0, 0, 2, 0, 3]]


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, dtype):
    """Logits and the summed router loss of a (2, 16) batch (16 tokens
    pass mixtral's window of 8)."""
    j_cfg, params, state, cfg = pair(arch, dtype)
    m = model(cfg, params, state)
    assert m.embed.embedding.dtype == cfg.torch_dtype
    toks = tokens(cfg, 2, 16)
    routes, got_routes = [], []
    with oracle_routes(cfg, routes):
        jl, _, jaux = j_tf.forward(params, state,
                                   {"tokens": jnp.asarray(toks)}, j_cfg)
    with torch.no_grad(), port_routes(got_routes):
        tl, _, taux = transformer._forward(
            m, {"tokens": torch.from_numpy(toks).long()}, train=False,
            collect_access=False)
    assert tl.dtype == cfg.torch_dtype and taux.dtype == torch.float32
    excused = None
    if dtype == "bfloat16":
        excused = routing_excused(cfg.top_k_experts, routes, got_routes,
                                  (2, 16))
    assert_close(cfg, tl.float(), f32(jl), excused)
    rtol = TOL32 if dtype == "float32" else 2.0**-8 * (cfg.num_layers + 1)
    assert abs(taux.item() - float(jaux)) <= rtol * abs(float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    """A train-mode loss (cross-entropy + router_aux_weight x aux), its
    metrics, and the gradients of the memory table and of the first
    block's router and experts, float32."""
    j_cfg, params, state, cfg = pair(arch, "float32")
    m = model(cfg, params, state).train()
    toks, labels = tokens(cfg, 2, 16, 1), tokens(cfg, 2, 16, 2)
    (j_loss, (_, j_met)), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_tf.loss_fn(p, state, b, j_cfg, train=True),
        has_aux=True))(params, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})
    loss, met = transformer.loss_fn(m, {
        "tokens": torch.from_numpy(toks).long(),
        "labels": torch.from_numpy(labels).long()}, train=True)
    loss.backward()
    assert met["aux"].item() > 0
    for got, want in ((loss, j_loss), (met["aux"], j_met["aux"]),
                      (met["xent"], j_met["xent"])):
        assert abs(got.item() - float(want)) <= TOL32 * abs(float(want))
    seg = next(k for k in j_grads["segments"]
               if "memffn" in j_grads["segments"][k])
    jg = np.asarray(j_grads["segments"][seg]["memffn"]["lram"]["values"])
    tg = m.segments[seg].memffn.lram.values.grad.numpy()
    assert (tg != 0).any(axis=1).sum() > 0
    np.testing.assert_allclose(tg, jg, rtol=TOL32,
                               atol=TOL32 * np.abs(jg).max())
    j_moe_g = j_grads["segments"]["seg0"]["moe"]
    t_moe = m.segments["seg0"][0].moe
    for got, want in ((t_moe.router.kernel.grad,
                       j_moe_g["router"]["kernel"][0]),
                      (t_moe.experts.wi_gate.grad,
                       j_moe_g["experts"]["wi_gate"][0]),
                      (t_moe.experts.wo.grad, j_moe_g["experts"]["wo"][0])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Token-by-token decode from an empty cache against each step of
    the JAX package's decode (1e-5) and against the causal forward at
    capacity_factor 64 (no copy dropped in the forward either, as the
    reference's own test_archs_smoke holds it), float32; mixtral's ring
    of 8 wraps at 16 tokens."""
    j_cfg, params, state, cfg = pair(arch, "float32", capacity_factor=64.0)
    m = model(cfg, params, state)
    b, s = 2, 16
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch, dtype):
    """prefill(16 tokens) then decode(3) against the JAX package's: the
    logits, the K/V caches (mixtral's ring of 8 filled permuted) and each
    decode step, under the routing rule in bfloat16."""
    j_cfg, params, state, cfg = pair(arch, dtype)
    m = model(cfg, params, state)
    b, s, split = 2, 19, 16
    toks = tokens(cfg, b, s, 4)
    routes, got_routes = [], []
    bf16 = dtype == "bfloat16"
    with oracle_routes(cfg, routes):
        jl, jc = (j_tf.prefill if bf16 else jax.jit(
            j_tf.prefill, static_argnums=(3, 4)))(
            params, state, {"tokens": jnp.asarray(toks[:, :split])}, j_cfg,
            s)
    with torch.no_grad(), port_routes(got_routes):
        tl, tc = transformer.prefill(
            m, torch.from_numpy(toks[:, :split]).long(), s)
    excused = (routing_excused(cfg.top_k_experts, routes, got_routes,
                               (b, split)) if bf16 else None)
    assert_close(cfg, tl.float(), f32(jl), excused)
    seq_excused = None if excused is None else excused.any(-1)
    for name in tc:
        for k in ("k", "v"):
            assert tc[name][k].shape == jc[name][k].shape
            assert tc[name][k].dtype == cfg.torch_dtype
            if not (bf16 and seq_excused.any()):
                assert_close(cfg, tc[name][k].float(), f32(jc[name][k]))
    j_step = (j_tf.decode_step if bf16 else jax.jit(
        j_tf.decode_step, static_argnums=5))
    for t in range(split, s):
        pos = np.full((b,), t, np.int32)
        routes.clear()
        got_routes.clear()
        with oracle_routes(cfg, routes):
            jd, jc = j_step(params, state, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(pos), jc, j_cfg)
        with torch.no_grad(), port_routes(got_routes):
            td = transformer.decode_step(
                m, torch.from_numpy(toks[:, t:t + 1]).long(),
                torch.from_numpy(pos).long(), tc)
        if bf16:
            seq_excused |= routing_excused(cfg.top_k_experts, routes,
                                           got_routes, (b, 1))[:, 0]
        assert_close(cfg, td.float(), f32(jd),
                     None if not bf16 else seq_excused[:, None])


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

def test_engine_prefill_lengths():
    """phi3.5-moe prefills at power-of-two buckets (the capacity counts
    the padding), mixtral (a sliding window) at exact lengths."""
    for arch, want in zip(ARCHS, ([4, 16, 16], [3, 9, 16])):
        _, _, _, cfg = pair(arch, "float32")
        engine = ServeEngine(transformer.init(cfg), EngineConfig(max_len=40))
        assert [engine.prefill_len(n) for n in (3, 9, 16)] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_like_reference(arch):
    """ServeEngine (the memory read on `pallas`: the kernels' plain
    versions here) against the JAX engine on one mixed trace, float32:
    greedy tokens equal and every request's first logits to 1e-5."""
    j_cfg, params, state, cfg = pair(arch, "float32")
    kw = dict(vocab_size=cfg.vocab_size, max_prompt=12, max_gen=6)
    engine = ServeEngine(model(cfg, params, state),
                         EngineConfig(slots=2, max_len=18))
    trace = synthetic_trace(np.random.default_rng(5), 5, **kw)
    engine.warmup([r.prompt_len for r in trace])
    rep = engine.run(trace)
    j_rep = JServeEngine(params, state, j_cfg, JEngineConfig(
        slots=2, max_len=18)).run(
            j_synthetic_trace(np.random.default_rng(5), 5, **kw))
    assert [r.id for r in rep.requests] == [r.id for r in j_rep.requests]
    for a, b in zip(rep.requests, j_rep.requests):
        assert_close(cfg, a.first_logits, b.first_logits)
        assert a.tokens == b.tokens
    assert rep.generated_tokens == j_rep.generated_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_first_logits_bfloat16(arch):
    """ServeEngine in bfloat16: each request's first logits (its batch-1
    prefill, padded as the engine pads it) against the JAX package's
    forward of the same padded prompts run op by op, under the routing
    rule (the engine's prefills' routes against the reference's).  Four
    prompts of 16 tokens (past mixtral's window), two to a forward."""
    j_cfg, params, state, cfg = pair(arch, "bfloat16")
    engine = ServeEngine(model(cfg, params, state),
                         EngineConfig(slots=2, max_len=20))
    trace = synthetic_trace(np.random.default_rng(6), 4,
                            vocab_size=cfg.vocab_size, max_prompt=16,
                            max_gen=3, mixed=False)
    got_routes = []
    with port_routes(got_routes):
        rep = engine.run(trace)
    assert len(rep.requests) == 4
    blocks = sum(seg[1] for seg in transformer.layer_plan(cfg)
                 if seg[0] == "run")  # the MoE blocks of a prefill
    # a decode tick routes every slot: the batch-1 calls are the prefills
    prefills = [r for r in got_routes if r.shape[0] == 1]
    assert len(prefills) == 4 * blocks
    for i in (0, 2):
        toks = np.stack([r.prompt for r in trace[i:i + 2]]).astype(np.int32)
        routes = []
        with oracle_routes(cfg, routes):
            jl = f32(j_tf.forward(params, state,
                                  {"tokens": jnp.asarray(toks)}, j_cfg)[0])
        got = [np.concatenate([prefills[(i + r) * blocks + b]
                               for r in range(2)]) for b in range(blocks)]
        excused = routing_excused(cfg.top_k_experts, routes, got,
                                  toks.shape)[:, -1]
        first = np.stack([d.first_logits for d in rep.requests[i:i + 2]])
        assert_close(cfg, first, jl[:, -1], excused)


# ---------------------------------------------------------------------------
# checkpoints, CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_checkpoints_cross_both_ways(arch, tmp_path):
    """A bfloat16 MoE model's checkpoint: the JAX package's files (the
    experts stacked (n, E, d, f)) restore into the port bit for bit, and
    the port writes the same files (headers, manifest dtypes, crc32s)."""
    _, params, state, cfg = pair(arch, "bfloat16")
    m = model(cfg, params, state)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JCheckpointManager(j_dir).save(3, {"params": params,
                                       "model_state": state})
    CheckpointManager(t_dir).save(3, convert.reference_tree(m))
    step_dir = "step_000000000003"
    manifests = [json.load(open(os.path.join(d, step_dir, "manifest.json")))
                 for d in (j_dir, t_dir)]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    wi = manifests[0]["leaves"]["params/segments/seg0/moe/experts/wi_gate"]
    assert wi["dtype"] == "bfloat16" and wi["shape"] == [
        1, cfg.num_experts, cfg.d_model, cfg.d_ff]
    for meta in manifests[0]["leaves"].values():
        a, b = (open(os.path.join(d, step_dir, meta["file"]), "rb").read()
                for d in (j_dir, t_dir))
        assert a == b, meta["file"]
    for d in (j_dir, t_dir):
        fresh = transformer.init(cfg, seed=7)
        step, tree = CheckpointManager(d).restore(
            convert.reference_tree(fresh, like=True))
        assert step == 3
        convert.load_reference_tree(fresh, tree)
        for (k, a), (_, b) in zip(m.state_dict().items(),
                                  fresh.state_dict().items()):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    emb = np.load(os.path.join(t_dir, step_dir,
                               "params__embed__embedding.npy"))
    np.testing.assert_array_equal(
        emb.view(ml_dtypes.bfloat16).astype(np.float32),
        f32(params["embed"]["embedding"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke_arch_on_cpu(capsys, arch):
    """`serve --arch <MoE arch> --smoke --device cpu --json --warmup`."""
    rep = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen", "3",
                      "--warmup", "--json"])
    assert len(rep.requests) == 4
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["arch"] == configs.get_smoke_config(arch).name
    assert doc["cache"] is None


def test_train_cli_trains_the_smoke_moe_with_its_router_loss():
    """One process trains the float32 smoke config through `loss_fn`: the
    router loss is in the step's metrics and the loss stays finite."""
    run = train.main(["--arch", "mixtral-8x7b", "--smoke", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "8"])
    assert len(run.records) == 2
    assert all(np.isfinite(r["loss"]) for r in run.records)
