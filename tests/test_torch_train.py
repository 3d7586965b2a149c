"""Port parity for the training slices as a whole: `lram-bert-medium`
(smoke) on weights converted from the JAX package, against the JAX model,
its `loss_fn` under `jax.grad` and its train step; `lram-tiered` and
`lram-tiered-q8` (smoke) through the tiered store's write-back against the
JAX train step with its traced io_callback write-back, bound as
`repro.launch.train` binds it; and the training CLI.

The reference runs its `reference` cell (its default for lram-bert); the
port runs both its `pallas` cell (the CUDA kernels' plain versions on the
CPU, with the backward kernel's analytic d query) and its `reference` cell
(plain autograd).  Batches come from the reference's data pipeline.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import data as j_data
from repro import memstore as j_memstore
from repro import optim as j_optim
from repro.launch import train as j_train
from repro.models import transformer as j_tf
from repro_torch import configs, data, optim
from repro_torch.launch import convert, train
from repro_torch.models import transformer

ARCH = "lram-bert-medium"
BATCH, SEQ = 4, 32


def _placed(cfg, impl):
    return dataclasses.replace(
        cfg, lram=dataclasses.replace(cfg.lram, interp_impl=impl))


@pytest.fixture(scope="module")
def ref():
    """The reference's config, (params, state) as numpy, and its batches."""
    j_cfg = j_configs.get_smoke_config(ARCH)
    params, state = jax.jit(j_tf.init, static_argnums=1)(
        jax.random.PRNGKey(0), j_cfg)
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective,
                             seed=0)
    batches = [j_data.get_batch(dcfg, step=s) for s in range(20)]
    return (j_cfg, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), batches)


def _model(ref, impl):
    _, params, state, _ = ref
    cfg = _placed(configs.get_smoke_config(ARCH), impl)
    return convert.model_from_jax(params, state, cfg, device="cpu")


def _tbatch(batch):
    return train.batch_to(batch, "cpu")


@pytest.mark.parametrize("variant", ["baseline", "small", "medium", "large"])
def test_configs_match_reference(variant):
    name = f"lram-bert-{variant}"
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(configs, get)(name), getattr(j_configs, get)(name)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "act", "norm",
                  "pos_scheme", "objective", "max_seq", "lram_layers",
                  "head_dim", "tie_embeddings"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        if variant != "baseline":
            for f in ("log2_locations", "m", "heads", "top_k",
                      "query_norm", "interp_impl"):
                assert getattr(t.lram, f) == getattr(j.lram, f), (get, f)
        assert t.param_count() == j.param_count()


def test_converted_weights_carry_every_leaf(ref):
    """pos_embed, the layernorms, lm_head, the memory FFN and the qnorm
    running stats cross from the JAX pytree unchanged."""
    _, params, state, _ = ref
    model = _model(ref, "pallas")
    np.testing.assert_array_equal(model.pos_embed.detach().numpy(),
                                  params["pos_embed"])
    sd = model.state_dict()
    flat = convert.state_dict_from_jax(params, state, model.cfg)
    assert set(flat) == set(sd)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    assert any(k.endswith("qnorm.mean") for k in flat)


@pytest.mark.parametrize("train_mode", [False, True])
def test_forward_loss_and_batchnorm_stats_match(ref, train_mode):
    """Logits, MLM loss and (train mode) the updated batchnorm running
    stats, to 1e-5 (float32 sums in another order)."""
    j_cfg, params, state, batches = ref
    batch = batches[0]
    model = _model(ref, "pallas")
    jb = jax.tree.map(jnp.asarray, batch)
    j_loss, (j_state, j_metrics) = jax.jit(lambda b: j_tf.loss_fn(
        params, state, b, j_cfg, train=train_mode))(jb)
    j_logits = jax.jit(lambda b: j_tf.forward(params, state, b,
                                              j_cfg)[0])(jb)
    with torch.no_grad():
        loss, metrics = transformer.loss_fn(model, _tbatch(batch),
                                            train=train_mode)
        logits = transformer.forward(model, _tbatch(batch))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert int(metrics["ntokens"]) == int(j_metrics["ntokens"])
    bn = model.segments["seg1"].memffn.lram.qnorm
    j_bn = j_state["seg1"]["lram"]["qnorm"]
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(j_bn["mean"]),
                               atol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(j_bn["var"]),
                               atol=1e-5)
    if not train_mode:  # the eval forward, with the stats unchanged
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=1e-5)


@pytest.fixture(scope="module")
def ref_grads(ref):
    j_cfg, params, state, batches = ref
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_tf.loss_fn(p, state, b, j_cfg, train=True),
        has_aux=True))(params, jax.tree.map(jnp.asarray, batches[0]))
    flat = convert.state_dict_from_jax(
        jax.tree.map(np.asarray, grads), {}, j_cfg)
    return float(loss), {k: v.numpy() for k, v in flat.items()}


def _port_grads(ref, impl):
    model = _model(ref, impl)
    loss, _ = transformer.loss_fn(model, _tbatch(ref[3][0]), train=True)
    loss.backward()
    return loss.item(), {k: p.grad.numpy()
                         for k, p in model.named_parameters()}


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_step1_gradients_match_jax(ref, ref_grads, impl):
    """Every leaf's step-1 gradient against jax.grad of the reference's
    loss_fn (train mode), to rtol 1e-4 / atol 1e-5."""
    j_loss, j_grads = ref_grads
    loss, grads = _port_grads(ref, impl)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert set(grads) == set(j_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, j_grads[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    table = "segments.seg1.memffn.lram.values"
    assert np.count_nonzero(grads[table]) > 0


def test_pallas_and_reference_cells_give_the_same_gradients(ref):
    """The pallas cell (forward kernels, backward kernel; plain versions on
    the CPU) against the plain-autograd reference cell: the same loss, and
    every leaf's gradient to rtol 1e-4 / atol 1e-6 (dq is analytic in one,
    autodiff in the other)."""
    loss_p, g_p = _port_grads(ref, "pallas")
    loss_r, g_r = _port_grads(ref, "reference")
    assert loss_p == loss_r
    for k in g_p:
        np.testing.assert_allclose(g_p[k], g_r[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_twenty_step_loss_curve_tracks_jax(ref):
    """20 train steps (lr 1e-4, the paper's 10x on the table, clip 1.0) from
    the same weights on the same batches: every step's loss and grad norm
    within rtol 1e-4 of the reference's train step.  Adam divides by
    sqrt(v), so float32 differences in near-zero gradients can grow from
    step to step; on this run they stay below that tolerance."""
    j_cfg, params, state, batches = ref
    j_opt_cfg = j_optim.OptimConfig(lr=1e-4)
    j_step = j_train.build_train_step(j_cfg, j_opt_cfg)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = jax.tree.map(jnp.asarray, state)
    j_opt = j_optim.adam_init(j_params)
    residual = jnp.zeros(())
    model = _model(ref, "pallas")
    opt_state = optim.adam_init(dict(model.named_parameters()))
    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4))
    losses, j_losses = [], []
    for b in batches:
        j_params, j_opt, j_state, residual, jm = j_step(
            j_params, j_opt, j_state, residual,
            jax.tree.map(jnp.asarray, b))
        m = step(opt_state, _tbatch(b))
        losses.append((m["loss"].item(), m["grad_norm"].item()))
        j_losses.append((float(jm["loss"]), float(jm["grad_norm"])))
    np.testing.assert_allclose(np.array(losses), np.array(j_losses),
                               rtol=1e-4)
    assert losses[-1][0] < losses[0][0]


def test_evaluate_matches_the_reference_definition(ref):
    """`evaluate`'s held-out loss (4 batches at steps 10,000,000+) and
    fact recall on the 64-sequence probe, against the same quantities from
    the reference's eval-mode loss_fn and forward on the same batches:
    loss to 1e-5 relative, recall exactly."""
    j_cfg, params, state, _ = ref
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective,
                             seed=0)
    table = j_data.make_fact_table(dcfg)
    j_loss = jax.jit(lambda b: j_tf.loss_fn(params, state, b, j_cfg,
                                            train=False)[0])
    want_loss = np.mean([float(j_loss(jax.tree.map(
        jnp.asarray, j_data.get_batch(dcfg, step=10_000_000 + i,
                                      table=table)))) for i in range(4)])
    probe = j_data.synthetic.fact_eval_batch(dcfg, n=64, table=table)
    logits = jax.jit(lambda b: j_tf.forward(params, state, b, j_cfg)[0])(
        jax.tree.map(jnp.asarray, probe))
    mask = probe["labels"] != j_data.synthetic.IGNORE
    want_recall = float((np.asarray(logits).argmax(-1) == probe["labels"])
                        [mask].mean())
    loss, recall = train.evaluate(_model(ref, "pallas"),
                                  data.DataConfig(**vars(dcfg)))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert recall == want_recall


def test_cli_trains_on_the_cpu(capsys):
    run = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--json",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--placement", "pallas", "--eval-every", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    steps = [x for x in lines if "step" in x]
    assert [x["step"] for x in steps] == [0, 1, 2]
    for x in steps:
        assert np.isfinite([x["loss"], x["grad_norm"], x["step_ms"]]).all()
    assert any("eval_loss" in x for x in lines)
    assert lines[-1]["steps"] == 3 and lines[-1]["device"] == "cpu"
    assert len(run.records) == 3 and np.isfinite(run.final_eval_loss)
    assert int(run.opt_state["step"]) == 3


@pytest.mark.parametrize("flag", [
    ["--telemetry"], ["--grow-at", "2:17"], ["--use-mesh"],
])
def test_cli_runs_the_once_refused_options(flag, capsys):
    """The options that were once refused, each now ported.  `--use-mesh`:
    outside a launch of several ranks it trains on one process without a
    mesh, as the reference does on one device, and gives the run without
    the flag (the 4-rank run is tests/test_torch_mesh_train.py).
    `--telemetry` and `--grow-at` (`repro_torch.memctl`): at smoke size
    they train, printing the utilisation report a logged step, or growing
    the table to 2^17 rows before step 2 (`tests/test_torch_memctl.py`
    holds both against the JAX trainer).  `--metrics-dir` and
    `--profile-dir` are `tests/test_torch_obs.py`'s."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--placement", "pallas"]
    if flag == ["--telemetry"]:
        run = train.main(argv + flag + ["--log-every", "1"])
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                 if x.startswith('{"step"')]
        util = [x for x in lines if "utilisation_report" in x]
        assert [x["step"] for x in util] == [0, 1, 2]
        names = [row[0] for row in util[-1]["utilisation_report"]]
        assert names == ["util_seg1_dead_frac", "util_seg1_hot10_mass",
                         "util_seg1_cold_frac"]
        counts = run.telemetry["seg1"]["counts"]
        # 3 steps of 2 x 16 tokens, 4 heads of top-32 each
        assert int(counts.sum()) == 3 * 2 * 16 * 4 * 32
        assert int(run.telemetry["seg1"]["steps"]) == 3
        return
    if flag == ["--grow-at", "2:17"]:
        run = train.main(argv + flag)
        out = capsys.readouterr().out.splitlines()
        grows = [json.loads(x) for x in out if x.startswith('{"grow"')]
        assert [(g["grow"], g["step"]) for g in grows] == [("2^17", 2)]
        assert grows[0]["pause_s"] >= 0
        assert run.model.cfg.lram.num_locations == 2**17
        key = "segments.seg1.memffn.lram.values"
        assert run.model.get_parameter(key).shape[0] == 2**17
        assert run.opt_state["mu"][key].shape[0] == 2**17
        assert len(run.records) == 3 and all(
            np.isfinite(r["loss"]) for r in run.records)
        assert [e["event"] for e in run.lifecycle] == ["grow"]
        return
    if flag == ["--use-mesh"]:
        argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16", "--placement", "pallas",
                "--json"]
        run = train.main(argv + flag)
        summary = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert summary["mesh"] is None
        plain = train.main(argv)
        assert [r["loss"] for r in run.records] == \
            [r["loss"] for r in plain.records]


def test_cli_refuses_sharded_without_a_mesh():
    """One process builds no mesh: the sharded placement fails at resolve
    time, naming the mesh it needs (the 4-rank run is
    tests/test_torch_mesh_train.py)."""
    with pytest.raises(SystemExit, match="needs an ambient mesh"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "1", "--placement", "sharded"])


def test_cli_refuses_a_frozen_dense_table():
    """A dense int8 table is frozen: the reference trains a quantized
    table only through the tiered store's write-back."""
    with pytest.raises(SystemExit, match="frozen.*tiered store"):
        train.main(["--arch", "lram-tiered-q8", "--smoke", "--device",
                    "cpu", "--steps", "1", "--placement", "pallas"])


@pytest.mark.parametrize("arch", ["lram-tiered", "lram-tiered-q8"])
def test_cli_trains_tiered_tables_on_the_cpu(arch, capsys):
    """The tiered archs train through the CLI: one write-back a step, the
    table changed, the cache hit rate in every step's line, nothing dirty
    after the final flush, and Adam never sees the store's table."""
    run = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--json", "--steps", "2", "--batch", "2", "--seq",
                      "16"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert all(0 <= x["cache_hit"] <= 1 for x in lines if "step" in x)
    (store,) = run.stores
    assert store.stats["writebacks"] == 2 and not store._dirty
    assert store.writeback_lr == pytest.approx(1e-3)
    assert lines[-1]["cache"][0]["writebacks"] == 2
    assert not any("values" in k for k in run.opt_state["mu"])


@pytest.mark.parametrize("arch", ["lram-tiered", "lram-tiered-q8"])
def test_tiered_train_steps_track_jax(arch):
    """10 steps of the smoke tiered config from converted weights on the
    reference's batches (batch 4, seq 32, lr 1e-4, write-back rate 1e-3),
    against the JAX train step with its traced write-back.  Every step's
    loss to rtol 1e-4; after the last step the store's stats (fill bytes
    aside: the reference's traced forward reads the host mirror and never
    uploads) and dirty set equal.  The table: fp32 to atol 1e-5 of the
    reference's; int8 payloads may differ where w ⊗ g's float32 rounding
    (another framework's g) flips a stochastic floor: at most 1e-4 of the
    elements, by one step, and the scales to rtol 1e-6 (on this run no
    element differs)."""
    j_cfg = j_configs.get_smoke_config(arch)
    params, state = j_tf.init(jax.random.PRNGKey(0), j_cfg)
    model = convert.model_from_jax(
        _numpy_tree(params), jax.tree.map(np.asarray, state),
        configs.get_smoke_config(arch), device="cpu")
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective,
                             seed=0)
    (_, j_store), = j_memstore.find_stores(params)
    j_store.writeback_lr = 1e-3
    j_store.warm()
    (store,) = train.bind_stores(model, 1e-3)
    j_step = j_train.build_train_step(j_cfg, j_optim.OptimConfig(lr=1e-4))
    j_opt, residual = j_optim.adam_init(params), jnp.zeros(())
    opt_state = optim.adam_init(dict(model.named_parameters()))
    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4))
    losses, j_losses = [], []
    for s in range(10):
        b = j_data.get_batch(dcfg, step=s)
        params, j_opt, state, residual, jm = j_step(
            params, j_opt, state, residual, jax.tree.map(jnp.asarray, b))
        j_losses.append(float(jm["loss"]))
        losses.append(step(opt_state, _tbatch(b))["loss"].item())
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    keys = set(j_store.stats) - {"fill_bytes"}
    assert {k: store.stats[k] for k in keys} == \
        {k: j_store.stats[k] for k in keys}
    assert store.stats["writebacks"] == 10
    assert store._dirty == j_store._dirty
    if store.quant == "none":
        np.testing.assert_allclose(store.to_dense(), j_store.to_dense(),
                                   atol=1e-5)
        return
    store.flush()
    j_store.flush()
    got = store._host.astype(np.int32)
    want = np.asarray(j_store._host).astype(np.int32)
    assert np.abs(got - want).max() <= 1
    assert np.count_nonzero(got != want) <= 1e-4 * got.size
    np.testing.assert_allclose(store._host_scale, j_store._host_scale,
                               rtol=1e-6)


def _numpy_tree(tree):
    """The reference's params with every array as numpy and every tiered
    store as the table the converter takes (read shard by shard)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, j_memstore.TieredValueStore):
        shards = range(tree.num_shards)
        payload = np.concatenate([tree.shard_host(i) for i in shards])
        if tree.quant == "none":
            return payload
        return {"q": payload, "scale": np.concatenate(
            [tree.shard_scale_host(i) for i in shards])}
    return np.asarray(tree)
