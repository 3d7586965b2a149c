"""Port parity for the product-key memory baseline (`repro_torch.core.pkm`)
and the `lram-bert-pkm` model, against the JAX package's `repro.core.pkm`
and its transformer on the same weights (converted) and inputs.

The reference computes PKM in plain JAX (no Pallas), so both sides are
plain ops: float32 sums in another order, and top-k ties resolved the
same way (equal scores: the lower index first).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as j_configs
from repro import data as j_data
from repro import optim as j_optim
from repro.core import pkm as j_pkm
from repro.launch import train as j_train
from repro.models import transformer as j_tf
from repro_torch import configs, optim
from repro_torch.core import pkm
from repro_torch.launch import convert, train
from repro_torch.optim import adam
from repro_torch.models import transformer

ARCH = "lram-bert-pkm"
BATCH, SEQ = 4, 32
SMALL = dict(n_keys=16, heads=2, key_dim=16, value_dim=24, top_k=4)


def _layer(cfg, in_dim=32, seed=0):
    """(JAX params, state as numpy, the port's layer holding them)."""
    j_cfg = j_pkm.PKMConfig(**dataclasses.asdict(cfg))
    params, state = j_pkm.pkm_init(jax.random.PRNGKey(seed), in_dim, j_cfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    layer = pkm.pkm_init(in_dim, cfg)
    flat = convert._flatten(params)
    flat.update(convert._flatten(state))
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in flat.items()})
    return j_cfg, params, state, layer


@pytest.mark.parametrize("kw", [{}, SMALL, dict(SMALL, query_norm="none")])
def test_config_matches_reference(kw):
    t, j = pkm.PKMConfig(**kw), j_pkm.PKMConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for f in ("num_locations", "half_dim", "num_params"):
        assert getattr(t, f) == getattr(j, f), f
    assert pkm.flop_count(512, 2048, t) == j_pkm.flop_count(512, 2048, j)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_lram_bert_pkm_config_matches_reference(get):
    t, j = getattr(configs, get)(ARCH), getattr(j_configs, get)(ARCH)
    for f in ("name", "num_layers", "d_model", "num_heads", "d_ff",
              "vocab_size", "pkm_layers", "lram_layers", "objective"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.pkm) == dataclasses.asdict(j.pkm)
    assert t.param_count() == j.param_count()


@pytest.mark.parametrize("query_norm", ["batch", "none"])
@pytest.mark.parametrize("train_mode", [False, True])
def test_apply_matches_reference(query_norm, train_mode):
    """Outputs to rtol 1e-5 (atol 1e-6), and in train mode the batchnorm
    running stats the reference returns."""
    cfg = pkm.PKMConfig(**SMALL, query_norm=query_norm)
    j_cfg, params, state, layer = _layer(cfg)
    x = np.random.default_rng(1).normal(size=(3, 5, 32)).astype(np.float32)
    want, j_state = j_pkm.pkm_apply(params, state, jnp.asarray(x), j_cfg,
                                    train=train_mode)
    with torch.no_grad():
        got = pkm.pkm_apply(layer, torch.from_numpy(x), train=train_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    if query_norm == "batch":
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(layer.qnorm, k).numpy(),
                np.asarray(j_state["qnorm"][k]), rtol=1e-5, atol=1e-7)


def test_gradients_match_reference():
    """d x, d query, d subkeys1/2 and d values of a random projection of
    the train-mode output against jax.grad, to rtol 1e-4 / atol 1e-5."""
    cfg = pkm.PKMConfig(**SMALL)
    j_cfg, params, state, layer = _layer(cfg)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 6, 32)).astype(np.float32)
    proj = rng.normal(size=(4, 6, cfg.value_dim)).astype(np.float32)

    def j_loss(p, xx):
        out, _ = j_pkm.pkm_apply(p, state, xx, j_cfg, train=True)
        return jnp.sum(out * proj)

    j_gp, j_gx = jax.grad(j_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (pkm.pkm_apply(layer, xt, train=True)
     * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx),
                               rtol=1e-4, atol=1e-5)
    want = convert._flatten(jax.tree.map(np.asarray, j_gp))
    got = {k: p.grad.numpy() for k, p in layer.named_parameters()}
    assert set(got) == set(want)
    for k in ("query.kernel", "subkeys1", "subkeys2", "values"):
        assert np.count_nonzero(want[k]) > 0, k
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_exact_ties_select_the_reference_indices(monkeypatch):
    """Subkey rows duplicated in pairs make every half score, and so the
    Cartesian scores, tie exactly: the port keeps the reference's
    `lax.top_k` order (the lower index first) in both selections."""
    cfg = pkm.PKMConfig(**SMALL)
    j_cfg, params, state, layer = _layer(cfg)
    for name in ("subkeys1", "subkeys2"):
        keys = params[name].copy()
        keys[:, 1::2] = keys[:, 0::2]
        params[name] = keys
        getattr(layer, name).data.copy_(torch.from_numpy(keys))
    x = np.random.default_rng(3).normal(size=(2, 7, 32)).astype(np.float32)
    out, _, (j_idx, j_w) = j_pkm.pkm_apply(
        params, state, jnp.asarray(x), j_cfg, return_access=True)
    seen = []
    bag = F.embedding_bag

    def recorded(idx, *a, **kw):
        seen.append(idx.clone())
        return bag(idx, *a, **kw)

    monkeypatch.setattr(F, "embedding_bag", recorded)
    with torch.no_grad():
        got = pkm.pkm_apply(layer, torch.from_numpy(x))
    (idx,) = seen
    want = np.asarray(j_idx).reshape(idx.shape)
    assert np.array_equal(idx.numpy(), want)
    assert len(np.unique(want)) < want.size  # ties did occur
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    j_cfg = j_configs.get_smoke_config(ARCH)
    params, state = jax.jit(j_tf.init, static_argnums=1)(
        jax.random.PRNGKey(0), j_cfg)
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective,
                             seed=0)
    batches = [j_data.get_batch(dcfg, step=s) for s in range(10)]
    return (j_cfg, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), batches)


def _model(ref):
    _, params, state, _ = ref
    return convert.model_from_jax(params, state,
                                  configs.get_smoke_config(ARCH),
                                  device="cpu")


@pytest.mark.parametrize("train_mode", [False, True])
def test_model_forward_and_loss_match(ref, train_mode):
    """`lram-bert-pkm --smoke` on converted weights: eval logits to 1e-5
    and the MLM loss to rtol 1e-5; in train mode the batchnorm stats."""
    j_cfg, params, state, batches = ref
    model = _model(ref)
    jb = jax.tree.map(jnp.asarray, batches[0])
    j_loss, (j_state, _) = j_tf.loss_fn(params, state, jb, j_cfg,
                                        train=train_mode)
    j_logits = j_tf.forward(params, state, jb, j_cfg)[0]
    batch = train.batch_to(batches[0], "cpu")
    with torch.no_grad():
        logits = transformer.forward(model, batch)
        loss, _ = transformer.loss_fn(model, batch, train=train_mode)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    bn = model.segments["seg1"].pkm.qnorm
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(j_state["seg1"]["qnorm"]["mean"]),
                               atol=1e-5)


def test_step1_gradients_match_jax(ref):
    """Every leaf's step-1 gradient against jax.grad of the reference's
    loss_fn (train mode), to rtol 1e-4 / atol 1e-5; the table's is
    sparse and nonzero."""
    j_cfg, params, state, batches = ref
    (j_loss, _), grads = jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, state, jax.tree.map(jnp.asarray,
                                                      batches[0]),
                               j_cfg, train=True), has_aux=True)(params)
    want = convert.state_dict_from_jax(jax.tree.map(np.asarray, grads), {},
                                       j_cfg)
    model = _model(ref)
    loss, _ = transformer.loss_fn(model, train.batch_to(batches[0], "cpu"),
                                  train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert 0 < np.count_nonzero(got["segments.seg1.pkm.values"].any(-1)) \
        < got["segments.seg1.pkm.values"].shape[0]


def test_ten_step_loss_curve_tracks_jax(ref):
    """10 train steps (the table at the paper's 10x lr: it is named
    `values`) from the same weights on the same batches: losses and grad
    norms within rtol 1e-4 of the reference's train step."""
    j_cfg, params, state, batches = ref
    j_step = j_train.build_train_step(j_cfg, j_optim.OptimConfig(lr=1e-4))
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = jax.tree.map(jnp.asarray, state)
    j_opt, residual = j_optim.adam_init(j_params), jnp.zeros(())
    model = _model(ref)
    assert adam.lr_mult("segments.seg1.pkm.values",
                        optim.OptimConfig()) == 10.0
    opt_state = optim.adam_init(dict(model.named_parameters()))
    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4))
    got, want = [], []
    for b in batches:
        j_params, j_opt, j_state, residual, jm = j_step(
            j_params, j_opt, j_state, residual, jax.tree.map(jnp.asarray, b))
        m = step(opt_state, train.batch_to(b, "cpu"))
        got.append((m["loss"].item(), m["grad_norm"].item()))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


def test_cli_trains_pkm_on_the_cpu(capsys):
    run = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--json",
                      "--steps", "3", "--batch", "2", "--seq", "16"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines if "step" in x] == [0, 1, 2]
    assert lines[-1]["arch"] == "lram-bert-pkm-smoke"
    assert np.isfinite([r["loss"] for r in run.records]).all()
    assert run.stores == [] and int(run.opt_state["step"]) == 3
