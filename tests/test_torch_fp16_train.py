"""Float16 training and the product-key memory (PKM) in a 2-byte model,
against the JAX package.

Training: one Adam step of qwen2-1.5b's float16 smoke config with the
paper's memory FFN, from the reference's weights on its batch, against
the reference's loss and gradients (float16 tables train in
`test_torch_fp16.py`).

The PKM.  Both packages sum a 2-byte PKM's rows in float32 and cast
the output.  Its table's gradient differs in order: the reference rounds
the float32 cotangent of each row to the table's dtype and scatter-adds
in that dtype, the port sums in float32 and rounds once.  An element of
d values is a sum of d contributions (d at most `d_max`, the largest
number of (token, head, k) that name one row): the reference's rounded
sum is within d_max x u x S of the exact one (u the dtype's unit
roundoff, S the sum of the contributions' magnitudes: one rounding of
each contribution and one per add), the port's within u x S and the
float32 sum's error, so the two are within 2 x (d_max + 1) x u x S.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import f32, model, pair
from repro import configs as j_configs
from repro import data as j_data
from repro import optim as j_optim
from repro.core import pkm as j_pkm
from repro.models import transformer as j_tf
from repro_torch import configs, optim
from repro_torch.core import pkm
from repro_torch.launch import convert, train
from repro_torch.models import transformer

F16 = "float16"
KEY = jax.random.PRNGKey(0)
U = {"bfloat16": 2.0**-8, "float16": 2.0**-11}  # unit roundoff


def test_fp16_train_step_matches_reference():
    """One Adam step of qwen2-1.5b's float16 smoke config with the memory
    FFN (2^16 rows, the `pallas` cell) from the converted weights on the
    reference's batch (2 x 16 tokens), against the reference's loss and
    gradients (`jax.value_and_grad` of its `loss_fn`, compiled: its
    gradients here agree with its op-by-op run's to the bound below):
    the loss and the grad norm within 2^-11 x (layers + 1) x the
    reference's value, and every leaf's gradient within 2^-11 x (layers
    + 1) x the leaf's largest |g_ref| (the forward's bound, leaf by leaf:
    the two runs' gradients part by a few float16 roundings at the leaf's
    own scale, so an element that cancels to near 0 is held at that
    scale, not at its own); the float16 leaves stay float16 and move,
    Adam's moments are float32."""
    j_cfg, params, state, cfg = pair("qwen2-1.5b", F16)
    m = model(cfg, params, state).train()
    start = {k: v.detach().clone() for k, v in m.named_parameters()}
    dcfg = j_data.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                             global_batch=2, objective=cfg.objective, seed=0)
    b = j_data.get_batch(dcfg, step=0)
    jb = jax.tree.map(jnp.asarray, b)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, state, jb, j_cfg, train=True),
        has_aux=True))(params)
    want_norm = float(j_optim.global_norm(j_grads))
    grads, adam_update = {}, optim.adam_update

    def keeping(params_, grads_, *args, **kw):
        grads.update({k: v.detach().clone() for k, v in grads_.items()})
        return adam_update(params_, grads_, *args, **kw)

    opt_state = optim.adam_init(dict(m.named_parameters()))
    step = train.build_train_step(m, optim.OptimConfig(lr=1e-3))
    optim.adam_update = keeping
    try:
        out = step(opt_state, train.batch_to(b, "cpu"))
    finally:
        optim.adam_update = adam_update
    rel = U[F16] * (cfg.num_layers + 1)
    for got, want in ((out["loss"].item(), float(j_loss)),
                      (out["grad_norm"].item(), want_norm)):
        assert abs(got - want) <= rel * abs(want), (got, want)
    want = convert.state_dict_from_jax(jax.tree.map(np.asarray, j_grads),
                                       {}, cfg)
    assert set(grads) == set(want)
    for k, g in grads.items():
        jg = want[k].float().numpy()
        assert g.dtype == start[k].dtype, k
        err = np.abs(g.float().numpy() - jg).max()
        assert err <= rel * np.abs(jg).max(), (k, err)
    for k, p in m.named_parameters():
        assert p.dtype == start[k].dtype, k
        assert opt_state["mu"][k].dtype == torch.float32, k
    assert m.embed.embedding.dtype == torch.float16
    assert not torch.equal(m.embed.embedding, start["embed.embedding"])


# ---------------------------------------------------------------------------
# the PKM in a bfloat16 or float16 model
# ---------------------------------------------------------------------------

def _pkm_cfgs(dtype):
    """lram-bert-pkm's smoke config in `dtype`, port and JAX."""
    return (dataclasses.replace(configs.get_smoke_config("lram-bert-pkm"),
                                dtype=dtype),
            j_configs.get_smoke_config("lram-bert-pkm", dtype=dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", F16])
def test_pkm_model_forward_matches_reference(dtype):
    """lram-bert-pkm's smoke model in a 2-byte dtype (every PKM leaf in
    it, the running stats float32): the logits of a (2, 16) batch
    against the reference's forward run op by op, within one rounding of
    the dtype x (layers + 1) x the largest logit."""
    cfg, j_cfg = _pkm_cfgs(dtype)
    params, state = j_tf.init(KEY, j_cfg)
    m = model(cfg, params, state)
    (layer,) = [x for x in m.modules() if isinstance(x, pkm.PKM)]
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float16
    assert all(p.dtype == want for p in layer.parameters())
    assert layer.qnorm.mean.dtype == torch.float32
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    with jax.disable_jit():
        jl = j_tf.forward(params, state, {"tokens": jnp.asarray(toks)},
                          j_cfg)[0]
    with torch.no_grad():
        tl = transformer.forward(m, {"tokens": torch.from_numpy(toks)})
    jl = f32(jl)
    err = np.abs(tl.float().numpy() - jl).max()
    assert err <= U[dtype] * (cfg.num_layers + 1) * np.abs(jl).max(), err


@pytest.mark.parametrize("dtype", ["bfloat16", F16])
def test_pkm_layer_gradients_match_reference(dtype):
    """The PKM layer of lram-bert-pkm's smoke config in a 2-byte dtype, on
    the same weights and a (4, 32) input in that dtype, train mode, under
    a fixed float32 cotangent: the output within one rounding of the
    dtype x its largest magnitude; d values in the table's dtype within
    2 x (d_max + 1) x u x S of the reference's (the module's bound: S the
    summed magnitudes of each element's contributions w (x) g, d_max the
    most contributions any row took); d x and d of the query projection
    within 8 u x their largest magnitude (a few roundings in the dtype
    along the query's chain: the projection, the batchnorm's output, the
    cast to float32 and back)."""
    cfg, j_cfg = _pkm_cfgs(dtype)
    pcfg = cfg.pkm
    u = U[dtype]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float16
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float16
    params, state = j_pkm.pkm_init(KEY, cfg.d_model, j_cfg.pkm, dtype=jdt)
    layer = pkm.pkm_init(cfg.d_model, pcfg, dtype=tdt)
    flat = {"query.kernel": params["query"]["kernel"],
            "query.bias": params["query"]["bias"],
            "subkeys1": params["subkeys1"], "subkeys2": params["subkeys2"],
            "values": params["values"],
            "qnorm.scale": params["qnorm"]["scale"],
            "qnorm.bias": params["qnorm"]["bias"],
            "qnorm.mean": state["qnorm"]["mean"],
            "qnorm.var": state["qnorm"]["var"]}
    layer.load_state_dict({k: convert.tensor_from_numpy(np.asarray(v))
                           for k, v in flat.items()})
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=(4, 32, pcfg.value_dim)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)

    def j_loss(p, xx):
        y, _, (idx, w) = j_pkm.pkm_apply(p, state, xx, j_cfg.pkm,
                                         train=True, return_access=True)
        return jnp.sum(y.astype(jnp.float32) * g), (y, idx, w)

    (_, (jy, jidx, jw)), (jgp, jgx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jx)
    xt = convert.tensor_from_numpy(np.asarray(jx)).requires_grad_()
    y = pkm.pkm_apply(layer, xt, train=True)
    (y.float() * torch.from_numpy(g)).sum().backward()
    jy = f32(jy)
    assert y.dtype == tdt
    assert np.abs(y.detach().float().numpy() - jy).max() <= \
        u * np.abs(jy).max()
    # the bound on d values from the reference's own access
    idx = np.asarray(jidx).reshape(-1)
    wg = (np.asarray(jw, np.float32)[..., None]
          * g[..., None, None, :]).reshape(-1, pcfg.value_dim)
    counts = np.bincount(idx, minlength=pcfg.num_locations)
    d_max = int(counts.max())
    assert d_max > 1  # duplicates: the bound is not a single rounding
    mag = np.zeros((pcfg.num_locations, pcfg.value_dim), np.float32)
    np.add.at(mag, idx, np.abs(wg))
    bound = 2 * (d_max + 1) * u * mag + 1e-30
    gv = layer.values.grad
    assert gv.dtype == tdt
    err = np.abs(gv.float().numpy() - f32(jgp["values"]))
    assert np.all(err <= bound), float((err / bound).max())
    for got, want in ((xt.grad, jgx),
                      (layer.query.kernel.grad, jgp["query"]["kernel"])):
        want = f32(want)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=8 * u * np.abs(want).max())
