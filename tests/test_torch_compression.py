"""Port parity for gradient compression (`repro_torch.optim.compression`,
`quant.int8_qdq`, `distributed.collectives.compressed_psum`) against the
JAX package: the codecs over 3 steps of error feedback, the common-scale
int8 sum on 4 ranks (the reference's on 4 fake JAX devices), and 5
training steps with `--compression int8` / `topk`, on one process and on
4 `torch.distributed` ranks (data 2 x model 2, the table row-sharded over
``model``: the codec sees its global array), against the JAX package's
single-device step with the same codec."""

import dataclasses
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ranks import run_ranks
from conftest import run_in_subprocess
from repro import configs as j_configs
from repro import data as j_data
from repro import optim as j_optim
from repro import quant as j_quant
from repro.launch import train as j_train
from repro.models import transformer as j_tf
from repro_torch import configs, optim, quant
from repro_torch.launch import convert, train

ARCH = "lram-bert-medium"
BATCH, SEQ, STEPS = 4, 32, 5
KINDS = ("int8", "topk")


def test_int8_qdq_matches_reference(rng):
    """One scale a tensor, round half to even, clip at +-127: bit-equal to
    the reference's `int8_qdq`, zeros included."""
    for shape in [(7,), (33, 5), (4, 8, 16)]:
        x = (rng.normal(size=shape) * rng.uniform(1e-3, 10)).astype(
            np.float32)
        want = np.asarray(j_quant.int8_qdq(jnp.asarray(x)))
        got = quant.int8_qdq(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
    zero = np.zeros((3, 3), np.float32)
    np.testing.assert_array_equal(
        quant.int8_qdq(torch.from_numpy(zero)).numpy(),
        np.asarray(j_quant.int8_qdq(jnp.asarray(zero))))


@pytest.mark.parametrize("kind", KINDS)
def test_compress_gradients_matches_reference(rng, kind):
    """Three steps of error feedback over a tree of leaves (a scalar-like
    leaf, a vector, matrices): the gradients as sent and the residuals
    equal the reference's `compress_gradients` (rho 0.01) to 1e-6."""
    shapes = {"a": (1,), "b": (300,), "c": (64, 48), "d": (128, 8)}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    j_state = j_optim.compression_init(
        {k: jnp.asarray(v) for k, v in params.items()}, kind)
    state = optim.compression_init(
        {k: torch.from_numpy(v) for k, v in params.items()}, kind)
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        j_sent, j_state = j_optim.compress_gradients(
            {k: jnp.asarray(v) for k, v in grads.items()}, j_state)
        sent, state = optim.compress_gradients(
            {k: torch.from_numpy(v) for k, v in grads.items()}, state)
        for k in shapes:
            np.testing.assert_allclose(sent[k].numpy(),
                                       np.asarray(j_sent[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_allclose(
                state["residual"][k].numpy(),
                np.asarray(j_state["residual"][k]), rtol=1e-6, atol=1e-7,
                err_msg=k)
    if kind == "topk":  # 1% of 300 entries: 3 sent, the rest fed back
        assert np.count_nonzero(sent["b"].numpy()) == 3


def test_compression_init_and_refusals():
    """"none" carries no residual and passes the gradients through; an
    unknown codec raises."""
    g = {"w": torch.ones(3)}
    state = optim.compression_init(g, "none")
    assert state["residual"] is None
    assert optim.compress_gradients(g, state)[0] is g
    with pytest.raises(ValueError, match="unknown compression"):
        optim.compression_init(g, "fp4")


@pytest.fixture(scope="module")
def ref():
    """The JAX init, the batches, and the single-device step's losses and
    grad norms with each codec."""
    j_cfg = j_configs.get_smoke_config(ARCH)
    params, state = jax.tree.map(np.asarray, jax.jit(
        j_tf.init, static_argnums=1)(jax.random.PRNGKey(0), j_cfg))
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective,
                             seed=0)
    batches = [j_data.get_batch(dcfg, step=s) for s in range(STEPS)]
    losses = {}
    for kind in KINDS:
        step = j_train.build_train_step(
            j_cfg, j_optim.OptimConfig(lr=1e-4), compression=kind)
        p = jax.tree.map(jnp.asarray, params)  # the step donates them
        s = jax.tree.map(jnp.asarray, state)
        opt = j_optim.adam_init(p)
        residual = j_optim.compression_init(p, kind)["residual"]
        out = []
        for b in batches:
            p, opt, s, residual, m = step(p, opt, s, residual,
                                          jax.tree.map(jnp.asarray, b))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        losses[kind] = np.array(out)
    return params, state, batches, losses


@pytest.mark.parametrize("kind", KINDS)
def test_single_process_training_matches_jax(ref, kind):
    """5 steps of `build_train_step(..., compression=kind)` on one process
    (the dense pallas cell's plain versions) against the JAX step with
    the same codec: losses and grad norms to rtol 1e-4."""
    params, state, batches, losses = ref
    cfg = configs.get_smoke_config(ARCH)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    model = convert.model_from_jax(params, state, cfg, device="cpu")
    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4),
                                  compression=kind)
    opt = optim.adam_init(dict(model.named_parameters()))
    got = []
    for b in batches:
        m = step(opt, train.batch_to(b, "cpu"))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    np.testing.assert_allclose(np.array(got), losses[kind], rtol=1e-4)


RANK_CODE = textwrap.dedent("""
    import dataclasses, os, pickle
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import configs, optim
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import convert, mesh as mesh_lib, train

    torch.set_num_threads(1)
    out_dir = os.environ["OUT"]
    mesh, _ = mesh_lib.init_mesh(
        "cpu", init_method=os.environ["TEST_INIT_METHOD"])
    rank = dist.get_rank()
    with open(os.path.join(out_dir, "ref.pkl"), "rb") as f:
        params, state, batches = pickle.load(f)
    cfg = configs.get_smoke_config("lram-bert-medium")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="sharded"))
    compress, captured = optim.compress_gradients, []

    def capture(grads, comp_state, **kw):  # steps 1 and 2, as coded
        sent, new = compress(grads, comp_state, **kw)
        captured.append((grads, comp_state, sent))
        return sent, new

    optim.compress_gradients = capture
    res = {}
    for kind in ("int8", "topk"):
        captured.clear()
        model = convert.model_from_jax(params, state, cfg, device="cpu")
        sharding.shard_params(model, mesh)
        step = train.build_train_step(model, optim.OptimConfig(lr=1e-4),
                                      mesh, kind)
        opt = optim.adam_init(dict(model.named_parameters()))
        res[kind] = np.array([
            [m["loss"].item(), m["grad_norm"].item()] for m in (
                step(opt, train.batch_to(b, "cpu")) for b in batches)])
        # step 2 (a residual fed back): the residual in the blocks'
        # shapes, and each dense block coded as the whole leaf's code of
        # the same summed gradient and residual codes it
        grads, comp_state, sent = captured[1]
        res[kind + "_residual_shapes"] = all(
            tuple(comp_state["residual"][k].shape) == tuple(p.shape)
            for k, p in model.named_parameters())
        specs, err = sharding.dense_blocks(model).specs, 0.0
        for k, spec in specs.items():
            g, r, got = (sharding.all_gather_block(t, mesh, spec) for t in (
                grads[k], comp_state["residual"][k], sent[k]))
            want, _ = compress({k: g}, dict(comp_state, residual={k: r}))
            err = max(err, (want[k] - got).abs().max().item())
        res[kind + "_whole_leaf_err"] = err
        res[kind + "_split_leaves"] = len(specs)
    x = np.load(os.path.join(out_dir, "psum_x.npy"))
    res["psum"] = collectives.compressed_psum(
        torch.from_numpy(x[2 * rank:2 * rank + 2]),
        mesh.group(("data", "model"))).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
""")

PSUM_CODE = textwrap.dedent("""
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed._compat import shard_map
    from repro.distributed.collectives import compressed_psum

    mesh = jax.make_mesh((4,), ("data",))
    x = np.load("PATH/psum_x.npy")
    out = shard_map(lambda xl: compressed_psum(xl, "data"), mesh=mesh,
                    in_specs=(P("data", None),), out_specs=P(None))(x)
    np.save("PATH/psum_ref.npy", np.asarray(out))
""")


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    out = tmp_path_factory.mktemp("compression")
    params, state, batches, _ = ref
    with open(out / "ref.pkl", "wb") as f:
        pickle.dump((params, state, batches), f)
    x = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    np.save(out / "psum_x.npy", x)
    run_in_subprocess(PSUM_CODE.replace("PATH", str(out)), devices=4)
    run_ranks(RANK_CODE, 4, out, timeout=180, env={"OUT": str(out)})
    return ([dict(np.load(out / f"rank{r}.npz")) for r in range(4)],
            np.load(out / "psum_ref.npy"), x)


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_training_matches_jax(ref, ranks, kind):
    """5 steps on data 2 x model 2 with the table row-sharded over model
    (its int8 scale the maximum over model, top-k's threshold the k-th
    largest of the global gradient) against the JAX single-device step
    with the same codec, on every rank: rtol 1e-4.  The residual has the
    shapes of the rank's blocks and rows, and at step 2 every dense
    block's code equals the whole leaf's code of the same summed
    gradient and residual, gathered (0 apart)."""
    losses = ref[3][kind]
    for r in ranks[0]:
        np.testing.assert_allclose(r[kind], losses, rtol=1e-4)
        assert bool(r[kind + "_residual_shapes"])
        assert int(r[kind + "_split_leaves"]) >= 15
        assert float(r[kind + "_whole_leaf_err"]) == 0.0


def test_compressed_psum_matches_reference(ranks):
    """The common-scale int8 sum over 4 ranks (each its 2 rows of an (8,
    64) array) equals the reference's `compressed_psum` over 4 fake JAX
    devices on every rank, and is within 4 half-steps of the exact sum."""
    per_rank, want, x = ranks
    exact = x.reshape(4, 2, 64).sum(0)
    scale = np.abs(x).max() / 127.0
    for r in per_rank:
        np.testing.assert_allclose(r["psum"], want, rtol=1e-6, atol=1e-6)
        assert np.abs(r["psum"] - exact).max() <= 4 * scale / 2 + 1e-6
