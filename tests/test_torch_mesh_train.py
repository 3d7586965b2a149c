"""Port parity for the mesh train path: `lram-bert-medium` (smoke) on 4
`torch.distributed` ranks (gloo on the CPU, data 2 x model 2, the memory
table row-sharded over ``model``: `--placement sharded`), against the JAX
package's single-device train step on the same weights and batches.

The reference's own mesh train step is red under jax 0.9.0 (ROADMAP C1)
and its contract is "sharded equals single-device", so the single-device
step is the oracle.  Each rank is a fresh process; the first launch drives
`build_train_step` on weights converted from the JAX init, the second the
training CLI under a torchrun-style environment.
"""

import json
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _ranks import run_ranks
from repro import configs as j_configs
from repro import data as j_data
from repro import optim as j_optim
from repro.launch import train as j_train
from repro.models import transformer as j_tf
from repro_torch.launch import convert, train

ARCH = "lram-bert-medium"
BATCH, SEQ, STEPS = 4, 32, 10
TABLE = "segments.seg1.memffn.lram.values"

STEP_CODE = textwrap.dedent("""
    import dataclasses, os, pickle
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import configs, optim
    from repro_torch.distributed import sharding
    from repro_torch.launch import convert, mesh as mesh_lib, train

    torch.set_num_threads(1)
    out_dir = os.environ["OUT"]
    mesh, device = mesh_lib.init_mesh(
        "cpu", init_method=os.environ["TEST_INIT_METHOD"])
    with open(os.path.join(out_dir, "ref.pkl"), "rb") as f:
        params, state, batches = pickle.load(f)
    cfg = configs.get_smoke_config("lram-bert-medium")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="sharded"))
    model = convert.model_from_jax(params, state, cfg, device="cpu")
    sharding.shard_params(model, mesh)
    captured = {}
    adam_update = optim.adam_update

    def capture(params, grads, *args, **kw):  # the step-1 gradients
        if not captured:
            captured.update({k: g.detach().clone()
                             for k, g in grads.items()})
        return adam_update(params, grads, *args, **kw)

    optim.adam_update = capture

    def whole_grads(model, mesh, grads):
        # a dense block's gradient (summed into the block) as its global
        # array; every other leaf's as it reached Adam
        specs = sharding.dense_blocks(model).specs
        return {k: (sharding.all_gather_block(g, mesh, specs[k])
                    if k in specs else g).numpy() for k, g in grads.items()}

    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4), mesh)
    opt_state = optim.adam_init(dict(model.named_parameters()))
    losses, stats = [], {}
    qnorm = model.segments["seg1"].memffn.lram.qnorm
    for i, b in enumerate(batches):
        m = step(opt_state, train.batch_to(b, "cpu"))
        losses.append((m["loss"].item(), m["grad_norm"].item()))
        if i == 0:
            stats = {"mean": qnorm.mean.numpy().copy(),
                     "var": qnorm.var.numpy().copy()}
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"),
             losses=np.array(losses), coords=np.array(
                 [mesh.index("data"), mesh.index("model")]),
             **{f"grad/{k}": v for k, v in whole_grads(
                 model, mesh, captured).items()},
             **{f"bn/{k}": v for k, v in stats.items()})
    dist.destroy_process_group()
""")

CLI_CODE = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    torch.set_num_threads(1)
    train.main(["--arch", "lram-bert-medium", "--smoke", "--device", "cpu",
                "--placement", "sharded", "--use-mesh", "--json",
                "--steps", "3", "--batch", "4", "--seq", "16"])
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ref():
    j_cfg = j_configs.get_smoke_config(ARCH)
    params, state = jax.jit(j_tf.init, static_argnums=1)(
        jax.random.PRNGKey(0), j_cfg)
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective,
                             seed=0)
    batches = [j_data.get_batch(dcfg, step=s) for s in range(STEPS)]
    return (j_cfg, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), batches)


@pytest.fixture(scope="module")
def jax_run(ref):
    """The single-device reference: step-1 gradients (jax.grad of the
    train-mode loss_fn), the running stats after step 1, and 10 steps'
    losses and grad norms of its train step."""
    j_cfg, params, state, batches = ref
    (_, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_tf.loss_fn(p, state, b, j_cfg, train=True),
        has_aux=True))(params, jax.tree.map(jnp.asarray, batches[0]))
    flat = convert.state_dict_from_jax(jax.tree.map(np.asarray, grads), {},
                                       j_cfg)
    j_step = j_train.build_train_step(j_cfg, j_optim.OptimConfig(lr=1e-4))
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = jax.tree.map(jnp.asarray, state)
    j_opt, residual, losses = j_optim.adam_init(j_params), jnp.zeros(()), []
    for i, b in enumerate(batches):
        j_params, j_opt, j_state, residual, jm = j_step(
            j_params, j_opt, j_state, residual, jax.tree.map(jnp.asarray, b))
        losses.append((float(jm["loss"]), float(jm["grad_norm"])))
        if i == 0:
            bn = {k: np.asarray(v)
                  for k, v in j_state["seg1"]["lram"]["qnorm"].items()}
    return {k: v.numpy() for k, v in flat.items()}, bn, np.array(losses)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    _, params, state, batches = ref
    with open(out / "ref.pkl", "wb") as f:
        pickle.dump((params, state, batches), f)
    run_ranks(STEP_CODE, 4, out, timeout=120, env={"OUT": str(out)})
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def test_ranks_form_a_data_2_by_model_2_mesh(ranks):
    """Row-major layout: rank = d * 2 + m."""
    assert [tuple(r["coords"]) for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]


def test_step1_gradients_match_single_device_jax(ranks, jax_run):
    """Every leaf's step-1 gradient, summed over the data ranks, against
    jax.grad of the single-device loss on the global batch, to rtol 1e-4 /
    atol 1e-5 (as the single-process train test holds it): the dense
    leaves on every rank (a block, summed into the rank's block, gathered
    into its global array), the table as the model ranks' shards put back
    in order (on both data rows of the mesh)."""
    j_grads, _, _ = jax_run
    for r in ranks:
        grads = {k[5:]: v for k, v in r.items() if k.startswith("grad/")}
        assert set(grads) == set(j_grads)
        for k, g in grads.items():
            if k != TABLE:
                np.testing.assert_allclose(g, j_grads[k], rtol=1e-4,
                                           atol=1e-5, err_msg=k)
    for d in (0, 1):
        table = np.concatenate([ranks[2 * d + m][f"grad/{TABLE}"]
                                for m in (0, 1)])
        np.testing.assert_allclose(table, j_grads[TABLE], rtol=1e-4,
                                   atol=1e-5)
        assert np.count_nonzero(table) > 0


def test_batchnorm_running_stats_match_single_device(ranks, jax_run):
    """The memory layer's running stats after step 1: the global batch's
    statistics on every rank, to 1e-6."""
    _, bn, _ = jax_run
    for r in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r[f"bn/{k}"], bn[k], atol=1e-6,
                                       err_msg=k)


def test_ten_step_losses_match_single_device(ranks, jax_run):
    """10 steps' losses (the global batch's) and grad norms (every table
    row counted once) on every rank, to rtol 1e-4."""
    _, _, losses = jax_run
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
    assert losses[-1][0] < losses[0][0]


def test_cli_trains_on_a_4_rank_mesh(tmp_path, capsys):
    """The training CLI under a torchrun-style environment: rank 0 alone
    prints, its first line names the backend (gloo on the CPU) and the
    mesh, and the global losses equal the single-process dense run's (the
    pallas cell, same seed and batches) to rtol 1e-5."""
    outs = run_ranks(CLI_CODE, 4, tmp_path, timeout=120)
    lines = [json.loads(x) for x in outs[0].splitlines()]
    assert lines[0]["backend"] == "gloo"
    assert lines[0]["mesh"] == {"data": 2, "model": 2}
    assert not any(o.strip() for o in outs[1:])
    steps = [x for x in lines if "step" in x]
    dense = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--placement", "pallas", "--steps", "3", "--batch",
                        "4", "--seq", "16"])
    np.testing.assert_allclose([x["loss"] for x in steps],
                               [x["loss"] for x in dense.records], rtol=1e-5)
    assert lines[-1]["mesh"] == {"data": 2, "model": 2}
