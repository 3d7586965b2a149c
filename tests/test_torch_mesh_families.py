"""The MoE and hybrid families trained on a mesh of 4 `torch.distributed`
ranks (fresh gloo processes on the CPU, data 2 x model 2), against one
process and the JAX package's single-device step.

* MoE (phi3.5-moe-42b-a6.6b smoke, float32, with the memory FFN,
  `with_lram(..., 16)` on `pallas`): on a mesh each data rank routes its
  slice of the global batch, and the Switch router loss is taken over the
  global batch (`models.moe.router_loss`: the top-1 counts and the token
  count summed over the batch axes), as GSPMD takes the reference's.  Per
  step `loss`, `xent` and `aux` equal the one-process run's to rtol 1e-5
  (a router loss per rank, summed by the step, would be 2x), and step 1's
  gradients, summed over the data ranks, the JAX package's `jax.grad` of
  the single-device loss (rtol 1e-4 / atol 1e-5, as the mesh train test
  holds them).  The reference's own mesh step is red under jax 0.9.0
  (ROADMAP C1), so it cannot serve as the oracle.  `train=False` (the
  evaluation, every rank on the whole batch) reduces nothing: its loss
  and router loss under the mesh equal the same rank's without one, bit
  for bit; one process computes the router loss as before, bit for bit.
* Hybrid (zamba2-2.7b smoke, no memory layer): `sharding.param_specs`
  gives the reference's `param_pspecs` for the units' Mamba leaves (two
  stacked axes) and the shared block; the training CLI on the mesh gives
  the one-process losses to rtol 1e-5, and its checkpoint restores on one
  process (elastically), whose next steps give the straight run's.

Each 4-rank code string runs once, from a module fixture.
"""

import json
import math
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import pair
from _ranks import run_ranks
from repro import configs as j_configs
from repro import data as j_data
from repro.distributed import context as j_context
from repro.distributed import sharding as j_sharding
from repro.models import transformer as j_tf
from repro_torch import configs, optim
from repro_torch.distributed import collectives, context, sharding
from repro_torch.launch import convert, train
from repro_torch.models import moe, transformer

MOE = "phi3.5-moe-42b-a6.6b"
HYBRID = "zamba2-2.7b"
BATCH, SEQ, STEPS = 4, 16, 3
RTOL = 1e-5

MOE_CODE = textwrap.dedent("""
    import os, pickle
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.distributed import collectives, context, sharding
    from repro_torch.launch import convert, mesh as mesh_lib, train
    from repro_torch.models import transformer

    torch.set_num_threads(1)
    out_dir = os.environ["OUT"]
    mesh, device = mesh_lib.init_mesh(
        "cpu", init_method=os.environ["TEST_INIT_METHOD"])
    with open(os.path.join(out_dir, "ref.pkl"), "rb") as f:
        params, state, batches, cfg = pickle.load(f)
    model = convert.model_from_jax(params, state, cfg, device="cpu")
    sharding.shard_params(model, mesh)
    # evaluation: every rank on the whole batch, under the mesh and not
    whole = train.batch_to(batches[0], "cpu")
    evals = []
    with torch.no_grad(), sharding.gathered(model):
        for ambient in (mesh, None):
            context.set_mesh(ambient)
            loss, met = transformer.loss_fn(model, whole, train=False)
            evals.append([loss.item(), met["aux"].item()])
    context.set_mesh(mesh)
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
    metrics = []
    for b in batches:
        m = step(opt_state, train.batch_to(b, "cpu"))
        metrics.append([m[k].item() for k in ("loss", "xent", "aux")])
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"),
             metrics=np.array(metrics), evals=np.array(evals),
             **{f"grad/{k}": v for k, v in whole_grads(
                 model, mesh, captured).items()})
    dist.destroy_process_group()
""")

HYBRID_ARGS = ["--arch", HYBRID, "--smoke", "--device", "cpu", "--json",
               "--batch", str(BATCH), "--seq", str(SEQ)]

HYBRID_CODE = textwrap.dedent(f"""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    torch.set_num_threads(1)
    train.main({HYBRID_ARGS!r} + ["--use-mesh", "--steps", "4",
               "--ckpt-dir", os.environ["CKPT"], "--ckpt-every", "2"])
    dist.destroy_process_group()
""")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_ref():
    """The JAX package's smoke MoE in float32 with the memory FFN: (JAX
    cfg, numpy params and state, the batches, the port's cfg on
    `pallas`)."""
    j_cfg, params, state, cfg = pair(MOE, "float32")
    dcfg = j_data.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=cfg.objective,
                             seed=0)
    batches = [j_data.get_batch(dcfg, step=s) for s in range(STEPS)]
    return (j_cfg, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state), batches, cfg)


@pytest.fixture(scope="module")
def moe_ranks(moe_ref, tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_mesh")
    _, params, state, batches, cfg = moe_ref
    with open(out / "ref.pkl", "wb") as f:
        pickle.dump((params, state, batches, cfg), f)
    run_ranks(MOE_CODE, 4, out, timeout=120, env={"OUT": str(out)})
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def moe_one_process(moe_ref):
    """(loss, xent, aux) a step of the same weights and batches on one
    process."""
    _, params, state, batches, cfg = moe_ref
    model = convert.model_from_jax(params, state, cfg, device="cpu")
    step = train.build_train_step(model, optim.OptimConfig(lr=1e-4))
    opt_state = optim.adam_init(dict(model.named_parameters()))
    out = []
    for b in batches:
        m = step(opt_state, train.batch_to(b, "cpu"))
        out.append([m[k].item() for k in ("loss", "xent", "aux")])
    return np.array(out)


def test_moe_losses_on_the_mesh_match_one_process(moe_ranks,
                                                  moe_one_process):
    """Every rank's per-step loss, xent and aux (the global batch's)
    against one process, to rtol 1e-5; the router loss is not zero."""
    want = moe_one_process
    assert (want[:, 2] > 0).all()
    for r in moe_ranks:
        np.testing.assert_allclose(r["metrics"], want, rtol=RTOL)


def test_moe_step1_gradients_match_single_device_jax(moe_ref, moe_ranks):
    """Step 1's gradients on every rank (summed over the data ranks; a
    dense block's gathered into its global array) against jax.grad of
    the single-device train-mode loss on the global batch, every leaf, to
    rtol 1e-4 / atol 1e-5: the router's included, which the router
    loss's global means shape."""
    j_cfg, params, state, batches, cfg = moe_ref
    _, grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_tf.loss_fn(p, state, b, j_cfg, train=True),
        has_aux=True))(params, jax.tree.map(jnp.asarray, batches[0]))
    want = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        jax.tree.map(np.asarray, grads), {}, cfg).items()}
    for r in moe_ranks:
        got = {k[5:]: v for k, v in r.items() if k.startswith("grad/")}
        assert set(got) == set(want)
        for k, g in got.items():
            np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert any("router" in k for k in want)


def test_moe_evaluation_on_the_mesh_reduces_nothing(moe_ranks):
    """`loss_fn(train=False)` on the whole batch: under the mesh the loss
    and the router loss are the rank's own, bit for bit."""
    for r in moe_ranks:
        on_mesh, alone = r["evals"]
        assert on_mesh.tolist() == alone.tolist()
        assert alone[1] > 0


def test_router_loss_on_one_process_is_unchanged():
    """Without a mesh (or with `train=False`) the router loss is E x
    sum(mean(probs) x mean(onehot(top-1))) as before, bit for bit."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((3, 7, 8), np.float32))
    probs = torch.softmax(logits, -1)
    top1 = probs.argmax(-1)
    onehot = torch.nn.functional.one_hot(top1, 8).float()
    want = 8 * torch.sum(probs.mean(dim=(0, 1)) * onehot.mean(dim=(0, 1)))
    for train_mode in (False, True):
        got = moe.router_loss(probs, top1, 8, train=train_mode)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


def test_flat_all_reduce_keeps_dtypes_in_bounded_buckets(monkeypatch):
    """`collectives.all_reduce_flat_` on a bf16 model's mix of gradients:
    one all-reduce a flat buffer of one dtype (never promoted), each
    buffer at most FLAT_BUCKET_BYTES, a tensor that large summed where it
    lies; every tensor gets its sum (here: two alike ranks, 2x)."""
    calls = []

    def doubled(t, group):
        calls.append((t.dtype, t.numel() * t.element_size(),
                      t.data_ptr()))
        return t.mul_(2)

    monkeypatch.setattr(collectives, "_trivial", lambda group: False)
    monkeypatch.setattr(collectives.dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(collectives, "all_reduce_", doubled)
    monkeypatch.setattr(collectives, "FLAT_BUCKET_BYTES", 64)
    rng = np.random.default_rng(0)
    dtypes = [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32,
              torch.bfloat16, torch.float32]
    sizes = [3, 40, 5, 7, 2, 17]
    ts = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
          .to(d) for n, d in zip(sizes, dtypes)]
    want = [2 * t for t in ts]
    big = {ts[1].data_ptr(), ts[5].data_ptr()}  # 80 and 68 bytes
    collectives.all_reduce_flat_(ts, object())
    for t, w, d in zip(ts, want, dtypes):
        assert t.dtype == d and torch.equal(t, w)
    assert all(nbytes <= 64 or ptr in big for _, nbytes, ptr in calls)
    assert [(d, n) for d, n, _ in calls] == [
        (torch.float32, 68), (torch.float32, 40), (torch.bfloat16, 80),
        (torch.bfloat16, 14)]


SUM_CODE = textwrap.dedent("""
    import os
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    dist.init_process_group("gloo", init_method=os.environ["TEST_INIT_METHOD"],
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    r = dist.get_rank()
    bits = np.load(os.path.join(os.environ["OUT"], "bits.npy"))
    groups = {2: dist.new_group([0, 1]), 4: dist.group.WORLD}
    out = {}
    for ranks, group in groups.items():
        if r < ranks:
            t = torch.from_numpy(bits[r].view(np.int16)).view(
                torch.bfloat16).clone()
            wire = t.clone()
            collectives.all_reduce_flat_([t, torch.ones(3)], group)
            dist.all_reduce(wire, group=group)
            out[f"flat{ranks}"] = t.view(torch.int16).numpy()
            out[f"wire{ranks}"] = wire.view(torch.int16).numpy()
    np.savez(os.path.join(os.environ["OUT"], f"rank{r}.npz"), **out)
    dist.destroy_process_group()
""")

GSPMD_SUM_CODE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    bits = np.load(sys.argv[1] if len(sys.argv) > 1 else "{path}")
    x = bits.view(jnp.bfloat16)
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
        xs = jax.device_put(x[:n], NamedSharding(mesh, P("data")))
        total = jax.jit(lambda a: a.sum(0),
                        out_shardings=NamedSharding(mesh, P()))(xs)
        np.save("{out}" + f"/gspmd{{n}}.npy",
                np.asarray(total).view(np.uint16))
""")


def test_bf16_gradient_sum_rounds_once_as_the_reference(tmp_path):
    """`all_reduce_flat_` of bfloat16 gradients over 2 and 4 gloo ranks
    gives the exact sum rounded once, bit for bit what the reference's
    partitioner gives for a bfloat16 sum over 2 and 4 devices (float32 on
    the wire, rounded once); over 4 ranks a bfloat16 all-reduce on the
    wire, rounding once a rank added, would not (asserted, so that the
    case is seen).  The values span 2^-4..2^4, so that float32 sums them
    exactly in any order."""
    from conftest import run_in_subprocess

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 4096))
         * np.exp2(rng.integers(-4, 4, (4, 4096)))).astype(jnp.bfloat16)
    np.save(tmp_path / "bits.npy", x.view(np.uint16))
    exact = {n: x[:n].astype(np.float32).sum(0).astype(jnp.bfloat16)
             .view(np.uint16) for n in (2, 4)}
    run_in_subprocess(GSPMD_SUM_CODE.format(path=tmp_path / "bits.npy",
                                            out=tmp_path), devices=4)
    run_ranks(SUM_CODE, 4, tmp_path, timeout=60, env={"OUT": str(tmp_path)})
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for n in (2, 4):
        gspmd = np.load(tmp_path / f"gspmd{n}.npy")
        np.testing.assert_array_equal(gspmd, exact[n])
        for r in ranks[:n]:
            np.testing.assert_array_equal(r[f"flat{n}"].view(np.uint16),
                                          exact[n])
    np.testing.assert_array_equal(ranks[0]["wire2"].view(np.uint16),
                                  exact[2])
    assert not np.array_equal(ranks[0]["wire4"].view(np.uint16), exact[4])


# ---------------------------------------------------------------------------
# hybrid
# ---------------------------------------------------------------------------

class DuckMesh:
    """A mesh's axes and sizes, without processes: what `param_specs`
    and the reference's `param_pspecs` read."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


@pytest.mark.parametrize("shape,axes", [
    ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
    ((2, 1, 2), ("pod", "data", "model"))], ids=["2x2", "1x4", "2x1x2"])
def test_hybrid_param_specs_match_reference(shape, axes):
    """Every leaf's spec equals the reference's `param_pspecs`, a unit's
    Mamba leaves without their two stacked axes' leading Nones, the
    shared block's as they are."""
    j_cfg = j_configs.get_smoke_config(HYBRID)
    cfg = configs.get_smoke_config(HYBRID)
    mesh = DuckMesh(shape, axes)
    j_context.set_mesh(mesh)
    context.set_mesh(mesh)
    try:
        shapes = jax.eval_shape(lambda k: j_tf.init(k, j_cfg),
                                jax.random.PRNGKey(0))[0]
        ref = j_sharding.param_pspecs(shapes, mesh, model_cfg=j_cfg)
        mine = sharding.param_specs(transformer.init(cfg, seed=0), mesh)
    finally:
        j_context.set_mesh(None)
        context.set_mesh(None)
    ref = {"params/" + "/".join(str(getattr(p, "key", p)) for p in path):
           tuple(spec) for path, spec in jax.tree_util.tree_flatten_with_path(
               ref, is_leaf=lambda x: isinstance(
                   x, jax.sharding.PartitionSpec))[0]}
    kinds = set()
    for key, spec in mine.items():
        path, index = convert.reference_path(key, cfg)
        want = ref[path]
        lead = 0 if index is None else (
            2 if isinstance(index, tuple) else 1)
        if want:
            assert want[:lead] == (None,) * lead, (key, want)
            want = want[lead:]
        assert spec == want, key
        kinds.add((lead, bool(spec)))
    # two-axis Mamba leaves and shared-block leaves, some of each split
    assert (2, True) in kinds and (0, True) in kinds
    split = {k: s for k, s in mine.items() if s}
    assert any(k.startswith("shared_attn.") for k in split)
    assert any(".mamba.in_proj." in k for k in split)


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    """(the 4-rank run's records from rank 0's lines, a straight
    one-process run of 6 steps, the one-process run resumed from the
    mesh's step-4 checkpoint, rank 0's first line)."""
    out = tmp_path_factory.mktemp("hybrid_mesh")
    ckpt = out / "ckpt"
    outs = run_ranks(HYBRID_CODE, 4, out, timeout=120,
                     env={"CKPT": str(ckpt)})
    lines = [json.loads(x) for x in outs[0].splitlines()
             if x.startswith("{")]
    assert not any(o.strip() for o in outs[1:])
    mesh = [x for x in lines if "step" in x and "loss" in x]
    straight = train.main(HYBRID_ARGS + ["--steps", "6"])
    resumed = train.main(HYBRID_ARGS + ["--steps", "6", "--ckpt-dir",
                                        str(ckpt)])
    return mesh, straight, resumed, lines[0]


def test_hybrid_mesh_losses_match_one_process(hybrid_runs):
    """The CLI on data 2 x model 2: the global losses and grad norms of
    its 4 steps against one process's, to rtol 1e-5."""
    mesh, straight, _, first = hybrid_runs
    assert first["mesh"] == {"data": 2, "model": 2}
    assert [r["step"] for r in mesh] == [0, 1, 2, 3]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in mesh],
                                   [r[key] for r in straight.records[:4]],
                                   rtol=RTOL, err_msg=key)


def test_hybrid_mesh_checkpoint_restores_on_one_process(hybrid_runs):
    """The mesh's step-4 checkpoint restores into one process (the split
    leaves gathered on save, whole on restore); its steps 4-5 give the
    straight run's losses to rtol 1e-5."""
    _, straight, resumed, _ = hybrid_runs
    assert resumed.start_step == 4
    assert [r["step"] for r in resumed.records] == [4, 5]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in resumed.records],
                                   [r[key] for r in straight.records[4:]],
                                   rtol=RTOL, err_msg=key)
    assert all(math.isfinite(r["loss"]) for r in resumed.records)
