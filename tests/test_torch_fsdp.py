"""Port parity for the dense weights' placement on a mesh: GSPMD's FSDP x
TP rules (`distributed.sharding.param_specs`), each rank's block, and
training on the blocks, against the JAX package.

* `param_specs` against the reference's `param_pspecs` for every leaf of
  the smoke `lram-bert-medium` (pallas and sharded tables) and
  `lram-bert-pkm` configs on data x model meshes (2, 2), (1, 4), (4, 1),
  (3, 2) (data 3 divides no dim: the rules fall back) and the multi-pod
  (2, 1, 2), in process (the reference reads a duck mesh's `shape` and
  `axis_names`);
* each rank's block against the slice `NamedSharding.devices_indices_map`
  gives its device (4 fake JAX devices, a subprocess);
* 4 `torch.distributed` ranks (fresh gloo processes) train on weights
  converted from the JAX init, `--placement pallas` on data 2 x model 2
  and `--placement sharded` on the pod mesh pod 2 x data 1 x model 2,
  against the JAX package's single-device train step (the reference's
  mesh step is red under jax 0.9.0, ROADMAP C1, and its contract is
  "sharded equals single-device"): losses, grad norms and the trained
  blocks.  Between steps each rank holds only its blocks and their
  moments, and a forward outside `sharding.gathered` raises.  A
  recorder on the gather and release of every unit shows that no rank
  ever holds more than one unit's whole leaves (plus a shared unit) in
  a forward, a backward or an eval, and the gradients reach Adam as
  blocks; the 2 x 2 launch also trains the same model with a tied
  embedding (the head reads the shared embedding unit) against the JAX
  step.  The 2 x 2 run's checkpoint restores onto the pod mesh (each
  rank its block of the global arrays), and the training CLI trains on
  the pod mesh (`--mesh-shape 2x1x2`) as one process does.
"""

import dataclasses
import json
import math
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _ranks import run_ranks
from conftest import run_in_subprocess
from repro import configs as j_configs
from repro import data as j_data
from repro import optim as j_optim
from repro.distributed import context as j_context
from repro.distributed import sharding as j_sharding
from repro.launch import train as j_train
from repro.models import transformer as j_tf
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import context, sharding
from repro_torch.launch import convert, train
from repro_torch.models import transformer

ARCH = "lram-bert-medium"
BATCH, SEQ, STEPS = 4, 32, 5
MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model")), ((3, 2), ("data", "model")),
          ((2, 1, 2), ("pod", "data", "model"))]


class DuckMesh:
    """A mesh's axes and sizes, as rank 0 sees them, without processes:
    what `param_specs` and the lookup plans read."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)
        self.coords = {a: 0 for a in axes}

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes):
        return 0

    def group(self, axes):
        return None


def _model_specs(arch, placement, shape, axes):
    """(the port's specs by state_dict key, the reference's by pytree path,
    the port's config) with both packages' ambient mesh a duck of
    `shape`."""
    j_cfg = j_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    if placement:
        j_cfg = dataclasses.replace(j_cfg, lram=dataclasses.replace(
            j_cfg.lram, interp_impl=placement))
        cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, interp_impl=placement))
    mesh = DuckMesh(shape, axes)
    j_context.set_mesh(mesh)
    context.set_mesh(mesh)
    try:
        shapes = jax.eval_shape(lambda k: j_tf.init(k, j_cfg),
                                jax.random.PRNGKey(0))[0]
        ref = j_sharding.param_pspecs(shapes, mesh, model_cfg=j_cfg)
        model = transformer.init(cfg, seed=0)
        mine = sharding.param_specs(model, mesh)
        assert len(mine) == len(dict(model.named_parameters()))
    finally:
        j_context.set_mesh(None)
        context.set_mesh(None)
    flat = {"params/" + "/".join(str(getattr(p, "key", p)) for p in path):
            tuple(spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    return mine, flat, cfg


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
@pytest.mark.parametrize("arch,placement", [
    (ARCH, "pallas"), (ARCH, "sharded"), ("lram-bert-pkm", "")])
def test_param_specs_match_reference(arch, placement, shape, axes):
    """Every leaf's spec equals the reference's `param_pspecs` (its
    stacked runs' leading None dropped), the memory table's from its
    plan; on (3, 2) the data rules fall back to None, as the reference's
    do."""
    mine, ref, cfg = _model_specs(arch, placement, shape, axes)
    for key, spec in mine.items():
        path, layer = convert.reference_path(key, cfg)
        want = ref[path]
        if layer is not None and want:
            assert want[0] is None, (key, want)
            want = want[1:]
        assert spec == want, key
    embed = mine["embed.embedding"]
    if shape == (3, 2):
        assert embed == ("model", None)
    elif axes[0] == "pod":
        assert embed == ("model", ("pod", "data"))
    else:
        assert embed == ("model", "data")


def test_param_specs_split_the_paper_model_as_sized():
    """The full-width `lram-bert-medium` on data 2 x model 2: all but
    145,440 of its 48,953,376 dense parameters split 4 ways (`pos_embed`
    and the norms stay whole), the table replicated under `pallas`."""
    cfg = configs.get_config(ARCH)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas", log2_locations=10))
    model = transformer.init(cfg, seed=0)
    mesh = DuckMesh((2, 2), ("data", "model"))
    specs = sharding.param_specs(model, mesh)
    split = whole = 0
    for key, p in model.named_parameters():
        if key.endswith("lram.values"):
            assert specs[key] == ()
            continue
        ways = math.prod(mesh.shape[a] for a in sharding.spec_axes(
            specs[key]))
        assert ways in (1, 4), key
        split += p.numel() * (ways == 4)
        whole += p.numel() * (ways == 1)
    assert (split, whole) == (48_953_376 - 145_440, 145_440)


BLOCKS_CODE = textwrap.dedent("""
    import itertools, json
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer

    meshes = json.loads('MESHES')
    model = transformer.init(configs.get_smoke_config("lram-bert-medium"),
                             seed=0)
    checked = 0
    for shape, axes in meshes:
        shape = tuple(shape)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), tuple(axes))
        specs = sharding.param_specs(model, mesh)
        for key, p in model.named_parameters():
            spec, full = specs[key], tuple(p.shape)
            want = NamedSharding(mesh, P(*spec)).devices_indices_map(full)
            for r, pos in enumerate(itertools.product(
                    *(range(n) for n in shape))):
                coords = dict(zip(axes, pos))
                got = sharding.block_index(full, spec, mesh, coords)
                got = got + (slice(None),) * (len(full) - len(got))
                dev = mesh.devices[pos]
                assert [s.indices(n) for s, n in zip(got, full)] == [
                    s.indices(n) for s, n in zip(want[dev], full)], (
                    shape, key, r)
                checked += 1
    print("blocks OK", checked)
""")


def test_blocks_are_named_shardings_device_slices():
    """On 4 fake JAX devices (device r = rank r, the mesh's devices
    row-major), each rank's block of every leaf of the smoke model is the
    slice `NamedSharding(mesh, spec).devices_indices_map` gives its
    device, on every 4-rank mesh tested, the pod mesh's ("pod", "data")
    dims pod first."""
    four = [m for m in MESHES if math.prod(m[0]) == 4]
    code = BLOCKS_CODE.replace("MESHES", json.dumps(four))
    out = run_in_subprocess(code, devices=4)
    assert "blocks OK" in out


# ---------------------------------------------------------------------------
# 4 ranks train on the blocks
# ---------------------------------------------------------------------------

RANK_CODE = textwrap.dedent("""
    import dataclasses, json, os, pickle
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import configs, data, optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.launch import convert, mesh as mesh_lib, train
    from repro_torch.models import transformer

    torch.set_num_threads(1)
    out_dir, placement = os.environ["OUT"], os.environ["PLACEMENT"]
    mesh, device = mesh_lib.init_mesh(
        "cpu", init_method=os.environ["TEST_INIT_METHOD"],
        shape=os.environ["SHAPE"])
    rank = dist.get_rank()
    with open(os.path.join(out_dir, "..", "ref.pkl"), "rb") as f:
        params, state, batches = pickle.load(f)
    cfg = configs.get_smoke_config("lram-bert-medium")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl=placement))
    adam_update, grad_shapes = optim.adam_update, []

    def capture(params, grads, *args, **kw):  # the shapes Adam is given
        grad_shapes.append({k: list(g.shape) for k, g in grads.items()})
        return adam_update(params, grads, *args, **kw)

    optim.adam_update = capture

    def recorded(model, events):
        # every gather and release: (event, phase, whole units held
        # but shared ones, shared units held)
        blocks = sharding.dense_blocks(model)

        def record(event, unit, phase, held):
            own = sum(not blocks.units[u].shared for u in held)
            events.append([event, phase, own, len(held) - own])

        blocks.recorder = record
        return blocks

    def train_on(model, batches):
        step = train.build_train_step(model, optim.OptimConfig(lr=1e-4),
                                      mesh)
        opt = optim.adam_init(dict(model.named_parameters()))
        losses = []
        for b in batches:
            m = step(opt, train.batch_to(b, "cpu"))
            losses.append((m["loss"].item(), m["grad_norm"].item()))
        return opt, losses

    model = convert.model_from_jax(params, state, cfg, device="cpu")
    sharding.shard_params(model, mesh)
    events = []
    blocks = recorded(model, events)
    opt, losses = train_on(model, batches)
    train_events = len(events)
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4, objective=cfg.objective)
    train.evaluate(model, dcfg, steps=1)
    blocks.recorder = None
    try:
        transformer.forward(model, train.batch_to(batches[0], "cpu"))
        bare = ""
    except RuntimeError as e:
        bare = str(e)
    held = {k: [list(p.shape), list(opt["mu"][k].shape),
                list(opt["nu"][k].shape)]
            for k, p in model.named_parameters()}
    res = {"losses": np.array(losses), "bare": bare,
           "whole": blocks.whole, "coords": json.dumps(mesh.coords),
           "held": json.dumps(held),
           "specs": json.dumps(blocks.specs),
           "events": json.dumps(events), "train_events": train_events,
           "units": len(blocks.units),
           "grad_shapes": json.dumps(grad_shapes)}
    if os.environ.get("TIED"):  # the embedding tied: a shared unit
        with open(os.path.join(out_dir, "..", "tied.pkl"), "rb") as f:
            tparams, tstate = pickle.load(f)
        tied = convert.model_from_jax(
            tparams, tstate, dataclasses.replace(cfg, tie_embeddings=True),
            device="cpu")
        sharding.shard_params(tied, mesh)
        tied_events = []
        tblocks = recorded(tied, tied_events)
        _, tied_losses = train_on(tied, batches)
        res.update({"tied_losses": np.array(tied_losses),
                    "tied_events": json.dumps(tied_events),
                    "tied_specs": json.dumps(tblocks.specs),
                    "tied_units": json.dumps(
                        {u: x.shared for u, x in tblocks.units.items()})})
        res.update({f"tied/{k}": p.detach().numpy()
                    for k, p in tied.named_parameters()})
    res.update({f"param/{k}": p.detach().numpy()
                for k, p in model.named_parameters()})
    spread = convert.reference_sharding(model, opt)
    CheckpointManager(os.path.join(out_dir, "ck")).save(
        len(batches), convert.reference_tree(model, opt), sharding=spread)
    restore = os.environ.get("RESTORE")
    if restore:  # another mesh's checkpoint onto this one
        fresh = transformer.init(cfg, seed=9)
        sharding.shard_params(fresh, mesh)
        fopt = optim.adam_init(dict(fresh.named_parameters()))
        found, tree = CheckpointManager(restore).restore(
            convert.reference_tree(fresh, fopt, like=True),
            sharding=convert.reference_sharding(fresh, fopt))
        convert.load_reference_tree(fresh, tree, fopt)
        res["restored_step"] = found
        res.update({f"restored/{k}": p.detach().numpy()
                    for k, p in fresh.named_parameters()})
        res.update({f"restored_mu/{k}": t.numpy()
                    for k, t in fopt["mu"].items()})
        run = train.main(["--arch", "lram-bert-medium", "--smoke",
                          "--device", "cpu", "--placement", placement,
                          "--use-mesh", "--mesh-shape", os.environ["SHAPE"],
                          "--steps", "3", "--batch", "4", "--seq", "16"])
        res["cli_losses"] = np.array([r["loss"] for r in run.records])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX init, the batches, and the single-device step's losses,
    grad norms and trained params (as the port's state_dict)."""
    root = tmp_path_factory.mktemp("fsdp")
    j_cfg = j_configs.get_smoke_config(ARCH)
    params, state = jax.jit(j_tf.init, static_argnums=1)(
        jax.random.PRNGKey(0), j_cfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=j_cfg.objective,
                             seed=0)
    batches = [j_data.get_batch(dcfg, step=s) for s in range(STEPS)]
    with open(root / "ref.pkl", "wb") as f:
        pickle.dump((params, state, batches), f)
    j_step = j_train.build_train_step(j_cfg, j_optim.OptimConfig(lr=1e-4))
    p = jax.tree.map(jnp.asarray, params)
    s = jax.tree.map(jnp.asarray, state)
    opt, residual, losses = j_optim.adam_init(p), jnp.zeros(()), []
    for b in batches:
        p, opt, s, residual, m = j_step(p, opt, s, residual,
                                        jax.tree.map(jnp.asarray, b))
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    trained = convert.state_dict_from_jax(jax.tree.map(np.asarray, p),
                                          {}, j_cfg)
    # the same model with a tied embedding (no lm_head): its init, saved
    # for the ranks, and the single-device step's losses and parameters
    t_cfg = dataclasses.replace(j_cfg, tie_embeddings=True)
    tp, ts = jax.jit(j_tf.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  t_cfg)
    with open(root / "tied.pkl", "wb") as f:
        pickle.dump((jax.tree.map(np.asarray, tp),
                     jax.tree.map(np.asarray, ts)), f)
    t_step = j_train.build_train_step(t_cfg, j_optim.OptimConfig(lr=1e-4))
    t_opt, t_res, t_losses = j_optim.adam_init(tp), jnp.zeros(()), []
    for b in batches:
        tp, t_opt, ts, t_res, m = t_step(tp, t_opt, ts, t_res,
                                         jax.tree.map(jnp.asarray, b))
        t_losses.append((float(m["loss"]), float(m["grad_norm"])))
    tied = convert.state_dict_from_jax(jax.tree.map(np.asarray, tp), {},
                                       t_cfg)
    return {"root": root, "losses": np.array(losses),
            "trained": {k: v.numpy() for k, v in trained.items()},
            "tied_losses": np.array(t_losses),
            "tied": {k: v.numpy() for k, v in tied.items()}}


def _launch(ref, name, placement, shape, restore=None, tied=False):
    out = ref["root"] / name
    out.mkdir()
    env = {"OUT": str(out), "PLACEMENT": placement, "SHAPE": shape}
    if restore:
        env["RESTORE"] = str(restore)
    if tied:
        env["TIED"] = "1"
    run_ranks(RANK_CODE, 4, out, timeout=180, env=env)
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def mesh_2x2(ref):
    """`--placement pallas` (a replicated table) on data 2 x model 2,
    then the tied-embedding model."""
    return _launch(ref, "pallas_2x2", "pallas", "2x2", tied=True)


@pytest.fixture(scope="module")
def pod_mesh(ref, mesh_2x2):
    """`--placement sharded` on pod 2 x data 1 x model 2; then the 2 x 2
    run's checkpoint restored on it, and the CLI on it."""
    return _launch(ref, "sharded_pod", "sharded", "2x1x2",
                   restore=mesh_2x2[0] / "ck")


def _runs(mesh_2x2, pod_mesh):
    return {"2x2": mesh_2x2[1], "2x1x2": pod_mesh[1]}


SHAPES = {"2x2": DuckMesh((2, 2), ("data", "model")),
          "2x1x2": DuckMesh((2, 1, 2), ("pod", "data", "model"))}
TABLE = "segments.seg1.memffn.lram.values"


def _specs(r) -> dict:
    """A rank's split leaves' specs (JSON lists back to tuples)."""
    return {k: tuple(tuple(e) if isinstance(e, list) else e for e in v)
            for k, v in json.loads(str(r["specs"])).items()}


def _part(whole, key, specs, mesh, coords, table_split):
    """A rank's part of a global leaf: its block, its table rows, or the
    leaf."""
    if key in specs:
        return whole[sharding.block_index(whole.shape, specs[key], mesh,
                                          coords)]
    if key == TABLE and table_split:
        rows = whole.shape[0] // mesh.shape["model"]
        return whole[coords["model"] * rows:(coords["model"] + 1) * rows]
    return whole


@pytest.mark.parametrize("which", ["2x2", "2x1x2"])
def test_losses_match_single_device_jax(ref, mesh_2x2, pod_mesh, which):
    """5 steps' losses (the global batch's) and grad norms on every rank
    against the JAX package's single-device step, rtol 1e-4 (the
    tolerance of test_torch_mesh_train.py)."""
    for r in _runs(mesh_2x2, pod_mesh)[which]:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-4)


@pytest.mark.parametrize("which", ["2x2", "2x1x2"])
def test_trained_blocks_match_single_device_jax(ref, mesh_2x2, pod_mesh,
                                                which):
    """After 5 steps every rank's part of every leaf (a dense leaf's block,
    a sharded table's rows, a replicated leaf whole) is its slice of the
    JAX step's trained parameter, to rtol 1e-4 / atol 1e-5."""
    for r in _runs(mesh_2x2, pod_mesh)[which]:
        specs, coords = _specs(r), json.loads(str(r["coords"]))
        for key, whole in ref["trained"].items():
            want = _part(whole, key, specs, SHAPES[which], coords,
                         which == "2x1x2")
            np.testing.assert_allclose(r[f"param/{key}"], want, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{which} {key}")


@pytest.mark.parametrize("which", ["2x2", "2x1x2"])
def test_ranks_hold_only_their_blocks_between_steps(ref, mesh_2x2,
                                                    pod_mesh, which):
    """Between steps every leaf the rules split over more than one rank,
    and its two moments, has its block's shape (each split dim over the
    ranks of its axes), every other leaf (and the table, replicated or
    its rows) its own; the leaves are not gathered, and a forward over
    the bare blocks raises, saying why."""
    mesh = SHAPES[which]
    for r in _runs(mesh_2x2, pod_mesh)[which]:
        held, specs = json.loads(str(r["held"])), _specs(r)
        assert not bool(r["whole"])
        assert "only its blocks" in str(r["bare"])
        for key, whole in ref["trained"].items():
            want = list(_part(whole, key, specs, mesh, json.loads(
                str(r["coords"])), which == "2x1x2").shape)
            assert held[key] == [want, want, want], key
        split = [k for k, s in specs.items()
                 if math.prod(mesh.size(a) for a in sharding.spec_axes(s))
                 == 4]
        assert "embed.embedding" in split and len(split) >= 15


def _held_at_once(events) -> tuple[int, int]:
    """The most whole units a rank held at once, (not shared, shared)."""
    return (max(e[2] for e in events), max(e[3] for e in events))


@pytest.mark.parametrize("which", ["2x2", "2x1x2"])
def test_one_unit_whole_at_a_time(mesh_2x2, pod_mesh, which):
    """Through 5 steps and an evaluation, every rank gathers each unit
    (the embedding, each layer, the head) whole just before its forward
    and again before its backward, and releases it after each: it never
    holds two units' whole leaves at once; the evaluation gathers each
    unit once a forward (no backward), and after it nothing is whole."""
    for r in _runs(mesh_2x2, pod_mesh)[which]:
        events = json.loads(str(r["events"]))
        n = int(r["train_events"])
        train, evals = events[:n], events[n:]
        assert _held_at_once(events) == (1, 0)
        for part, phases in ((train, {"forward", "backward"}),
                             (evals, {"forward"})):
            gathers = [e for e in part if e[0] == "gather"]
            assert {e[1] for e in gathers} == phases
            assert len(gathers) == sum(e[0] == "release" for e in part)
        per_step = sum(e[0] == "gather" for e in train) / STEPS
        assert per_step == 2 * int(r["units"])  # forward and backward
        assert events[-1][2:] == [0, 0]


def test_gradients_reach_adam_as_blocks(ref, mesh_2x2, pod_mesh):
    """Every step's gradients reach Adam in the shapes the rank holds its
    parameters in (a split leaf's block, the table's rows), on both
    meshes: no split leaf's gradient is whole."""
    for r in mesh_2x2[1] + pod_mesh[1]:
        held = json.loads(str(r["held"]))
        steps = json.loads(str(r["grad_shapes"]))
        assert len(steps) == STEPS
        for shapes in steps:
            assert shapes == {k: v[0] for k, v in held.items()}
            for k in _specs(r):
                assert shapes[k] != list(ref["trained"][k].shape), k


def test_tied_embedding_trains_as_single_device_jax(ref, mesh_2x2):
    """The model with its embedding tied (the head reads it: one shared
    unit, gathered at both uses and summed once, after its last use in
    the backward) on data 2 x model 2: 5 steps' losses and grad norms to
    rtol 1e-4 and every rank's trained blocks to rtol 1e-4 / atol 1e-5
    of the JAX single-device step; at most one unit whole at once beside
    the embedding."""
    for r in mesh_2x2[1]:
        np.testing.assert_allclose(r["tied_losses"], ref["tied_losses"],
                                   rtol=1e-4)
        assert json.loads(str(r["tied_units"]))["embed"] is True
        assert "lm_head" not in json.loads(str(r["tied_units"]))
        assert _held_at_once(json.loads(str(r["tied_events"]))) == (1, 1)
        specs = {k: tuple(tuple(e) if isinstance(e, list) else e for e in v)
                 for k, v in json.loads(str(r["tied_specs"])).items()}
        coords = json.loads(str(r["coords"]))
        for key, whole in ref["tied"].items():
            want = _part(whole, key, specs, SHAPES["2x2"], coords, False)
            np.testing.assert_allclose(r[f"tied/{key}"], want, rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_checkpoint_restores_on_the_pod_mesh(mesh_2x2, pod_mesh):
    """The 2 x 2 run's checkpoint (rank 0 wrote the global arrays) restored
    on pod 2 x data 1 x model 2: every rank holds its block of each
    global leaf (parameters and first moments) bit for bit, as a
    one-process restore of the same checkpoint gives them."""
    cfg = configs.get_smoke_config(ARCH)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    one = transformer.init(cfg, seed=3)
    opt = train.optim.adam_init(dict(one.named_parameters()))
    found, tree = CheckpointManager(str(mesh_2x2[0] / "ck")).restore(
        convert.reference_tree(one, opt, like=True))
    assert found == STEPS
    convert.load_reference_tree(one, tree, opt)
    for r in pod_mesh[1]:
        assert int(r["restored_step"]) == STEPS
        specs, coords = _specs(r), json.loads(str(r["coords"]))
        for key, p in one.named_parameters():
            for what, whole in (("restored", p.detach().numpy()),
                                ("restored_mu", opt["mu"][key].numpy())):
                np.testing.assert_array_equal(
                    r[f"{what}/{key}"],
                    _part(whole, key, specs, SHAPES["2x1x2"], coords, True),
                    err_msg=key)


def test_cli_trains_on_a_pod_mesh(pod_mesh):
    """`train.main --use-mesh --mesh-shape 2x1x2 --placement sharded`
    gives the losses of one process on the dense table (same seed and
    batches) to rtol 1e-5, on every rank."""
    dense = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--placement", "pallas", "--steps", "3", "--batch",
                        "4", "--seq", "16"])
    want = [x["loss"] for x in dense.records]
    for r in pod_mesh[1]:
        np.testing.assert_allclose(r["cli_losses"], want, rtol=1e-5)
