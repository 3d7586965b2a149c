"""Checkpoints on a mesh and elastic restore (the port's counterpart of
the reference's `CheckpointManager.restore(sharding=...)`), and the
restore's fallback past a malformed newest manifest (C5), in both
packages.

A mesh run checkpoints the reference's global arrays: every rank takes
part in a save (a row-sharded table and its Adam moments gathered over
``model``), rank 0 alone writes, and each rank of a relaunch keeps its
rows.  The multi-rank cases run `tests/_ranks.py`'s fresh gloo
processes: `lram-bert-medium --smoke --placement sharded --use-mesh` on
4 ranks (data 2 x model 2) crashes and resumes against an uninterrupted
4-rank run, and its checkpoint restores on a 1 x 4 mesh, on one process
and in the JAX package; a JAX checkpoint restores on a 1 x 2 mesh; a
2-rank `lram-tiered` run checkpoints once."""

import dataclasses
import json
import os
import textwrap

import jax
import numpy as np
import pytest
import torch

from _ranks import run_ranks
from repro import configs as j_configs
from repro import optim as j_optim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint.manager import _tree_items as j_tree_items
from repro.memstore import TieredSpec as JSpec
from repro.memstore import TieredValueStore as JTieredValueStore
from repro.models import transformer as j_tf
from repro_torch import configs, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _tree_items
from repro_torch.launch import convert, train
from repro_torch.memstore import TieredSpec, TieredValueStore
from repro_torch.models import transformer

ARCH = "lram-bert-medium"
TABLE = "params/segments/seg1/memffn/lram/values"
MOMENTS = ("opt/mu/segments/seg1/memffn/lram/values",
           "opt/nu/segments/seg1/memffn/lram/values")
MESH_ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--placement",
             "sharded", "--use-mesh", "--json", "--batch", "4", "--seq",
             "16", "--steps", "8"]
CKPT = ["--ckpt-every", "4"]


def _steps(out: str) -> list[list[dict]]:
    """Rank 0's step lines, one list a run (a run starts where the step
    number does not follow the last)."""
    runs: list[list[dict]] = []
    for line in out.splitlines():
        if line.startswith('{"step"'):
            rec = json.loads(line)
            if not runs or rec["step"] != runs[-1][-1]["step"] + 1:
                runs.append([])
            runs[-1].append(rec)
    return runs


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:012d}", "manifest.json")) as f:
        return json.load(f)


def _layout(manifest):
    """Leaf names, shapes and dtypes (no checksums)."""
    return {n: (m.get("shape"), m.get("dtype"), m.get("kind"))
            for n, m in manifest["leaves"].items()}


# ---------------------------------------------------------------------------
# C5: a malformed newest manifest falls back in both packages
# ---------------------------------------------------------------------------

def _corrupt(manifest: dict, how: str) -> None:
    leaves = manifest["leaves"]
    if how == "leaf without crc32":
        del leaves["w"]["crc32"]
    elif how == "short crc list":
        tiered = next(m for m in leaves.values() if m.get("kind") == "tiered")
        tiered["crc32"] = tiered["crc32"][:-1]
    else:  # a tiered_ref to a leaf the manifest does not have
        ref = next(m for m in leaves.values()
                   if m.get("kind") == "tiered_ref")
        ref["ref"] = "nowhere"


@pytest.mark.parametrize("how", ["leaf without crc32", "short crc list",
                                 "dangling tiered_ref"])
def test_malformed_newest_manifest_falls_back(rng, tmp_path, how):
    """Steps 1 and 2 of a tree with a tiered store under two paths (one
    `tiered`, one `tiered_ref` entry); step 2's manifest parses but is
    malformed.  Both packages restore step 1 (the store's shards and the
    array bit for bit), as the reference's fallback on any exception but
    a caller error does; a `like` asking for a leaf the checkpoint lacks
    still raises."""
    spec = dict(shard_rows=64, cache_slots=2)
    values = [rng.normal(size=(256, 8)).astype(np.float32) for _ in (1, 2)]
    arrays = [rng.normal(size=(3, 4)).astype(np.float32) for _ in (1, 2)]
    mgr = CheckpointManager(str(tmp_path))
    for step, (v, a) in enumerate(zip(values, arrays), start=1):
        store = TieredValueStore.from_dense(v, TieredSpec(**spec))
        mgr.save(step, {"a": {"values": store}, "b": {"values": store},
                        "w": a})
    path = os.path.join(tmp_path, f"step_{2:012d}", "manifest.json")
    manifest = _manifest(tmp_path, 2)
    _corrupt(manifest, how)
    with open(path, "w") as f:
        json.dump(manifest, f)

    store = TieredValueStore(256, 8, TieredSpec(**spec))
    found, tree = mgr.restore({"a": {"values": store},
                               "b": {"values": store},
                               "w": np.zeros((3, 4), np.float32)})
    assert found == 1
    np.testing.assert_array_equal(store.to_dense(), values[0])
    np.testing.assert_array_equal(tree["w"], arrays[0])
    j_store = JTieredValueStore(256, 8, JSpec(**spec))
    j_found, j_tree = JCheckpointManager(str(tmp_path)).restore(
        {"a": {"values": j_store}, "b": {"values": j_store},
         "w": np.zeros((3, 4), np.float32)})
    assert j_found == found
    np.testing.assert_array_equal(j_store.to_dense(), values[0])
    np.testing.assert_array_equal(np.asarray(j_tree["w"]), arrays[0])
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({"w": np.zeros((3, 4), np.float32),
                     "extra": np.zeros(2, np.float32)})


# ---------------------------------------------------------------------------
# a 4-rank mesh: crash, resume, elastic restore
# ---------------------------------------------------------------------------

CRASH_CODE = textwrap.dedent("""
    import json, os
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import fault
    from repro_torch.launch import train
    torch.set_num_threads(1)
    args = json.loads(os.environ["ARGS"])
    train.main(args)                                   # uninterrupted
    try:
        train.main(args + json.loads(os.environ["CKPT"])
                   + ["--simulate-failure-at", "6"])
    except fault.SimulatedFailure:
        print("crashed", flush=True)
    dist.destroy_process_group()
""")

RESUME_CODE = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import configs, optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import context, sharding
    from repro_torch.launch import convert, train
    from repro_torch.models import transformer
    torch.set_num_threads(1)
    args = json.loads(os.environ["ARGS"])
    train.main(args + json.loads(os.environ["CKPT"]))  # the relaunch
    dist.barrier()
    # the step-8 checkpoint of the data 2 x model 2 run on a 1 x 4 mesh
    mesh = context.Mesh((1, 4), ("data", "model"))
    context.set_mesh(mesh)
    cfg = configs.get_smoke_config("lram-bert-medium")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="sharded"))
    model = transformer.init(cfg, seed=5)
    sharding.shard_params(model, mesh)
    opt = optim.adam_init(dict(model.named_parameters()))
    like = convert.reference_tree(model, opt, like=True)
    like_rows = like["params"]["segments"]["seg1"]["memffn"]["lram"][
        "values"].shape[0]
    found, tree = CheckpointManager(os.environ["CKPT_DIR"]).restore(
        like, sharding=convert.reference_sharding(model, opt))
    convert.load_reference_tree(model, tree, opt)
    key = "segments.seg1.memffn.lram.values"
    np.savez(os.path.join(os.environ["OUT"], f"rank{dist.get_rank()}.npz"),
             found=found, coord=mesh.index("model"), like_rows=like_rows,
             table=model.get_parameter(key).detach().numpy(),
             mu=opt["mu"][key].numpy(), nu=opt["nu"][key].numpy(),
             step=opt["step"].numpy())
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The uninterrupted 4-rank run, the crashed one, the relaunch, and the
    relaunch's checkpoint restored on a 1 x 4 mesh (each rank's rows)."""
    out = tmp_path_factory.mktemp("ckpt_mesh")
    env = {"ARGS": json.dumps(MESH_ARGS),
           "CKPT": json.dumps(CKPT + ["--ckpt-dir", str(out / "ck")]),
           "CKPT_DIR": str(out / "ck"), "OUT": str(out)}
    first = run_ranks(CRASH_CODE, 4, out, timeout=180, env=env)
    second = run_ranks(RESUME_CODE, 4, out, timeout=180, env=env)
    uninterrupted, crashed = _steps(first[0])
    (resumed,) = _steps(second[0])
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return {"dir": out / "ck", "first": first, "second": second,
            "uninterrupted": uninterrupted, "crashed": crashed,
            "resumed": resumed, "ranks": ranks}


def test_mesh_crash_and_resume_gives_the_uninterrupted_losses(mesh_runs):
    """Every rank raised SimulatedFailure after rank 0's write; the
    relaunch prints `resumed from step 4` (rank 0 alone), its step-4 loss
    is the crashed run's bit for bit, and steps 4-7 are the uninterrupted
    4-rank run's to rtol 1e-4 (losses and grad norms)."""
    r = mesh_runs
    assert all("crashed" in o for o in r["first"])
    assert "resumed from step 4\n" in r["second"][0]
    assert not any("resumed" in o for o in r["second"][1:])
    assert [x["step"] for x in r["crashed"]] == list(range(6))
    assert [x["step"] for x in r["resumed"]] == list(range(4, 8))
    assert r["resumed"][0]["loss"] == r["crashed"][4]["loss"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([x[key] for x in r["resumed"]],
                                   [x[key] for x in
                                    r["uninterrupted"][4:]], rtol=1e-4)


def test_mesh_checkpoint_is_a_one_process_checkpoint(mesh_runs, tmp_path):
    """Rank 0 wrote steps 4 and 8 (global arrays); their manifests have a
    one-process `--placement pallas` run's leaf names, shapes and dtypes,
    the table (2^16 rows) and its moments whole."""
    assert CheckpointManager(str(mesh_runs["dir"])).all_steps() == [4, 8]
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--placement",
                "pallas", "--batch", "4", "--seq", "16", "--steps", "4",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    one = _layout(_manifest(tmp_path, 4))
    for step in (4, 8):
        mesh = _layout(_manifest(mesh_runs["dir"], step))
        assert mesh == one
    rows = configs.get_smoke_config(ARCH).lram.num_locations
    assert one[TABLE][0][0] == rows


def _jax_like(arch):
    j_cfg = j_configs.get_smoke_config(arch)
    params, state = j_tf.init(jax.random.PRNGKey(1), j_cfg)
    return {"params": params, "opt": j_optim.adam_init(params),
            "model_state": state}


def test_mesh_checkpoint_restores_on_one_process_and_in_jax(mesh_runs):
    """The step-8 checkpoint restores into a one-process dense model
    (`--placement pallas`'s tree) and through the JAX package's
    `CheckpointManager.restore`: the same global arrays, bit for bit,
    every leaf; and the 1 x 4 mesh's ranks hold, in coordinate order,
    the global table and moments bit for bit."""
    cfg = configs.get_smoke_config(ARCH)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    model = transformer.init(cfg, seed=3)
    opt = optim.adam_init(dict(model.named_parameters()))
    found, tree = CheckpointManager(str(mesh_runs["dir"])).restore(
        convert.reference_tree(model, opt, like=True))
    assert found == 8
    j_found, j_tree = JCheckpointManager(str(mesh_runs["dir"])).restore(
        _jax_like(ARCH))
    assert j_found == 8
    mine = dict(_tree_items(tree))
    theirs = dict(j_tree_items(j_tree))
    assert set(mine) == set(theirs)
    for name, arr in mine.items():
        np.testing.assert_array_equal(arr, np.asarray(theirs[name]),
                                      err_msg=name)
    ranks = sorted(mesh_runs["ranks"], key=lambda r: int(r["coord"]))
    assert all(int(r["found"]) == 8 and int(r["step"]) == 8 for r in ranks)
    for key, name in (("table", TABLE), ("mu", MOMENTS[0]),
                      ("nu", MOMENTS[1])):
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in ranks]), mine[name],
            err_msg=name)
    assert ranks[0]["table"].shape[0] * 4 == mine[TABLE].shape[0]


# ---------------------------------------------------------------------------
# 2 ranks: a JAX checkpoint onto a mesh, a tiered table's checkpoint
# ---------------------------------------------------------------------------

TWO_RANK_CODE = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch import configs, optim
    from repro_torch.checkpoint import CheckpointError, CheckpointManager
    from repro_torch.checkpoint import manager
    from repro_torch.core import lookup
    from repro_torch.distributed import context, sharding
    from repro_torch.launch import convert, train
    from repro_torch.models import transformer
    torch.set_num_threads(1)
    out = os.environ["OUT"]
    writes = []
    write = manager.CheckpointManager._write

    def recorded(self, step, *a):
        writes.append(step)
        return write(self, step, *a)

    manager.CheckpointManager._write = recorded
    args = ["--arch", "lram-tiered", "--smoke", "--device", "cpu",
            "--use-mesh", "--batch", "4", "--seq", "16", "--steps", "2",
            "--ckpt-dir", os.path.join(out, "tiered"), "--ckpt-every", "2"]
    run = train.main(args)                       # data 2 x model 1
    dist.barrier()
    model = transformer.init(configs.get_smoke_config("lram-tiered"),
                             seed=7)
    found, _ = CheckpointManager(os.path.join(out, "tiered")).restore(
        convert.reference_tree(model, like=True))
    (_, restored), = lookup.find_stores(model)
    # a JAX checkpoint of lram-bert-medium onto a 1 x 2 mesh
    mesh = context.Mesh((1, 2), ("data", "model"))
    context.set_mesh(mesh)
    cfg = configs.get_smoke_config("lram-bert-medium")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="sharded"))
    sharded = transformer.init(cfg, seed=5)
    sharding.shard_params(sharded, mesh)
    opt = optim.adam_init(dict(sharded.named_parameters()))
    j_found, tree = CheckpointManager(os.path.join(out, "jax")).restore(
        convert.reference_tree(sharded, opt, like=True),
        sharding=convert.reference_sharding(sharded, opt))
    convert.load_reference_tree(sharded, tree, opt)
    key = "segments.seg1.memffn.lram.values"
    # the ranks compare their restored steps: equal, then rank 1 with none
    train.same_step_on_every_rank(3)
    try:
        train.same_step_on_every_rank(3 if dist.get_rank() == 0 else None)
        disagree = ""
    except CheckpointError as e:
        disagree = str(e)
    np.savez(os.path.join(out, f"two{dist.get_rank()}.npz"),
             writes=np.array(writes), found=found, disagree=disagree,
             trained=run.stores[0].to_dense(), restored=restored.to_dense(),
             j_found=j_found, coord=mesh.index("model"),
             table=sharded.get_parameter(key).detach().numpy(),
             mu=opt["mu"][key].numpy(),
             embed=sharded.get_parameter("embed.embedding").detach().numpy())
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_two")
    j_tree = _jax_like(ARCH)
    JCheckpointManager(str(out / "jax")).save(3, j_tree)
    run_ranks(TWO_RANK_CODE, 2, out, timeout=180, env={"OUT": str(out)})
    return j_tree, [dict(np.load(out / f"two{r}.npz")) for r in range(2)]


def test_tiered_mesh_run_checkpoints_once(two_ranks):
    """A 2-rank `lram-tiered` run (data 2) saves at step 2: rank 0 alone
    writes, and every rank restores the same store, the trained one bit
    for bit."""
    _, ranks = two_ranks
    assert ranks[0]["writes"].tolist() == [2]
    assert ranks[1]["writes"].tolist() == []
    for r in ranks:
        assert int(r["found"]) == 2
        np.testing.assert_array_equal(r["restored"], r["trained"])
    np.testing.assert_array_equal(ranks[0]["restored"], ranks[1]["restored"])


def test_jax_checkpoint_restores_onto_a_mesh(two_ranks):
    """The JAX package's checkpoint of `lram-bert-medium` (smoke) onto a
    1 x 2 mesh of the port: rank i holds rows [i R, (i + 1) R) of the
    table and its first moment, bit for bit, and the replicated weights
    whole."""
    j_tree, ranks = two_ranks
    table = np.asarray(j_tree["params"]["segments"]["seg1"]["memffn"]
                       ["lram"]["values"])
    mu = np.asarray(j_tree["opt"]["mu"]["segments"]["seg1"]["memffn"]
                    ["lram"]["values"])
    rows = table.shape[0] // 2
    for r in ranks:
        i = int(r["coord"])
        assert int(r["j_found"]) == 3
        np.testing.assert_array_equal(r["table"],
                                      table[i * rows:(i + 1) * rows])
        np.testing.assert_array_equal(r["mu"], mu[i * rows:(i + 1) * rows])
        np.testing.assert_array_equal(
            r["embed"], np.asarray(j_tree["params"]["embed"]["embedding"]))


def test_ranks_that_restored_different_steps_raise(two_ranks):
    """`train.same_step_on_every_rank`: ranks that restored the same step
    go on; where one restored none and the other step 3, every rank
    raises `CheckpointError` naming each rank's step."""
    _, ranks = two_ranks
    for r in ranks:
        assert str(r["disagree"]) == ("the ranks restored different steps "
                                      "(by rank: [3, None])")


def test_reference_tree_gives_global_shapes_on_a_mesh(mesh_runs):
    """`reference_tree(like=True)` on the 1 x 4 mesh gives the table's
    global rows (the checkpoint's), each rank holding a quarter; without
    a mesh nothing is row-sharded."""
    rows = configs.get_smoke_config(ARCH).lram.num_locations
    for r in mesh_runs["ranks"]:
        assert int(r["like_rows"]) == rows == 4 * r["table"].shape[0]
    model = transformer.init(configs.get_smoke_config(ARCH), seed=0)
    opt = optim.adam_init(dict(model.named_parameters()))
    assert convert.reference_sharding(model, opt) == {}
    like = dict(_tree_items(convert.reference_tree(model, opt, like=True)))
    assert like[TABLE].shape[0] == rows
    assert all(t.device.type == "meta" for t in like.values()
               if isinstance(t, torch.Tensor))
