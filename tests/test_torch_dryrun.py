"""The port's dry-run (`repro_torch.launch.dryrun`) on smoke configs: one
rank's step run on `meta` tensors in a fake `torch.distributed` world, its
products, bytes, memory and collectives counted.

One fresh process (a fake world is process-global) runs the cells, and
the tests read its artifacts:

* yi-9b's smoke config on a 2 x 4 world (the reference test's mesh) and
  a 2 x 2 x 2 pod mesh, train, prefill and decode; an MoE
  (mixtral-8x7b), an SSM (mamba2-1.3b, train and decode) and qwen2-1.5b
  (whose qkv biases are split over ``model`` alone: their gradients are
  all-reduced blocks) trained on 2 x 4: each status `ok`, with products,
  bytes and a peak, and each train step's tally of the dense blocks'
  collectives equal to the blocks' own count of the bytes they gathered
  and summed (`DenseBlocks.stats`) in the same step;
* FLOPs linear in depth: the reference's extrapolation from depths 2 and
  4 gives depth 6's count exactly;
* on a 1 x 1 world a dense smoke config's FLOPs equal `train_flops`'
  reckoning, and with a memory layer they equal it plus the layer's
  lookup products run alone;
* the decode rank's cache against `cache_pspecs`' placement, and the
  run leaves JAX and the JAX package unloaded.

In process: a skipped cell's reason, and `--scan` / `--save-hlo`
refused with their reasons.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.launch import dryrun

REPO = Path(__file__).resolve().parents[1]

CODE = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun

    out = {}

    def cell(name, cfg, mode, mesh, s=32, b=8):
        out[name] = dryrun.run_cell(
            cfg.name, mode, False, cfg=cfg, cell=ShapeCell(mode, s, b, mode),
            mesh_shape=mesh)

    yi = configs.get_smoke_config("yi-9b")
    for mesh in ((2, 4), (2, 2, 2)):
        tag = "x".join(map(str, mesh))
        cell(f"yi/train/{tag}", yi, "train", mesh)
        cell(f"yi/prefill/{tag}", yi, "prefill", mesh)
        cell(f"yi/decode/{tag}", yi, "decode", mesh, s=64)
    cell("moe/train/2x4", configs.get_smoke_config("mixtral-8x7b"),
         "train", (2, 4))
    ssm = configs.get_smoke_config("mamba2-1.3b")
    cell("ssm/train/2x4", ssm, "train", (2, 4))
    cell("ssm/decode/2x4", ssm, "decode", (2, 4), s=64)
    cell("qwen/train/2x4", configs.get_smoke_config("qwen2-1.5b"), "train",
         (2, 4))
    for depth in (2, 4, 6):
        cell(f"depth{depth}", dataclasses.replace(yi, num_layers=depth),
             "train", (2, 4))
    cell("one/dense", yi, "train", (1, 1))
    cell("one/lram", configs.with_lram(yi, 16), "train", (1, 1))
    bad = sorted(n for n in sys.modules
                 if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps({"cells": out, "bad": bad}))
""")


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", CODE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


SMOKE = ["yi/train/2x4", "yi/prefill/2x4", "yi/decode/2x4",
         "yi/train/2x2x2", "yi/prefill/2x2x2", "yi/decode/2x2x2",
         "moe/train/2x4", "ssm/train/2x4", "ssm/decode/2x4",
         "qwen/train/2x4"]


@pytest.mark.parametrize("name", SMOKE)
def test_cells_run_and_count(run, name):
    art = run["cells"][name]
    assert art["status"] == "ok", art
    full = art["full_depth"]
    assert art["source"] == "full_depth"
    assert art["devices"] == (8 if "2x" in name else 1)
    assert full["flops_per_device"] > 0 and full["bytes_per_device"] > 0
    mem = full["memory_analysis"]
    assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes"] > 0
    # every dense leaf is split: each unit is gathered, so the step has
    # all-gathers; a train step also sums its gradients
    assert full["collective_counts"]["all-gather"] > 0
    assert full["total_wire_bytes_per_device"] > 0
    if art["shape"] == "train":
        assert full["collective_wire_bytes"].get("reduce-scatter", 0) > 0
        assert art["params_total"] > 0


@pytest.mark.parametrize("name", [n for n in SMOKE if "/train/" in n])
def test_tally_equals_the_blocks_own_count(run, name):
    art = run["cells"][name]
    blocks, tallied = art["dense_blocks"], art["dense_blocks_tallied"]
    assert blocks["gathered_bytes"] > 0 and blocks["summed_bytes"] > 0
    assert tallied == {k: blocks[k] for k in ("gathered_bytes",
                                              "summed_bytes")}
    assert blocks["units_held_peak"] == 1
    sites = art["full_depth"]["collective_by_site"]
    if name.startswith("qwen"):  # the biases split over model alone
        assert sites["dense_blocks"]["all-reduce"]["count"] > 0


def test_flops_linear_in_depth(run):
    f = {d: run["cells"][f"depth{d}"]["full_depth"]["flops_per_device"]
         for d in (2, 4, 6)}
    assert f[2] < f[4] < f[6]
    assert f[2] + (f[4] - f[2]) / (4 - 2) * (6 - 2) == f[6]


def test_one_rank_flops_equal_the_reckoning(run):
    dense = run["cells"]["one/dense"]
    assert dense["devices"] == 1 and dense["dense_blocks"] == {}
    assert dense["reckoned"]["memory_lookup_flops"] == 0
    assert dense["full_depth"]["flops_per_device"] == \
        dense["reckoned"]["train_flops"]
    lram = run["cells"]["one/lram"]
    rk = lram["reckoned"]
    assert rk["memory_lookup_flops"] > 0
    assert lram["full_depth"]["flops_per_device"] == \
        rk["train_flops"] + rk["memory_lookup_flops"]


def test_decode_cache_beside_its_placement(run):
    # yi-9b's smoke cache: 3 layers of k and v (B, 64, 2 kv heads, 16),
    # float32.  The rank holds its batch rows (B over the batch axes)
    # with every head; the placement splits B over ``data`` alone and
    # the kv heads over ``model`` where they divide, else head_dim
    row = 64 * 2 * 16 * 4 * 2 * 3
    for tag, rows, placed in (("2x4", 4, 8 // 2 * row // 4),
                              ("2x2x2", 2, 8 // 2 * row // 2)):
        art = run["cells"][f"yi/decode/{tag}"]
        assert art["batch_per_device"] == rows
        assert art["cache"] == {"held_bytes": rows * row,
                                "placed_bytes": placed}


def test_dry_run_loads_no_jax(run):
    assert run["bad"] == []


def test_skipped_cell_has_the_reference_reason():
    art = dryrun.run_cell("yi-9b", "long_500k", False, 20)
    assert art["status"] == "skipped"
    assert art["reason"].startswith("long_500k needs sub-quadratic")
    hybrid = dryrun.cell_config("zamba2-2.7b", 20)
    assert hybrid.lram is None and hybrid.name == "zamba2-2.7b"


@pytest.mark.parametrize("flag,why", [("--scan", "no lax.scan"),
                                      ("--save-hlo", "no HLO")])
def test_scan_and_save_hlo_are_refused(flag, why):
    with pytest.raises(SystemExit, match=why):
        dryrun.main(["--arch", "yi-9b", "--shape", "train_4k", flag])


def test_tiered_plans_are_refused():
    from repro_torch import configs
    cfg = configs.get_smoke_config("lram-tiered")
    with pytest.raises(ValueError, match="host memory"):
        dryrun._check_plan(cfg)
    dryrun._check_plan(dataclasses.replace(
        cfg, lram=dataclasses.replace(cfg.lram, interp_impl="pallas")))
