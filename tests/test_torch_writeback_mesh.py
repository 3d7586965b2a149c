"""The tiered write-back on a mesh with 2 ``data`` ranks: every rank
applies the global batch's update, in the one-rank order, so every rank's
host tier ends equal to the one-rank run's (a tiered store's, and a
sharded-tiered store's, whose ranges are mapped and written back in turn
after the one gather over ``data``).

The reference applies the global batch's (idx, w ⊗ g) once to its one
store (`repro/memstore/interp.py:98-105`); the port's store gathers idx, w
and g over ``data`` before its write-back, and maps the gathered idx in
the forward so that its cache (fills, LRU order), which decides the
int8 requantization's draw order, is the one-rank run's too.  The
training CLI runs on 2 gloo ranks (data 2 x model 1) and on 1 rank
without a mesh, on the same seed and batches.
"""

import json
import os
import textwrap

import numpy as np
import pytest

from _ranks import run_ranks
from repro_torch import configs
from repro_torch.core import lookup
from repro_torch.launch import train
from repro_torch.models import transformer

ARGS = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
        "--seq", "32"]

RANK_CODE = textwrap.dedent("""
    import json, os
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.launch import train
    torch.set_num_threads(1)
    run = train.main(["--arch", os.environ["ARCH"], *json.loads(
        os.environ["ARGS"]), "--use-mesh"])
    store = run.stores[0]
    table = store.to_dense()
    scale = (np.concatenate([p._host_scale for p in getattr(
        store, "parts", [store])]) if store.quant != "none" else np.zeros(0))
    np.savez(os.path.join(os.environ["OUT"], f"rank{dist.get_rank()}.npz"),
             table=table, scale=scale, stats=json.dumps(store.stats))
    dist.destroy_process_group()
""")


def _store(run_or_model):
    return [s for _, s in lookup.find_stores(run_or_model)][0]


@pytest.fixture(scope="module", params=["lram-tiered", "lram-tiered-q8",
                                        "lram-sharded-tiered"])
def runs(request, tmp_path_factory):
    """(arch, the 2 ranks' results, the one-rank run's, the init table)."""
    arch = request.param
    out = tmp_path_factory.mktemp(arch)
    run_ranks(RANK_CODE, 2, out, timeout=120, env={
        "OUT": str(out), "ARCH": arch, "ARGS": json.dumps(ARGS)})
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    for r in ranks:
        r["stats"] = json.loads(str(r["stats"]))
    one = train.main(["--arch", arch, *ARGS])
    store = one.stores[0]
    single = {"table": store.to_dense(), "stats": dict(store.stats),
              "scale": getattr(store, "_host_scale", None)}
    init = _store(transformer.init(configs.get_smoke_config(arch),
                                   seed=0)).to_dense()
    return arch, ranks, single, init


def test_ranks_hold_the_same_host_tier(runs):
    """Bit-equal host tiers and equal stats on both data ranks."""
    _, ranks, _, _ = runs
    np.testing.assert_array_equal(ranks[0]["table"], ranks[1]["table"])
    assert ranks[0]["stats"] == ranks[1]["stats"]


def test_one_write_back_a_step_on_every_rank(runs):
    """One write-back a step, a range (every step touches both ranges of
    the sharded-tiered smoke table)."""
    arch, ranks, single, _ = runs
    want = 3 * (2 if arch == "lram-sharded-tiered" else 1)
    for r in ranks:
        assert r["stats"]["writebacks"] == want
    assert single["stats"]["writebacks"] == want
    # the forwards mapped the global batch: the one-rank run's traffic
    for key in ("lookups", "hits", "misses", "uncached", "fills",
                "evictions"):
        assert ranks[0]["stats"][key] == single["stats"][key], key


def test_host_tier_equals_the_one_rank_run(runs):
    """fp32: the update (tier - init) to float rounding, rtol 1e-5 / atol
    1e-7 on updates of ~1e-6 (the two runs' g differ by float rounding).
    int8: within one quantization step of the one-rank run's, per row's
    scale (a stochastic floor may flip where g differs in its last bits).
    Either way the update touched rows."""
    arch, ranks, single, init = runs
    got, want = ranks[0]["table"], single["table"]
    assert np.count_nonzero((want - init).any(-1)) > 0
    if arch != "lram-tiered-q8":
        np.testing.assert_allclose(got - init, want - init, rtol=1e-5,
                                   atol=1e-7)
    else:
        step = np.maximum(ranks[0]["scale"], single["scale"]).reshape(
            -1)[:, None]
        assert (np.abs(got - want) <= step * (1 + 1e-6)).all()
