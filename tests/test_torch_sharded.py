"""Port parity for the `sharded` placement: the memory table's rows split
over the ``model`` axis of 4 `torch.distributed` ranks (gloo on the CPU,
a data 1 x model 4 mesh, each rank a fresh process), against the JAX
package.

One 4-rank launch computes, on the lram-bert-medium smoke layer's shapes
(2^16 rows, m 64, 4 heads): the sharded interp of fp32, int8 and fp8
tables in both kernel cells (``pallas``: the range gather's plain
version; ``reference``: plain autograd) with their gradients in w and
an fp32 shard, and `lram_apply`'s output, d values (each rank its shard)
and d x in train mode.  The references:
`gather_interp_ref` and `jax.grad` of the dense reference cell (the
reference's own sharded gradient is red under jax 0.9.0, ROADMAP C1), and
the reference's own `sharded_gather_interp` forward on 8 fake JAX devices.
The kernels themselves are held against their plain versions on the card
(`test_torch_cuda.py`, `chip_smoke.py`).
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _ranks import run_ranks
from conftest import run_in_subprocess
from repro.core import indexing as j_indexing
from repro.core import lram as j_lram
from repro.kernels import ref as j_ref
from repro_torch import quant
from repro_torch.core import lookup
from repro_torch.core.lram import LRAMConfig

LOG2, M, HEADS, RANKS = 16, 64, 4, 4
KINDS = ("fp32", "int8", "fp8")

RANK_CODE = textwrap.dedent("""
    import dataclasses, os
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.core import lookup, lram
    from repro_torch.distributed import context, sharding
    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(1)
    out_dir = os.environ["OUT"]
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=os.environ["TEST_INIT_METHOD"],
                            world_size=4, rank=rank)
    mesh = mesh_lib.make_host_mesh((1, 4))
    context.set_mesh(mesh)
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    idx = torch.from_numpy(inp["idx"])
    w = torch.from_numpy(inp["w"])
    res = {}
    for kernel in ("pallas", "reference"):
        for kind in ("fp32", "int8", "fp8"):
            cfg = lram.LRAMConfig(log2_locations=16, heads=4,
                                  query_norm="batch", interp_impl="sharded",
                                  lookup_kernel=kernel,
                                  table_quant="none" if kind == "fp32"
                                  else kind)
            layer = lram.LRAM(cfg)
            plan = lookup.resolve(cfg)
            layer.values = plan.build_table(torch.from_numpy(inp["values"]))
            sharding.shard_params(layer, mesh)
            with torch.no_grad():
                res[f"interp_{kernel}_{kind}"] = plan.interp(
                    layer.values, idx, w).numpy()
            if kind == "fp32":  # the hook's own gradients, in w and shard
                shard = layer.values.detach().requires_grad_()
                ww = w.clone().requires_grad_()
                (plan.interp(shard, idx, ww)
                 * torch.from_numpy(inp["gi"])).sum().backward()
                res[f"interp_dw_{kernel}"] = ww.grad.numpy()
                res[f"interp_dvalues_{kernel}"] = shard.grad.numpy()
        # the layer in train mode on the dense reference's weights
        layer = lram.LRAM(dataclasses.replace(cfg, table_quant="none"))
        sd = {k: torch.from_numpy(inp[k]) for k in
              ("qnorm.scale", "qnorm.bias", "qnorm.mean", "qnorm.var")}
        layer.load_state_dict({**sd, "values": torch.from_numpy(
            inp["values"])})
        sharding.shard_params(layer, mesh)
        x = torch.from_numpy(inp["x"]).requires_grad_()
        y = lram.lram_apply(layer, x, train=True)
        (y * torch.from_numpy(inp["g"])).sum().backward()
        res[f"y_{kernel}"] = y.detach().numpy()
        res[f"dx_{kernel}"] = x.grad.numpy()
        res[f"dvalues_{kernel}"] = layer.values.grad.numpy()
        res[f"mean_{kernel}"] = layer.qnorm.mean.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
""")

JAX_SHARDED = textwrap.dedent("""
    import os, numpy as np, jax, jax.numpy as jnp
    from repro import quant
    from repro.distributed.sharded_lram import sharded_gather_interp
    out_dir = os.environ["OUT"]
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    interp = sharded_gather_interp(mesh, axis="model")
    idx, w = jnp.asarray(inp["idx"]), jnp.asarray(inp["w"])
    res = {"fp32": np.asarray(interp(jnp.asarray(inp["values"]), idx, w))}
    for kind in ("int8", "fp8"):
        table = quant.QuantizedTable.from_dense(inp["values"], kind)
        res[kind] = np.asarray(interp(table, idx, w))
    np.savez(os.path.join(out_dir, "jax_sharded.npz"), **res)
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs from a seed, the JAX references, and the ranks' results."""
    out = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    spec = j_indexing.choose_torus(LOG2)
    values = (rng.normal(size=(2**LOG2, M)) * 0.5).astype(np.float32)
    q = (rng.uniform(size=(6, HEADS, 8)) * np.array(spec.K)).astype(
        np.float32)
    idx, w = j_lram.indices_and_weights(jnp.asarray(q), spec, 32)
    j_cfg = j_lram.LRAMConfig(log2_locations=LOG2, heads=HEADS,
                              query_norm="batch")
    params, state = j_lram.lram_init(jax.random.PRNGKey(3), j_cfg)
    params["values"] = jnp.asarray(values)
    x = rng.normal(size=(2, 3, 16 * HEADS)).astype(np.float32)
    g = rng.normal(size=(2, 3, M * HEADS)).astype(np.float32)
    gi = rng.normal(size=(6, HEADS, M)).astype(np.float32)
    np.savez(out / "inputs.npz", values=values, idx=np.asarray(idx),
             w=np.array(w), x=x, g=g, gi=gi,
             **{f"qnorm.{k}": np.asarray(params["qnorm"][k])
                for k in ("scale", "bias")},
             **{f"qnorm.{k}": np.asarray(state["qnorm"][k])
                for k in ("mean", "var")})

    def j_loss(p, xx):
        y, st = j_lram.lram_apply(p, state, xx, j_cfg, train=True)
        return jnp.sum(y * g), (y, st)

    (_, (j_y, j_st)), (j_gp, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    j_dvalues, j_dw = jax.grad(lambda v, ww: jnp.sum(
        j_ref.gather_interp_ref(v, idx, ww) * gi), argnums=(0, 1))(
        jnp.asarray(values), w)
    want = {"gather": np.asarray(j_ref.gather_interp_ref(
                jnp.asarray(values), idx, w)),
            "interp_dvalues": np.asarray(j_dvalues),
            "interp_dw": np.asarray(j_dw),
            "y": np.asarray(j_y), "dx": np.asarray(j_gx),
            "dvalues": np.asarray(j_gp["values"]),
            "mean": np.asarray(j_st["qnorm"]["mean"]),
            "w": np.array(w)}
    run_in_subprocess(f"import os\nos.environ['OUT'] = {str(out)!r}\n"
                      + JAX_SHARDED, devices=8, timeout=120)
    run_ranks(RANK_CODE, RANKS, out, timeout=120, env={"OUT": str(out)})
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]
    return want, dict(np.load(out / "jax_sharded.npz")), ranks, values


@pytest.mark.parametrize("kernel", ["pallas", "reference"])
def test_sharded_gather_matches_gather_interp_ref(run, kernel):
    """The 4-way sharded fp32 gather equals the dense reference gather on
    every rank (1e-5: float32 sums in another order, partials summed)."""
    want, _, ranks, _ = run
    for r in ranks:
        np.testing.assert_allclose(r[f"interp_{kernel}_fp32"],
                                   want["gather"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["pallas", "reference"])
def test_sharded_interp_gradients_match_dense_jax(run, kernel):
    """The interp hook's gradients on CPU shards: d w (each rank's partial
    summed over the model group) on every rank, and d values (the 4
    shards put back in order), against jax.grad of `gather_interp_ref` on
    the whole table (1e-5)."""
    want, _, ranks, _ = run
    dvalues = np.concatenate([r[f"interp_dvalues_{kernel}"] for r in ranks])
    np.testing.assert_allclose(dvalues, want["interp_dvalues"], rtol=1e-5,
                               atol=1e-5)
    assert np.abs(want["interp_dw"]).max() > 1e-2
    for r in ranks:
        np.testing.assert_allclose(r[f"interp_dw_{kernel}"],
                                   want["interp_dw"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["pallas", "reference"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_sharded_quantized_gather_within_bound(run, kernel, kind):
    """A 1-byte sharded table stays within `quant.max_abs_error_bound` of
    the fp32 gather, as the reference's plan matrix asks."""
    want, _, ranks, values = run
    _, scale = quant.quantize_rows_np(values, kind)
    bound = quant.max_abs_error_bound(scale, want["w"], kind)
    for r in ranks:
        err = np.abs(r[f"interp_{kernel}_{kind}"] - want["gather"]).max()
        assert err <= bound + 1e-6


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_gather_matches_the_references_sharded_forward(run, kind):
    """The reference's own `sharded_gather_interp` forward (2 x 4 fake JAX
    devices; it works under jax 0.9.0, only its gradient is red, C1) and
    the port's pallas cell agree: fp32 to 1e-5; 1-byte tables, quantized
    alike (payloads are bit-equal), to 1e-5 too."""
    _, j_sharded, ranks, _ = run
    for r in ranks:
        np.testing.assert_allclose(r[f"interp_pallas_{kind}"],
                                   j_sharded[kind], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["pallas", "reference"])
def test_sharded_lram_apply_gradients_match_dense_jax(run, kernel):
    """lram_apply in train mode in the sharded cell: y (1e-5), the running
    mean (1e-6), d x and d values (the 4 shards put back in order) against
    jax.grad of the dense reference cell, to rtol 1e-4 / atol 1e-4 (the
    reference's own sharded-vs-dense bound, test_distributed.py)."""
    want, _, ranks, _ = run
    dvalues = np.concatenate([r[f"dvalues_{kernel}"] for r in ranks])
    np.testing.assert_allclose(dvalues, want["dvalues"], rtol=1e-4,
                               atol=1e-4)
    assert np.abs(want["dvalues"]).max() > 1e-2
    for r in ranks:
        np.testing.assert_allclose(r[f"y_{kernel}"], want["y"], atol=1e-5)
        np.testing.assert_allclose(r[f"mean_{kernel}"], want["mean"],
                                   atol=1e-6)
        np.testing.assert_allclose(r[f"dx_{kernel}"], want["dx"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("storage", ["none", "int8"])
def test_sharded_plan_without_a_mesh_raises(storage):
    """The twin of the reference's test_sharded_without_mesh_raises_plan_
    error: without an ambient mesh the sharded cell fails at resolve time,
    naming the mesh it needs."""
    with pytest.raises(lookup.LookupPlanError, match="needs an ambient mesh"):
        lookup.resolve(LRAMConfig(log2_locations=LOG2, heads=HEADS,
                                  interp_impl="sharded", table_quant=storage))


def test_sharded_tiered_still_raises_naming_its_item():
    with pytest.raises(lookup.LookupPlanError, match="A12 part 2"):
        lookup.resolve(LRAMConfig(log2_locations=LOG2,
                                  interp_impl="sharded-tiered"))

