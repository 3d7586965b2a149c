"""Port parity for GPipe over a mesh axis (`distributed.pipeline`) and
the production mesh (`launch.mesh.make_production_mesh`), against the
JAX package: 4 `torch.distributed` ranks (fresh gloo processes) run
`pipeline_apply` over a ("pod",) mesh (4 stages, 4 microbatches) and
over the pod axis of a pod 2 x data 2 mesh (2 stages, each data rank its
own pipeline), forward and backward, against the reference's
`pipeline_apply` (its output, and `jax.grad` of a loss on it under
`jax.set_mesh`) on 4 fake JAX devices and against the stages applied in
sequence."""

import textwrap

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from conftest import run_in_subprocess
from repro_torch.distributed import pipeline

D, STAGES = 16, 4

REF_CODE = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import pipeline_apply

    inp = np.load("PATH/inputs.npz")
    Ws, x = jnp.asarray(inp["Ws"]), jnp.asarray(inp["x"])

    def stage(W, x):
        return jnp.tanh(x @ W)

    def run(Ws, x, mesh, m):
        return pipeline_apply(stage, Ws, x, mesh=mesh, axis="pod",
                              num_microbatches=m)

    out = {}
    for name, shape, axes, stages in (("four", (4,), ("pod",), 4),
                                      ("two", (2, 2), ("pod", "data"), 2)):
        mesh = jax.make_mesh(shape, axes)
        out[name] = np.asarray(run(Ws[:stages], x, mesh, stages))
        with jax.set_mesh(mesh):  # jax.grad of the shard_map needs it
            dW, dx = jax.grad(lambda W, h: jnp.sum(run(W, h, mesh, stages)
                                                   ** 2),
                              argnums=(0, 1))(Ws[:stages], x)
        out[name + "_dW"], out[name + "_dx"] = np.asarray(dW), np.asarray(dx)
    np.savez("PATH/ref.npz", **out)
""")

RANK_CODE = textwrap.dedent("""
    import os
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.distributed import context, pipeline
    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(1)
    out = os.environ["OUT"]
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=os.environ["TEST_INIT_METHOD"],
                            world_size=4, rank=rank)
    inp = np.load(os.path.join(out, "inputs.npz"))
    Ws, x = torch.from_numpy(inp["Ws"]), torch.from_numpy(inp["x"])

    def stage(W, h):
        return torch.tanh(h @ W)

    res = {}
    pod = context.Mesh((4,), ("pod",))
    res["four"] = pipeline.pipeline_apply(stage, Ws, x, mesh=pod,
                                          num_microbatches=4).numpy()
    grid = mesh_lib.make_host_mesh((2, 2), ("pod", "data"))
    # stacked as a dict of tensors with a leading stage dim
    res["two"] = pipeline.pipeline_apply(
        lambda p, h: stage(p["W"], h), {"W": Ws[:2]}, x, mesh=grid,
        axis="pod", num_microbatches=2).numpy()
    res["stage"] = pod.index("pod")
    res["two_stage"] = grid.index("pod")
    # the backward: a loss on the output, x and the stacked W requiring
    # grad; every rank's x.grad, and W.grad whose rows are the stages
    for name, mesh, stages in (("four", pod, 4), ("two", grid, 2)):
        W = Ws[:stages].clone().requires_grad_()
        h = x.clone().requires_grad_()
        y = pipeline.pipeline_apply(stage, W, h, mesh=mesh, axis="pod",
                                    num_microbatches=stages)
        (y ** 2).sum().backward()
        res[name + "_dW"], res[name + "_dx"] = W.grad.numpy(), h.grad.numpy()
    try:
        mesh_lib.make_production_mesh(multi_pod=True)
        res["production"] = ""
    except ValueError as e:
        res["production"] = str(e)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    Ws = (rng.normal(size=(STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(8, D)).astype(np.float32)
    np.savez(out / "inputs.npz", Ws=Ws, x=x)
    run_in_subprocess(REF_CODE.replace("PATH", str(out)), devices=4)
    run_ranks(RANK_CODE, 4, out, timeout=120, env={"OUT": str(out)})
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return Ws, x, dict(np.load(out / "ref.npz")), ranks


def _sequential(Ws, x):
    for W in Ws:
        x = np.tanh(x @ W)
    return x


def _sequential_grads(Ws, x):
    """(d W, d x) of sum(out ** 2), the stages applied in sequence (torch
    autograd on one process)."""
    W = torch.from_numpy(Ws).requires_grad_()
    h0 = torch.from_numpy(x).requires_grad_()
    h = h0
    for i in range(W.shape[0]):
        h = torch.tanh(h @ W[i])
    (h ** 2).sum().backward()
    return W.grad.numpy(), h0.grad.numpy()


@pytest.mark.parametrize("which,stages", [("four", 4), ("two", 2)])
def test_pipeline_matches_reference_and_sequential(runs, which, stages):
    """Every rank returns the whole output, within 1e-5 of the reference's
    `pipeline_apply` (4 fake JAX devices) and of the stages applied in
    sequence: 4 stages of 4 microbatches on ("pod",), and 2 stages of 2
    on the pod axis of pod 2 x data 2 (the stages' parameters a tensor
    with a leading stage dim, and a dict of such tensors)."""
    Ws, x, ref, ranks = runs
    want = _sequential(Ws[:stages], x)
    np.testing.assert_allclose(ref[which], want, rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r[which], ref[which], rtol=1e-5,
                                   atol=1e-5)
    assert sorted(int(r["stage"]) for r in ranks) == [0, 1, 2, 3]


@pytest.mark.parametrize("which,stages", [("four", 4), ("two", 2)])
def test_pipeline_gradients_match_reference_and_sequential(runs, which,
                                                           stages):
    """The backward of sum(out ** 2): every rank's d x is whole and each
    rank's d W holds its own stage's row alone (the others zero), within
    rtol 1e-5 / atol 1e-6 of the reference's `jax.grad` under
    `jax.set_mesh` (4 fake JAX devices) and of the stages applied in
    sequence: 4 stages of 4 microbatches on ("pod",), 2 of 2 on the pod
    axis of pod 2 x data 2."""
    Ws, x, ref, ranks = runs
    want_dW, want_dx = _sequential_grads(Ws[:stages], x)
    np.testing.assert_allclose(ref[which + "_dW"], want_dW, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ref[which + "_dx"], want_dx, rtol=1e-5,
                               atol=1e-6)
    for r in ranks:
        s = int(r["stage"] if which == "four" else r["two_stage"])
        dW = r[which + "_dW"]
        for want in (ref, {which + "_dW": want_dW, which + "_dx": want_dx}):
            np.testing.assert_allclose(r[which + "_dx"], want[which + "_dx"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(dW[s], want[which + "_dW"][s],
                                       rtol=1e-5, atol=1e-6)
        assert not np.delete(dW, s, axis=0).any()


def test_production_mesh_names_the_world_it_needs(runs):
    """`make_production_mesh(multi_pod=True)` in a launch of 4 ranks raises,
    naming the 512 ranks its 2 x 16 x 16 mesh needs."""
    for r in runs[3]:
        msg = str(r["production"])
        assert "needs a world of 512 ranks" in msg and "has 4" in msg


class _Mesh:
    """Four stages along ``pod``, no processes."""

    def size(self, axis):
        return 4

    def index(self, axis):
        return 0

    def group(self, axis):
        return None


def test_pipeline_refuses_grad_and_uneven_microbatches():
    """A batch that does not split into the microbatches raises, whether
    or not the input requires grad (the pipeline is differentiable: an
    input that requires grad is taken)."""
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_apply(lambda w, h: h, [None] * 4,
                                torch.zeros(6, D, requires_grad=True),
                                mesh=_Mesh(), num_microbatches=4)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_apply(lambda w, h: h, [None] * 4,
                                torch.zeros(6, D), mesh=_Mesh(),
                                num_microbatches=4)
