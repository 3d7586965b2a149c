"""Port parity: Adam (`repro_torch.optim`) against `repro.optim` on the same
tree, gradients and state: the 10x learning rate on `values` leaves, the
global-norm clip, decoupled weight decay and the schedules.  Parameters and
moments to rtol 1e-6 / atol 1e-7 (float32, the same operations; pow and
division may round differently in the last bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro_torch import optim

SHAPES = {"embed": (6, 4), "layer.kernel": (4, 3), "layer.bias": (3,),
          "memffn.lram.values": (16, 4), "memffn.lram.qnorm.scale": (4,)}


def _trees(seed: int, grad_scale: float):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (grad_scale * rng.normal(size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    return params, grads


def _nest(flat):
    """{"a.b": x} -> {"a": {"b": x}} (the reference's pytree paths)."""
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("kw,grad_scale", [
    ({}, 1.0),                                       # the paper's setting
    ({}, 0.01),                                      # below the clip
    ({"weight_decay": 0.1, "grad_clip": 0.0}, 1.0),  # decay, no clip
    ({"schedule": "cosine", "warmup_steps": 2, "total_steps": 5}, 1.0),
    ({"schedule": "linear", "total_steps": 4, "memory_lr_mult": 3.0}, 1.0),
])
def test_adam_matches_reference(kw, grad_scale):
    cfg = optim.OptimConfig(lr=1e-2, **kw)
    j_cfg = j_optim.OptimConfig(lr=1e-2, **kw)
    params, grads = _trees(len(kw), grad_scale)
    j_params = _nest({k: jnp.asarray(v) for k, v in params.items()})
    j_state = j_optim.adam_init(j_params)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = optim.adam_init(t_params)
    for g in grads:
        j_params, j_state, j_stats = j_optim.adam_update(
            _nest({k: jnp.asarray(v) for k, v in g.items()}), j_state,
            j_params, j_cfg)
        stats = optim.adam_update(
            t_params, {k: torch.from_numpy(v) for k, v in g.items()},
            t_state, cfg)
        np.testing.assert_allclose(stats["grad_norm"].item(),
                                   float(j_stats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(stats["lr"].item(), float(j_stats["lr"]),
                                   rtol=1e-6)
        for name, want in (("params", _flat(j_params)),
                           ("mu", _flat(j_state["mu"])),
                           ("nu", _flat(j_state["nu"]))):
            got = t_params if name == "params" else t_state[name]
            for k in SHAPES:
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} {k}")
    assert int(t_state["step"]) == int(j_state["step"]) == 3


def test_memory_values_get_the_memory_lr():
    """One step from zero moments moves each leaf by lr * mult (Adam's
    first step is sign(g) * lr): 10x for the `values` table only."""
    cfg = optim.OptimConfig(lr=1e-3, grad_clip=0.0)
    params = {"a.kernel": torch.zeros(3), "m.lram.values": torch.zeros(3)}
    grads = {k: torch.ones(3) for k in params}
    optim.adam_update(params, grads, optim.adam_init(params), cfg)
    np.testing.assert_allclose(params["a.kernel"].numpy(), -1e-3, rtol=1e-5)
    np.testing.assert_allclose(params["m.lram.values"].numpy(), -1e-2,
                               rtol=1e-5)


def test_missing_gradient_counts_as_zero():
    """A parameter the loss does not reach (grad None) moves as a zero
    gradient moves it in the reference: its moments decay."""
    params = {"w": torch.ones(2), "v": torch.ones(2)}
    state = optim.adam_init(params)
    cfg = optim.OptimConfig(lr=1e-2)
    optim.adam_update(params, {"w": torch.ones(2), "v": None}, state, cfg)
    np.testing.assert_allclose(params["v"].numpy(), 1.0)
    optim.adam_update(params, {"w": torch.ones(2), "v": torch.ones(2)},
                      state, cfg)
    assert (params["v"] < 1).all()
