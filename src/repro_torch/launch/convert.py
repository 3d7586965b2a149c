"""The port's modules <-> the reference's (params, state) pytrees.

The input is the JAX pytree with every leaf already a numpy array (for
example `jax.tree.map(np.asarray, params)`), so this module imports no
JAX.  Keys map one to one onto the `Transformer`'s `state_dict`: nested
dict keys join with "." and the leading layer axis of a stacked ("run", n)
segment is split into n per-layer entries.  Dense kernels keep their
(in, out) layout.  Batchnorm running stats come from `state`.

The names, both ways (`reference_path` is the table; `state_dict_from_jax`
walks it backwards):

    port (state_dict key)               reference pytree path
    embed.embedding                     params/embed/embedding
    segments.seg0.<i>.attn.wq.kernel    params/segments/seg0/attn/wq/kernel,
                                        layer i of the stacked run
    segments.seg1.memffn.lram.values    params/segments/seg1/memffn/lram/values
    ....lram.values.q / .scale          .../lram/values/0 / 1 (QuantizedTable)
    ....memffn.lram.qnorm.mean          model_state/seg1/lram/qnorm/mean
    segments.seg1.pkm.values            params/segments/seg1/pkm/values
    segments.seg1.pkm.qnorm.var         model_state/seg1/qnorm/var
    Adam's mu / nu of <key>             opt/mu/<path> / opt/nu/<path>
    Adam's step                         opt/step

`reference_tree` builds the reference's tree from a model (and its Adam
state) with stacked runs, the form the checkpoint manager writes, and
`load_reference_tree` copies such a tree back, IN PLACE.  On a mesh a
row-sharded table (and its two moments) is this rank's rows: the
reference's tree holds the global array, so `reference_tree(like=True)`
gives the global shapes, `reference_sharding` names those leaves for the
checkpoint manager (which gathers them on save and keeps this rank's
rows on restore), and `load_reference_tree` keeps this rank's rows of a
global leaf it is given.

A memory layer's table (`...lram.values`) is an (N, m) fp32 array, or a
quantized table as ``{"q": payload, "scale": scales}``: the reference's
payload (int8, or float8_e4m3fn as its uint8 bytes) and per-row scales,
read from a `QuantizedTable` or, shard by shard, from a tiered store's
`shard_host` / `shard_scale_host`.  Each table is rebuilt in the layer's
own plan (`Parameter`, `QuantizedTable` or `TieredValueStore`); a payload
is carried bit for bit, never dequantized and requantized.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lookup
from repro_torch.core.lram import LRAM
from repro_torch.distributed import context, sharding
from repro_torch.launch import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

# a memory layer's FFN module, by kind ("memory", i, kind)
_MEMORY_MODULE = {"lram": "memffn", "pkm": "pkm"}
# a QuantizedTable's buffers, in the order of the reference's pytree children
_QUANT_CHILDREN = ("q", "scale")
_STATS = ("mean", "var")  # batchnorm running stats: the model state


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def state_dict_from_jax(params, state, cfg: ModelConfig
                        ) -> dict[str, torch.Tensor]:
    """The port's `state_dict` for the reference's (params, state)."""
    flat = _flatten({k: v for k, v in params.items() if k != "segments"})
    for si, seg in enumerate(transformer.layer_plan(cfg)):
        name = f"seg{si}"
        leaves = _flatten(params["segments"][name])
        if seg[0] == "run":
            for key, arr in leaves.items():
                if arr.shape[0] != seg[1]:
                    raise ValueError(f"{name}.{key}: expected {seg[1]} "
                                     f"stacked layers, got {arr.shape}")
                for i in range(seg[1]):
                    flat[f"segments.{name}.{i}.{key}"] = arr[i]
        else:
            for key, arr in leaves.items():
                flat[f"segments.{name}.{key}"] = arr
            # lram's state is {"lram": {"qnorm": ...}} under memffn; pkm's
            # {"qnorm": ...} under pkm
            module = _MEMORY_MODULE[seg[2]]
            for key, arr in _flatten(state.get(name, {})).items():
                flat[f"segments.{name}.{module}.{key}"] = arr
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in flat.items()}


def reference_path(key: str, cfg: ModelConfig) -> tuple[str, int | None]:
    """(the reference's pytree path, the layer's index in a stacked run or
    None) of a port `state_dict` key (or a tiered table's `...values`)."""
    parts = key.split(".")
    if parts[0] != "segments":
        return "params/" + "/".join(parts), None
    name = parts[1]
    seg = transformer.layer_plan(cfg)[int(name.removeprefix("seg"))]
    if seg[0] == "run":
        return f"params/segments/{name}/" + "/".join(parts[3:]), \
            int(parts[2])
    rest = parts[2:]
    if rest[-1] in _STATS and rest[-2] == "qnorm":  # drop memffn / pkm
        return f"model_state/{name}/" + "/".join(rest[1:]), None
    if rest[-1] in _QUANT_CHILDREN and rest[-2] == "values":
        rest = rest[:-1] + [str(_QUANT_CHILDREN.index(rest[-1]))]
    return f"params/segments/{name}/" + "/".join(rest), None


def _nest(flat: dict[str, object]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _moment_path(moment: str, path: str) -> str:
    return f"opt/{moment}/" + path.removeprefix("params/")


def reference_sharding(model: transformer.Transformer,
                       opt_state=None) -> dict[str, tuple]:
    """{reference leaf name: (mesh, axis)} of every leaf that holds this
    rank's rows of a table split over an axis of the ambient mesh (its
    payload or scales, and with `opt_state` its Adam moments): the
    checkpoint manager's `sharding`.  {} without a mesh."""
    mesh = context.get_mesh()
    out = {}
    for prefix, axis in sharding.sharded_tables(model, mesh).items():
        for key in model.state_dict(keep_vars=True):
            if key != prefix and not key.startswith(prefix + "."):
                continue
            path, _ = reference_path(key, model.cfg)
            out[path] = (mesh, axis)
            if opt_state is not None and key in opt_state["mu"]:
                for moment in ("mu", "nu"):
                    out[_moment_path(moment, path)] = (mesh, axis)
    return out


def reference_tree(model: transformer.Transformer, opt_state=None, *,
                   like: bool = False) -> dict:
    """The reference's tree of the model: {"params", "model_state"} and,
    with `opt_state`, "opt" ({"mu", "nu", "step"}).  A run's layers are
    stacked (a copy); every other leaf is the live tensor (on a mesh, a
    row-sharded table's are this rank's rows); a tiered store is the
    store itself, under params and under both moments, as the reference's
    Adam state holds the same node.  With `like` the leaves are meta
    tensors of the reference's shapes (a restore target): the global
    shape of a row-sharded leaf."""
    cfg = model.cfg
    groups: dict[str, list] = {}
    for key, t in model.state_dict(keep_vars=True).items():
        path, layer = reference_path(key, cfg)
        groups.setdefault(path, []).append((layer, t))
    # the state_dict does not carry a tiered store (at `...lram.values`)
    stores = {reference_path(k, cfg)[0]: s
              for k, s in lookup.find_stores(model)}
    spread = reference_sharding(model, opt_state) if like else {}

    def leaf(path, parts):
        layer, t = parts[0]
        if like:
            shape = (len(parts),) * (layer is not None) + tuple(t.shape)
            if path in spread:
                mesh, axis = spread[path]
                shape = (shape[0] * mesh.size(axis),) + shape[1:]
            return torch.empty(shape, dtype=t.dtype, device="meta")
        if layer is None:
            return t.detach()
        return torch.stack([x.detach() for _, x in
                            sorted(parts, key=lambda p: p[0])])

    flat = {path: leaf(path, parts) for path, parts in groups.items()}
    flat.update(stores)
    if opt_state is not None:
        for moment in ("mu", "nu"):
            per_path: dict[str, list] = {}
            for key, t in opt_state[moment].items():
                path, layer = reference_path(key, cfg)
                per_path.setdefault(_moment_path(moment, path),
                                    []).append((layer, t))
            flat.update({p: leaf(p, parts) for p, parts in per_path.items()})
            flat.update({_moment_path(moment, p): store
                         for p, store in stores.items()})
        step = opt_state["step"]
        flat["opt/step"] = (torch.empty((), dtype=step.dtype, device="meta")
                            if like else step.detach())
    tree = _nest(flat)
    tree.setdefault("model_state", {})  # no memory layer: an empty state
    return tree


def _as_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A restored leaf as a CPU tensor of `like`'s dtype (an fp8 payload
    arrives as its uint8 bytes)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if like.dtype == torch.float8_e4m3fn:
        return t.view(torch.float8_e4m3fn)
    return t.to(like.dtype)


@torch.no_grad()
def load_reference_tree(model: transformer.Transformer, tree: dict,
                        opt_state=None) -> None:
    """Copy a reference tree (numpy leaves, as `CheckpointManager.restore`
    returns it) into the model's parameters and batchnorm stats and, with
    `opt_state`, into Adam's moments and step, IN PLACE.  On a mesh a
    row-sharded leaf may be global (this rank's rows are kept) or this
    rank's rows already (a restore with `reference_sharding`).  Tiered
    stores were streamed in place by the restore itself."""
    cfg = model.cfg
    spread = reference_sharding(model, opt_state)

    def get(path: str):
        node = tree
        for p in path.split("/"):
            node = node[p]
        return node

    def fill(t: torch.Tensor, path: str, layer) -> None:
        arr = get(path)
        arr = arr if layer is None else arr[layer]
        if path in spread and arr.shape[0] != t.shape[0]:
            arr = sharding.own_rows(arr, *spread[path])
        t.copy_(_as_tensor(arr, t))

    for key, t in model.state_dict(keep_vars=True).items():
        fill(t, *reference_path(key, cfg))
    if opt_state is None:
        return
    for moment in ("mu", "nu"):
        for key, t in opt_state[moment].items():
            path, layer = reference_path(key, cfg)
            fill(t, _moment_path(moment, path), layer)
    opt_state["step"].copy_(torch.from_numpy(np.asarray(get("opt/step"))))


def _load_tables(model: transformer.Transformer,
                 flat: dict[str, torch.Tensor]) -> set[str]:
    """Rebuild every memory layer's table from its entries in `flat`
    (popped), in the layer's plan; returns the state_dict keys they fill."""
    filled = set()
    for name, layer in model.named_modules():
        if not isinstance(layer, LRAM):
            continue
        key = f"{name}.values"
        plan = lookup.resolve(layer.cfg)
        if key in flat:
            layer.values = plan.build_table(flat.pop(key))
        elif f"{key}.q" in flat:
            if plan.table_from_payload is None:
                raise ValueError(f"{key}: a quantized payload cannot fill "
                                 f"a table of {plan.storage} storage")
            layer.values = plan.table_from_payload(
                flat.pop(f"{key}.q").numpy(),
                flat.pop(f"{key}.scale").numpy())
        else:
            raise KeyError(f"no table for {key}")
        filled |= {k for k in model.state_dict() if k.startswith(key)}
    return filled


def model_from_jax(params, state, cfg: ModelConfig,
                   device="cuda") -> transformer.Transformer:
    """A `Transformer` holding the reference's weights, on `device`: the
    card unless the caller asks for "cpu".  Every key must match: the
    tables are rebuilt by `_load_tables`, the rest loaded as a state_dict."""
    device = resolve_device(device)
    model = transformer.Transformer(cfg)
    flat = state_dict_from_jax(params, state, cfg)
    filled = _load_tables(model, flat)
    missing, unexpected = model.load_state_dict(flat, strict=False)
    if unexpected or set(missing) - filled:
        raise KeyError(f"state_dict mismatch: missing "
                       f"{sorted(set(missing) - filled)}, unexpected "
                       f"{sorted(unexpected)}")
    return model.to(device)
