"""Multi-pod dry-run of the port: one rank's step of every (arch x shape x
mesh) cell, run on `meta` tensors (torch counterpart of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --mesh both --lram-log2 20
    PYTHONPATH=src python -m repro_torch.analysis.roofline

The reference lowers and compiles each cell on a CPU placeholder
platform of 512 fake devices, never on the accelerator; so does the port,
by design: it runs on the `meta` device (tensors with a shape, a dtype
and no data) inside a one-process `fake` world (`torch.distributed`'s
fake backend: every collective returns at once) of 256 ranks (the 16 x
16 pod, data x model) or 512 (2 x 16 x 16, pod x data x model), as rank
0.  It never takes `cuda`.  For each cell it builds the port's own step
at the cell's full production shapes:

  train_4k     the trainer's step (`launch.train.build_train_step`: the
               forward and backward under `sharding.gathered`, the
               gradient sums, the clip and Adam on this rank's blocks);
  prefill_32k  `transformer.prefill` (forward + cache build);
  decode_32k / long_500k  `transformer.decode_step` (one token against a
               seq_len cache, this rank's).

The whole model is built on `meta`, placed by `sharding.shard_params`
(this rank's blocks of the split dense leaves), Adam's state made for
those blocks, and the rank's batch taken by `sharding.batch_slice`; a
decode rank holds the cache of its batch rows (all of them where the
batch does not divide over the data ranks, the long_500k B=1 case).
From that one run it writes the reference's artifact,
artifacts/torch_dryrun/<arch>__<shape>__<mesh>.json:

  * `flops_per_device`: `torch.utils.flop_counter`'s formulas (those of
    its `FlopCounterMode`), which count products only (mm, bmm, addmm,
    baddbmm, convolutions); XLA's cost analysis also counts elementwise
    work, so the two differ there;
  * `bytes_per_device`: every aten op's input and output bytes summed
    (a `TorchDispatchMode`; views, allocations and collectives move
    none): each op unfused, so an upper bound of the HBM traffic;
  * `memory_analysis`: the arguments' bytes (this rank's parameters,
    buffers, Adam state, batch or cache), the outputs' (and those that
    alias the arguments: updated in place), and the peak of live bytes,
    tracked on the meta storages (each op's new storages, freed when
    their last tensor goes, resized where the dense blocks drop and
    regather a unit);
  * the collectives the step issued (`analysis.collectives`: counts,
    result bytes and ring-model wire bytes a device, by op and by site);
  * `run_s`, `params_total` and `params_active`; for decode, the cache
    bytes the rank holds beside those `sharding.cache_pspecs`' placement
    would give it; for train, the bytes the dense blocks gathered and
    summed (`DenseBlocks.stats`) and the reckoned products and memory
    (`analysis.roofline.train_flops` / `train_bytes`, and the memory
    layer's lookup products, which `train_flops` does not count, run
    alone at the rank's shapes).

The port runs every layer as it is (no scan), so the counts are exact at
full depth: the artifact says `"source": "full_depth"` and carries no
depth extrapolation.  The multi-pod mesh is a placement proof, as in the
reference; the roofline reads the single-pod cells.  `--lram-log2 N`
inserts the paper's memory FFN (`configs.with_lram`, its default plan)
into every arch that takes one; a hybrid takes none inside its units
(the reference's rule), so a hybrid cell runs the arch as it is and its
artifact says so.  A tiered or sharded-tiered plan keeps its table in
host memory, which a meta run cannot hold, and raises.  `--scan` and
`--save-hlo` raise: the port has no `lax.scan` and no HLO.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs, optim
from repro_torch.analysis import collectives as coll_lib
from repro_torch.analysis import roofline
from repro_torch.configs import shapes as shapes_lib
from repro_torch.configs.shapes import ShapeCell
from repro_torch.core import lookup
from repro_torch.core import lram as lram_mod
from repro_torch.distributed import collectives, context, sharding
from repro_torch.launch import train
from repro_torch.models import transformer

ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "artifacts", "torch_dryrun",
)

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}

# ops that move no bytes: their outputs are allocations (or aliases)
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.new_empty.default, torch.ops.aten.new_empty_strided.default,
    torch.ops.aten.empty_like.default,
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(*trees) -> list[torch.Tensor]:
    """The tensors in `trees` (nested lists, tuples and dicts: an aten
    op's arguments and outputs, a step's state and outputs), in no set
    order; walked by hand, as this runs on every op."""
    out, stack = [], list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


class _Counts(TorchDispatchMode):
    """Each aten op's products (`flop_registry`'s formulas: what
    `FlopCounterMode` counts, without its module hooks) and input and
    output bytes summed, and the live bytes of the storages: those of
    `held` from the start, each op's new ones from their first output
    until their last tensor goes (a finalizer on the storage, which
    lives as long as any tensor or saved activation on it), resized
    through `resized`."""

    def __init__(self, held=()):
        super().__init__()
        self.flops, self.flops_by_op = 0, {}
        self.bytes = 0
        self.live: dict[int, int] = {}
        self.now = self.peak = 0
        for t in held:
            self._track(t)
        self.arguments = self.now

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self.live:
            return
        self.live[key] = s.nbytes()
        self.now += self.live[key]
        self.peak = max(self.peak, self.now)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def resized(self, s) -> None:
        key = id(s)
        if key in self.live:
            self.now += s.nbytes() - self.live[key]
            self.live[key] = s.nbytes()
            self.peak = max(self.peak, self.now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            key = str(func._overloadpacket)
            self.flops += n
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, _tensors(args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        return out


@contextlib.contextmanager
def _resizes_seen(counts: _Counts):
    """`UntypedStorage.resize_` reported to `counts` in the body (the
    dense blocks free a unit's whole leaves and gather them again into
    the same storage, `sharding.DenseBlocks`)."""
    resize = torch.UntypedStorage.resize_

    def resize_(self, size):
        out = resize(self, size)
        counts.resized(self)
        return out

    torch.UntypedStorage.resize_ = resize_
    try:
        yield
    finally:
        torch.UntypedStorage.resize_ = resize


@contextlib.contextmanager
def fake_world(world: int):
    """A one-process `torch.distributed` world of `world` ranks on the
    fake backend, this process rank 0; destroyed after the body.  The
    world is process-global: one at a time."""
    # the first list all-gather imports torch.distributed.tensor (some
    # 480 modules): imported here, not under the counters, whose modes
    # would see every op of the import
    import torch.distributed.tensor  # noqa: F401
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        context.set_mesh(None)
        dist.destroy_process_group()


def cell_config(arch: str, lram_log2: int = 0):
    """The cell's config: the arch, and with `lram_log2` the paper's
    memory FFN (`with_lram`, its default plan) where the arch takes one
    (a hybrid takes none: as it is)."""
    cfg = configs.get_config(arch)
    if lram_log2 and cfg.family != "hybrid":
        cfg = configs.with_lram(cfg, lram_log2)
    return cfg


def _check_plan(cfg) -> None:
    for plan in lookup.model_plans(cfg):
        if plan.placement in ("tiered", "sharded-tiered"):
            raise ValueError(
                f"{cfg.name}: the {plan.placement} plan keeps its table in "
                f"host memory (a tiered store), which a meta run cannot "
                f"hold; the dry-run takes the dense or sharded plans")


def _rows(n: int, mesh) -> int:
    """A data rank's rows of a global batch of `n`: n / data ranks, or
    all n where they do not divide (every data rank repeats them)."""
    axes = sharding.MeshAxes.for_mesh(mesh).fsdp
    d = math.prod(mesh.size(a) for a in axes if a in mesh.axis_names)
    return n // d if n % d == 0 else n


def build_step(cfg, cell: ShapeCell, mesh):
    """(step, held, info): `step()` runs one rank's step of the cell on
    `meta` tensors and returns its outputs and the tensors among its
    arguments it updates in place; `held` every tensor the rank holds as
    the step's arguments; `info` the model and the cell's per-rank
    shapes."""
    _check_plan(cfg)
    model = transformer.init(cfg, device="meta")
    sharding.shard_params(model, mesh)
    specs = shapes_lib.input_specs(cfg, cell)
    state = list(model.parameters()) + list(model.buffers())
    info = {"model": model, "rows": _rows(cell.global_batch, mesh)}

    if cell.mode == "train":
        params = dict(model.named_parameters())
        opt_state = optim.adam_init(params)
        step_fn = train.build_train_step(model, optim.OptimConfig(), mesh)
        batch = specs["batch"]  # global: the step takes its rows
        held = state + _tensors(opt_state) + _tensors(batch)

        def step():
            metrics = step_fn(opt_state, batch)
            return metrics, state + _tensors(opt_state)

        return step, held, info

    if cell.mode == "prefill":  # the rank's rows, in storage of their own
        batch = {k: v.clone() for k, v in
                 sharding.batch_slice(mesh, specs["batch"]).items()}

        def step():
            with torch.no_grad(), sharding.gathered(model):
                logits, cache = transformer.prefill(
                    model, batch["tokens"], cell.seq_len,
                    encoder_embeds=batch.get("encoder_embeds"),
                    vision_embeds=batch.get("vision_embeds"),
                    positions=batch.get("positions"))
            return (logits, cache), []

        return step, state + _tensors(batch), info

    rows = info["rows"]
    tokens = specs["tokens"][:rows].clone()
    axes = transformer.cache_batch_axes(cfg, cell.seq_len)
    cache = {name: {k: leaf.narrow(axes[name][k], 0, rows).clone()
                    for k, leaf in leaves.items()}
             for name, leaves in specs["cache"].items()}
    info["cache"] = {"held_bytes": sum(map(_nbytes, _tensors(cache))),
                     "placed_bytes": placed_cache_bytes(cfg, cell, mesh)}

    def step():
        with torch.no_grad(), sharding.gathered(model):
            logits = transformer.decode_step(model, tokens,
                                             cell.seq_len - 1, cache)
        return logits, _tensors(cache)

    return step, state + [tokens] + _tensors(cache), info


def placed_cache_bytes(cfg, cell: ShapeCell, mesh) -> int:
    """The bytes of a rank's cache under `sharding.cache_pspecs`: each
    leaf's global bytes over the ranks of the axes it is split on."""
    shapes = transformer.cache_shapes(cfg, cell.global_batch, cell.seq_len)
    specs = sharding.cache_pspecs(shapes, cfg, mesh)
    total = 0
    for name, leaves in shapes.items():
        for k, (shape, dtype) in leaves.items():
            split = math.prod(mesh.size(a) for a in
                              sharding.spec_axes(specs[name][k]))
            total += math.prod(shape) * dtype.itemsize // split
    return total


def memory_lookup_flops(model, tokens: int) -> tuple[float, dict]:
    """The products of the model's LRAM lookups (`lram_apply`: the
    torus map, the neighbour search and the interpolation, forward and
    backward) run alone on `tokens` meta queries a memory layer, and
    their split by op: what `train_flops` does not count of a memory
    layer."""
    total, by_op = 0.0, {}
    for layer in model.modules():
        if not isinstance(layer, lram_mod.MemFFN):
            continue
        x = torch.empty((tokens, layer.lram.cfg.in_dim), device="meta",
                        dtype=layer.wi.kernel.dtype, requires_grad=True)
        with _Counts() as counts:
            y = lram_mod.lram_apply(layer.lram, x, train=True)
            y.sum().backward()
        for p in layer.lram.parameters():
            p.grad = None
        total += counts.flops
        for op, n in counts.flops_by_op.items():
            by_op[op] = by_op.get(op, 0) + n
    return total, by_op


def measure(step, held):
    """Run `step` once under the counters: (FLOPs, bytes, memory and the
    collectives' tally; the step's outputs; the tally's
    `CollectiveStats`)."""
    counts = _Counts(held)
    t0 = time.perf_counter()
    with collectives.recording() as records, _resizes_seen(counts), \
            counts:
        out, aliased = step()
    step_s = time.perf_counter() - t0
    outs = _tensors(out)
    aliased = {id(t.untyped_storage()): t.untyped_storage()
               for t in aliased}
    stats = coll_lib.stats(records)
    return {
        "flops_per_device": float(counts.flops),
        "flops_by_op": counts.flops_by_op,
        "bytes_per_device": float(counts.bytes),
        "memory_analysis": {
            "argument_size_in_bytes": counts.arguments,
            "output_size_in_bytes": sum(map(_nbytes, outs)),
            "alias_size_in_bytes": sum(s.nbytes()
                                       for s in aliased.values()),
            "peak_live_bytes": counts.peak,
        },
        "collective_counts": stats.counts,
        "collective_raw_bytes": stats.raw_bytes,
        "collective_wire_bytes": stats.wire_bytes,
        "total_wire_bytes_per_device": stats.total_wire_bytes,
        "collective_by_site": stats.by_site,
        "step_s": step_s,
    }, out, stats


def run_config(cfg, cell: ShapeCell, mesh_shape, axes) -> dict:
    """One rank's step of `cfg` at `cell` on a mesh `mesh_shape` over
    `axes`, in a fake world of its ranks: the artifact's measured part
    (`measure`), plus the reckonings of a train cell and the cache bytes
    of a decode one."""
    t0 = time.perf_counter()
    with fake_world(math.prod(mesh_shape)):
        mesh = context.Mesh(tuple(mesh_shape), tuple(axes))
        context.set_mesh(mesh)
        step, held, info = build_step(cfg, cell, mesh)
        build_s = time.perf_counter() - t0
        full, out, stats = measure(step, held)
        model, rows = info["model"], info["rows"]
        res = {"devices": math.prod(mesh_shape),
               "mesh_shape": dict(zip(axes, mesh_shape)), "rank": 0,
               "batch_per_device": rows, "seq_len": cell.seq_len,
               "source": "full_depth", "full_depth": full,
               "build_s": build_s}
        if cell.mode == "train":
            # the dense blocks' own count of their bytes, and the tally's
            # of the same collectives (their site's records)
            res["dense_blocks"] = {k: out[k] for k in (
                "gathered_bytes", "summed_bytes", "units_held_peak")
                if k in out}
            res["dense_blocks_tallied"] = {
                "gathered_bytes": stats.gathered_bytes(sharding.SITE),
                "summed_bytes": stats.summed_bytes(sharding.SITE)}
            leaves = roofline.whole_leaves(model)
            blocks = sharding.dense_blocks(model)
            lookup_flops, lookup_by_op = memory_lookup_flops(
                model, rows * cell.seq_len)
            res["reckoned"] = {
                "train_flops": roofline.train_flops(
                    leaves, cfg, model.lm_head is None, rows, cell.seq_len),
                "memory_lookup_flops": lookup_flops,
                "memory_lookup_flops_by_op": lookup_by_op,
                "train_bytes": roofline.train_bytes(
                    leaves, cfg, rows * cell.seq_len,
                    model if blocks is not None else None)}
        if "cache" in info:
            res["cache"] = info["cache"]
    res["run_s"] = time.perf_counter() - t0
    return res


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             lram_log2: int = 0, *, cfg=None, cell: ShapeCell | None = None,
             mesh_shape: tuple[int, ...] | None = None) -> dict:
    """One dry-run cell: the arch at the shape's full production sizes,
    rank 0 of the 16 x 16 mesh (or 2 x 16 x 16 with `multi_pod`), its
    reference skip reason where it has one.  `cfg`, `cell` and
    `mesh_shape` (data x model, or pod x data x model) replace the
    production config, shape and mesh (a smoke cell)."""
    if mesh_shape is None:
        mesh_name = "multi" if multi_pod else "single"
        mesh_shape, axes = MESHES[mesh_name]
    else:
        mesh_name = "x".join(map(str, mesh_shape))
        axes = MESHES["single" if len(mesh_shape) == 2 else "multi"][1]
    cfg = cfg if cfg is not None else cell_config(arch, lram_log2)
    result = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
              "status": "ok"}
    if lram_log2 and cfg.lram is None and cfg.pkm is None:
        result["memory_layer"] = ("none: memory layers inside hybrid "
                                  "units are not supported (the "
                                  "reference's rule)")
    reason = shapes_lib.skip_reason(cfg, shape_name)
    if reason:
        result.update(status="skipped", reason=reason)
        return result
    cell = cell or shapes_lib.SHAPES[shape_name]
    result.update(run_config(cfg, cell, mesh_shape, axes))
    result.update(params_total=cfg.param_count(),
                  params_active=cfg.active_param_count())
    return result


def _artifact_path(arch, shape, mesh_name, lram_log2=0):
    name = arch if not lram_log2 else f"{arch}+lram{lram_log2}"
    return os.path.join(ARTIFACT_DIR, f"{name}__{shape}__{mesh_name}.json")


def main(argv=None):
    global ARTIFACT_DIR
    p = argparse.ArgumentParser(
        description="Dry-run of the port's step for every arch x shape x "
                    "mesh cell: rank 0 of a fake 256- or 512-rank world, "
                    "run on the meta device by design (never cuda), its "
                    "FLOPs, bytes, memory and collectives counted.")
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None,
                   choices=list(shapes_lib.SHAPES) + [None])
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--lram-log2", type=int, default=0,
                   help="insert the paper's LRAM block (memory slots 2^N)")
    p.add_argument("--force", action="store_true",
                   help="recompute cells that already have artifacts")
    p.add_argument("--scan", action="store_true",
                   help="refused: the port runs every layer (no lax.scan), "
                        "so its counts are exact at full depth")
    p.add_argument("--save-hlo", action="store_true",
                   help="refused: the port's step is torch, it has no HLO")
    p.add_argument("--out", default=ARTIFACT_DIR)
    args = p.parse_args(argv)
    if args.scan:
        raise SystemExit("--scan: the port has no lax.scan; it runs every "
                         "layer, so its counts are exact at full depth")
    if args.save_hlo:
        raise SystemExit("--save-hlo: the port's step is torch, not XLA: "
                         "there is no HLO to save (its collectives are "
                         "tallied where it issues them)")

    ARTIFACT_DIR = args.out
    os.makedirs(ARTIFACT_DIR, exist_ok=True)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in configs.ARCHS
                 for s in shapes_lib.SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    failures = 0
    t_all = time.perf_counter()
    for arch, shape in cells:
        for multi_pod in meshes:
            mesh_name = "multi" if multi_pod else "single"
            path = _artifact_path(arch, shape, mesh_name, args.lram_log2)
            if os.path.exists(path) and not args.force:
                print(f"[skip-cached] {path}")
                continue
            print(f"[cell] {arch} x {shape} x {mesh_name} ...", flush=True)
            try:
                res = run_cell(arch, shape, multi_pod, args.lram_log2)
            except Exception as e:
                res = {
                    "arch": arch, "shape": shape, "mesh": mesh_name,
                    "status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-3000:],
                }
                failures += 1
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            full = res.get("full_depth", {})
            print(f"  -> {res['status']} "
                  f"(run {res.get('run_s', '-')}s"
                  f", flops/dev {full.get('flops_per_device', '-')})",
                  flush=True)
    print(f"done; {failures} failures; "
          f"{time.perf_counter() - t_all:.1f} s")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
