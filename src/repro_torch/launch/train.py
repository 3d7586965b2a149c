"""Training entry point of the port (torch counterpart of
`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch lram-bert-medium --placement pallas --batch 8 --seq 256 \\
        --steps 20 --json                                  # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch lram-tiered --batch 8 --seq 64 --steps 20 --json
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch lram-bert-small --smoke --device cpu --json  # plain versions
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch lram-bert-medium --placement sharded --use-mesh \\
        --batch 8 --seq 256 --steps 20 --json   # data 2 x model 2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch lram-bert-medium --smoke --device cpu --placement sharded \\
        --use-mesh --mesh-shape 2x1x2 --compression int8 --steps 5 --json
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch lram-bert-pkm --smoke --device cpu --steps 20 \\
        --ckpt-dir /tmp/ckpt --ckpt-every 10 --simulate-failure-at 15
    # ...raises SimulatedFailure at step 15; the same command again prints
    # "resumed from step 10" and trains steps 10-19
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch lram-bert-medium --smoke --device cpu --placement sharded \\
        --use-mesh --steps 12 --ckpt-dir /tmp/ck --ckpt-every 6 \\
        --simulate-failure-at 9     # again without the last flag: resumes
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch lram-sharded-tiered --smoke --device cpu --json --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch lram-bert-medium --placement pallas --batch 8 --seq 256 \\
        --steps 20 --grow-at 10:21 --telemetry --json

config -> init (weights drawn on the CPU from `--seed`, then moved to
`--device`) -> train step (MLM/CLM loss, backward, Adam with the paper's
10x memory-value learning rate and one global-norm clip) over the
stateless synthetic data (`repro_torch.data`, seeded as the reference
seeds it) -> checkpoint / auto-resume -> heartbeat and straggler log ->
failure injection -> a final evaluation (held-out loss and fact recall).

`--ckpt-dir` keeps checkpoints there (`repro_torch.checkpoint`, the
reference's files and names: `launch.convert.reference_tree`): a save
every `--ckpt-every` steps, asynchronous (the host copy now, the write
in a thread; blocking with a tiered store), and after the last step
(unless that step's was one of them).  A launch with checkpoints in the
directory first restores the newest valid one (parameters, Adam's
moments and step, the batchnorm stats, every tiered store's shards,
streamed in after the cache was warmed, as the reference orders it),
prints `resumed from step N` and trains from step N; the data is
stateless in the step, so the losses go on as without the interruption.
`--simulate-failure-at N` waits for the pending save and raises
`SimulatedFailure` before step N.  A step slower than twice the running
median is a straggler (`distributed.fault`).

The device is `cuda` unless `--device cpu` is given; with no card it
raises rather than falling back.  `--placement` overrides the memory
layer's lookup placement as the serve CLI's does: `pallas` is the dense
table with the CUDA kernels (K2 + K1 forward, the backward kernel
`lookup_bwd`), `reference` the plain path (CPU only), `tiered` the tiered
store, `sharded-tiered` its row ranges, `sharded` the table's rows split
over the mesh's ``model`` axis.  A tiered table (`lram-tiered`,
`lram-tiered-q8`) trains through the store's write-back, as the reference
binds it: the store applies its own sparse SGD step at lr x
`--memory-lr-mult` (int8 rows requantized with stochastic rounding), Adam
and the clip never see it, and the stores are flushed at the end.  So
does a `ShardedTieredStore` (`lram-sharded-tiered`, or `--placement
sharded-tiered`), each row range through its own store.  A dense
quantized table is frozen and is refused: the reference trains a
quantized table only through the tiered write-back.
`--json` prints one line per step (loss, xent, the MoE router loss `aux`
(0 without experts), grad norm, lr, step ms and the cache hit rate of a
tiered table) and a summary.

`--use-mesh` under a launch of several ranks (torchrun: WORLD_SIZE > 1)
joins the process group and builds the host mesh (`launch.mesh`: data x
model, 4 ranks are 2 x 2, or `--mesh-shape` DxM or PxDxM with a ``pod``
axis); with one rank it trains without a mesh, as the reference does on
one device.  Every rank draws the whole model on the CPU from `--seed`,
keeps its block of every dense leaf the reference's GSPMD rules split
(FSDP over the batch axes, TP over ``model``) and its rows of a
`--placement sharded` table (`distributed.sharding.shard_params`), and
moves to its device.  A step takes the rank's slice of the global
batch and gathers the dense blocks whole one unit at a time (the
embedding, each layer, the head), in the forward and again in the
backward, releasing each after it; each unit's gradients are summed
over the batch axes into the rank's blocks as its backward ends (a
reduce-scatter), the rest in one all-reduce for the replicated leaves
and one for the table shard; the clip's global norm counts every
element once, and Adam steps the rank's blocks and rows alone.  The
losses it reports are the global batch's; `--json` lines add the
bytes the rank gathered and summed in the step and the most units it
held whole at once.  Rank 0 prints; every rank evaluates the whole eval
batch (a unit at a time), so that all of them issue the same
collectives.

`--compression int8|topk` codes the summed gradients with error feedback
before Adam (`optim.compression`), as the reference's step does.

`--ckpt-dir` on a mesh: every rank takes part in each save (every split
leaf, a dense block or a table's rows, and their moments are gathered
over their axes into the reference's global arrays,
`convert.reference_sharding`) and rank 0 alone writes, so the checkpoint
is a one-process run's, leaf for leaf.  On a relaunch every rank builds
and shards the model, restores (each keeping its blocks: the mesh's
shape may differ from the saving run's, or the run may have one
process); the ranks compare the steps they restored and
raise `CheckpointError` unless all found the same (a rank that fell back
alone would train from another step), and rank 0 prints `resumed from
step N`.  On `--simulate-failure-at` every rank waits for rank 0's
pending write at a barrier, then raises.

`--grow-at STEP:LOG2[,...]` grows the memory table to 2^LOG2 rows
before the step STEP (`repro_torch.memctl`: the tables, dense tables'
Adam moments, the write-back binding; the step and the compression
residual are rebuilt) and prints `{"grow": "2^LOG2", "step": STEP,
"pause_s": s}`; a relaunch applies the growths before the checkpoint's
step first (`catch_up`), so the restore finds the grown shapes.  The
row-sharded placement cannot grow and raises, as the reference does.
`--telemetry` counts the rows every LRAM segment reads on the device
(`memctl.telemetry_update` on the forward's indices) and prints the
utilisation report beside the log lines (`{"step": s,
"utilisation_report": rows}`); on a mesh the counts are summed over the
batch axes first, so they are the one-process run's.

`--metrics-dir DIR` arms `repro_torch.obs` as the serve CLI's does
(`DIR/metrics.jsonl`, `DIR/metrics.prom` at the end): every step is a
`train.step` span around the step and the host read of its loss that
ends it (so its `dur_s` is the step's time on the device, not the time
to issue it), a growth a `memctl.grow` span and event, a tiered store's
lookups and write-backs its `memstore.*` counters, and each `--telemetry`
report sets the gauges `train.util_dead_frac`, `train.util_hot_mass` and
`train.util_cold_frac` (the last segment's, as the reference's).
`--profile-dir` needs `--metrics-dir`; no span of the trainer is marked
for the profiler, as in the reference.  On a mesh only rank 0 arms obs
(its files, its spans and counters): the other ranks stay off.  The
reference's one JAX process sees every device, so it has one registry;
here each rank is a process with its own.

The trainer takes every config the reference's `train` takes: the public
archs' full configs in bfloat16 (float16 ones too, built in Python: no
flag takes a dtype, as in the reference; Adam's moments float32, the
update cast back to the leaf's dtype; the memory table in its own
dtype), an MoE arch
on a mesh of several batch ranks (its router loss is each rank's part of
the global batch's, `models.moe.router_loss`, so the step's sum over the
batch axes is the global loss) and a hybrid arch on a mesh (its shared
block and Mamba leaves split by the reference's rules, two stacked
axes).  As the reference's CLI, the trainer feeds no `encoder_embeds` or
`vision_embeds`: whisper-small's forward raises without them, and the
enc-dec and VLM archs train through `transformer.loss_fn` with the batch
extras.  `--json`'s summary gives the seconds the weights took to draw
and place (`init_s`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, data, memctl, obs, optim
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.core import lookup
from repro_torch.distributed import collectives, context, fault, sharding
from repro_torch.launch import convert
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import arm_obs, resolve_device
from repro_torch.models import transformer


def bind_stores(model: transformer.Transformer, lr: float) -> list:
    """The tiered stores of a model whose table trains by write-back, with
    their sparse SGD rate set to `lr` and their cache warmed (the
    reference's `bind_stores`); [] for other tables."""
    if not any(plan.table_update == "writeback"
               for plan in lookup.model_plans(model.cfg)):
        return []
    stores = [store for _, store in lookup.find_stores(model)]
    for store in stores:
        store.writeback_lr = lr
        store.warm()
    return stores


def lram_segments(cfg) -> list[str]:
    """The names of the LRAM memory segments (the telemetry's keys)."""
    return [f"seg{si}" for si, seg in enumerate(transformer.layer_plan(cfg))
            if seg[0] == "memory" and seg[2] == "lram"]


def telemetry_rows_per_bin(num_locations: int, *,
                           max_bins: int = 4096) -> int:
    """Rows a bin, so that a segment's counters hold at most `max_bins`
    bins (`num_locations` is a power of two: it divides)."""
    rpb = 1
    while num_locations // rpb > max_bins:
        rpb *= 2
    return rpb


def init_telemetry(cfg, device=None) -> dict:
    """One set of usage counters an LRAM segment (the carried `tel`)."""
    n = cfg.lram.num_locations
    rpb = telemetry_rows_per_bin(n)
    return {name: memctl.telemetry_init(n, rows_per_bin=rpb, device=device)
            for name in lram_segments(cfg)}


def reported_telemetry(tel: dict) -> dict:
    """`tel` as reported: on a mesh each rank counted its slice of the
    batch, so counts and EMA (linear in the hits) are summed over the
    batch axes into the one-process run's."""
    group = context.batch_group()
    if group is None:
        return tel
    return {name: {**t, **{k: collectives.all_reduce_(t[k].clone(), group)
                           for k in ("counts", "ema")}}
            for name, t in tel.items()}


def batch_to(batch: dict, device) -> dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).long().to(device)
            for k, v in batch.items()}


def build_train_step(model: transformer.Transformer,
                     opt_cfg: optim.OptimConfig, mesh=None,
                     compression: str = "none"):
    """`train_step(opt_state, batch) -> metrics`: loss and backward through
    the model, then Adam over every parameter, IN PLACE (parameters,
    moments, step counter and the batchnorm running stats).  The metrics
    are device tensors: loss, xent, aux, ntokens, grad_norm, lr.

    With a mesh (the ambient one, `context.set_mesh`) `batch` is the
    global batch: the step takes this data rank's slice and runs the
    forward and backward under `sharding.gathered`, which gathers the
    dense blocks whole one unit at a time (the embedding, each layer, the
    head), releases each after its forward, gathers it again for its
    backward and sums its gradients over the batch axes straight into
    this rank's blocks (`sharding.DenseBlocks`).  The step then sums the
    other gradients over the batch axes (one flattened all-reduce for the
    replicated dense leaves, one for the row shards of the tables), clips
    by the global norm (the blocks' and shards' squares summed over their
    axes: each element once) and steps Adam on its own blocks and rows.
    loss and xent are the global batch's (the parts summed over the batch
    axes); on a mesh with blocks the metrics also carry the bytes the
    rank gathered and summed in the step and the most units it held
    whole at once (`gathered_bytes`, `summed_bytes`, `units_held_peak`).

    `compression` ("int8", "topk") codes the summed gradients with error
    feedback before Adam (`optim.compress_gradients`, as the reference's
    step does): a row-sharded table's gradient and a dense block as
    their global arrays (the int8 scale and top-k's threshold the whole
    leaf's).  The residual mirrors the gradients (the blocks' shapes)
    from the first step on.

    `train_step(opt_state, batch, tel)` with a telemetry dict (from
    `init_telemetry`) also runs the loss with `collect_access` and adds
    each LRAM segment's indices to its counters, in place of the dict's
    entries."""
    params = dict(model.named_parameters())
    shards = sharding.sharded_tables(model, mesh)
    blocks = sharding.dense_blocks(model)
    # each dense block's group: the ranks its leaf is split over
    split = {k: mesh.group(sharding.spec_axes(s))
             for k, s in blocks.specs.items()} if blocks else {}
    batch_group = context.batch_group() if mesh is not None else None
    shard_group = (mesh.group(next(iter(shards.values()))) if shards
                   else None)
    comp = None  # the codec's state, made from the first step's gradients

    def train_step(opt_state, batch, tel=None):
        nonlocal comp
        batch = sharding.batch_slice(mesh, batch)
        if blocks is not None:
            before = dict(blocks.stats, units_held_peak=0,
                          shared_held_peak=0)
            blocks.stats.update(units_held_peak=0, shared_held_peak=0)
        with sharding.gathered(model):
            if tel is None:
                loss, metrics = transformer.loss_fn(model, batch, train=True)
            else:
                loss, metrics, accesses = transformer.loss_fn(
                    model, batch, train=True, collect_access=True)
                for name, (idx, _) in accesses.items():
                    tel[name] = memctl.telemetry_update(tel[name], idx)
            loss.backward()
            grads = {k: p.grad if p.grad is not None
                     else torch.zeros_like(p) for k, p in params.items()}
            for p in params.values():
                p.grad = None
        if batch_group is not None:  # the blocks are summed already
            collectives.all_reduce_flat_(
                [g for k, g in grads.items()
                 if k not in shards and k not in split], batch_group)
            collectives.all_reduce_flat_([grads[k] for k in shards],
                                         batch_group)
            for key in ("xent", "aux"):
                metrics[key] = collectives.all_reduce_(
                    metrics[key].detach().clone(), batch_group)
            loss = collectives.all_reduce_(loss.detach().clone(),
                                           batch_group)
        if compression != "none":
            if comp is None:
                comp = optim.compression_init(grads, compression)
            grads, comp = optim.compress_gradients(
                grads, comp,
                groups={**{k: shard_group for k in shards}, **split})
        stats = optim.adam_update(
            params, grads, opt_state, opt_cfg, sharded=tuple(shards),
            group=shard_group, split=split)
        if blocks is not None:
            stats.update({k: blocks.stats[k] - before[k] for k in (
                "gathered_bytes", "summed_bytes", "units_held_peak",
                "shared_held_peak")})
        return {**{k: v.detach() for k, v in metrics.items()}, **stats,
                "loss": loss.detach()}

    return train_step


@torch.no_grad()
def evaluate(model: transformer.Transformer, dcfg: data.DataConfig, *,
             steps: int = 4):
    """(mean held-out loss over `steps` batches, fact recall on the probe),
    the dense leaves gathered whole one unit at a time (a collective on a
    mesh: every rank evaluates the whole batches; no backward, so no
    unit is gathered twice)."""
    device = next(model.parameters()).device
    table = data.make_fact_table(dcfg)
    losses = []
    probe = batch_to(data.fact_eval_batch(dcfg, n=64, table=table), device)
    with sharding.gathered(model):
        for i in range(steps):
            batch = batch_to(data.get_batch(dcfg, step=10_000_000 + i,
                                            table=table), device)
            loss, _ = transformer.loss_fn(model, batch, train=False)
            losses.append(float(loss))
        pred = transformer.forward(model, probe).argmax(-1)
    mask = probe["labels"] != data.IGNORE
    recall = float((mask & (pred == probe["labels"])).sum() / mask.sum())
    return float(np.mean(losses)), recall


@dataclasses.dataclass
class TrainRun:
    """What `main` leaves behind: the trained model, the optimizer state,
    the step function (for one more, profiled, step), the data config,
    one record per step (from `start_step`, 0 or the step resumed from),
    the tiered stores it trained by write-back, the usage counters of
    `--telemetry` (as reported), the lifecycle events and the seconds
    the weights took to draw and place (`init_s`)."""

    model: transformer.Transformer
    opt_state: dict
    step_fn: object
    dcfg: data.DataConfig
    records: list
    final_eval_loss: float
    final_fact_recall: float
    stores: list
    start_step: int = 0
    telemetry: dict | None = None
    lifecycle: list = dataclasses.field(default_factory=list)
    init_s: float = 0.0


def same_step_on_every_rank(found: int | None) -> None:
    """Raise `CheckpointError` on every rank unless all of them restored
    the same step (None: nothing).  Each rank restores on its own and
    falls back past a checkpoint it cannot read, so one rank could resume
    from an older step than the others, and the run's collectives would
    then hang or mix steps."""
    steps: list = [None] * dist.get_world_size()
    dist.all_gather_object(steps, found)
    if len(set(steps)) > 1:
        raise CheckpointError(
            f"the ranks restored different steps (by rank: {steps})")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="lram-bert-small")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced same-family config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--memory-lr-mult", type=float, default=10.0)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--placement", default="",
                   choices=["", "reference", "pallas", "tiered", "sharded",
                            "sharded-tiered"],
                   help="override the memory arch's lookup placement")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--json", action="store_true",
                   help="one JSON line per step and a summary")
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint here; resume from the newest valid "
                        "checkpoint found")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--simulate-failure-at", type=int, default=-1,
                   help="raise SimulatedFailure before this step")
    p.add_argument("--use-mesh", action="store_true")
    p.add_argument("--mesh-shape", default="",
                   help="DxM (data x model) or PxDxM (pod x data x model); "
                        "default: the reference's host-mesh rule")
    p.add_argument("--compression", default="none",
                   choices=["none", "int8", "topk"],
                   help="code the summed gradients (error feedback)")
    p.add_argument("--grow-at", default="",
                   help="grow the memory table at these steps: "
                        "STEP:NEW_LOG2[,STEP:NEW_LOG2...]")
    p.add_argument("--telemetry", action="store_true",
                   help="count the memory rows read on the device and log "
                        "the utilisation report beside the loss")
    p.add_argument("--metrics-dir", default="",
                   help="arm the observability layer (repro_torch.obs): "
                        "spans stream to <dir>/metrics.jsonl, a Prometheus "
                        "textfile snapshot lands at <dir>/metrics.prom")
    p.add_argument("--profile-dir", default="",
                   help="torch.profiler capture dir for marked spans "
                        "(needs --metrics-dir)")
    return p


def main(argv=None) -> TrainRun:
    args = build_argparser().parse_args(argv)
    mesh = None
    if args.use_mesh and mesh_lib.world_size() > 1:
        mesh, device = mesh_lib.init_mesh(args.device,
                                          shape=args.mesh_shape or None)
    else:
        device = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    main_rank = mesh is None or dist.get_rank() == 0
    arm_obs(args, arm=main_rank)  # on a mesh the other ranks stay off
    if args.placement:
        if cfg.lram is None:
            raise SystemExit(f"--placement needs a memory arch; {cfg.name} "
                             f"has no LRAM layer")
        cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, interp_impl=args.placement))
    try:
        plans = lookup.model_plans(cfg)
    except lookup.LookupPlanError as e:  # unported, or sharded without a mesh
        raise SystemExit(str(e)) from None
    if (args.grow_at or args.telemetry) and cfg.lram is None:
        raise SystemExit(f"--grow-at and --telemetry need a memory arch; "
                         f"{cfg.name} has no LRAM layer")
    for plan in plans:
        if plan.table_update == "frozen":
            raise SystemExit(
                f"a {plan.placement} {plan.storage} table is frozen: the "
                f"reference trains a quantized table only through the "
                f"tiered store's write-back (use the tiered placement)")
    dcfg = data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, objective=cfg.objective, seed=args.seed,
    )
    opt_cfg = optim.OptimConfig(lr=args.lr,
                                memory_lr_mult=args.memory_lr_mult)
    t_init = time.perf_counter()
    model = transformer.init(cfg, seed=args.seed)
    if mesh is not None:  # every rank drew the whole model; keep its part
        sharding.shard_params(model, mesh)
    model = model.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t_init
    # a store's table is no Parameter: Adam and the clip never see it
    stores = bind_stores(model, args.lr * args.memory_lr_mult)
    opt_state = optim.adam_init(dict(model.named_parameters()))
    step_fn = build_train_step(model, opt_cfg, mesh, args.compression)
    controller = None
    if args.grow_at:
        controller = memctl.MemoryController(memctl.LifecyclePolicy(
            grow_at=memctl.parse_grow_at(args.grow_at)))

    def regrown():
        """After a growth: the write-back binding, the step (and with it
        the compression residual, which restarts at zero) anew."""
        nonlocal stores, step_fn
        stores = bind_stores(model, args.lr * args.memory_lr_mult)
        step_fn = build_train_step(model, opt_cfg, mesh, args.compression)

    start_step, mgr = 0, None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        latest = mgr.latest_step()
        # growths before the checkpoint's step come first, so the restore
        # target has the grown shapes
        if latest is not None and controller is not None \
                and controller.catch_up(latest, model, opt_state):
            regrown()
    # the split leaves (dense blocks, a row-sharded table's rows, their
    # moments): gathered on save, this rank's block kept on restore
    spread = convert.reference_sharding(model, opt_state)
    if args.ckpt_dir:
        found, tree = None, None
        if latest is not None:
            found, tree = mgr.restore(
                convert.reference_tree(model, opt_state, like=True),
                sharding=spread)
        if mesh is not None:
            same_step_on_every_rank(found)
        if tree is not None:
            convert.load_reference_tree(model, tree, opt_state)
            start_step = found
            if main_rank:
                print(f"resumed from step {start_step}", flush=True)

    tel = init_telemetry(model.cfg, device) if args.telemetry else None
    monitor = fault.HeartbeatMonitor(num_hosts=mesh_lib.world_size())
    timer = fault.StepTimer()
    records, saved = [], start_step
    for step in range(start_step, args.steps):
        if controller is not None \
                and controller.on_train_step(step, model, opt_state):
            regrown()
            spread = convert.reference_sharding(model, opt_state)
            if tel is not None:  # the appended bins start dead
                tel = {name: memctl.grow_telemetry(
                    t, model.cfg.lram.num_locations)
                    for name, t in tel.items()}
            ev = controller.events[-1]
            if main_rank:
                print(json.dumps({"grow": f"2^{ev['new_log2']}",
                                  "step": step, "pause_s": ev["pause_s"]}),
                      flush=True)
        if step == args.simulate_failure_at:
            if mgr:
                mgr.wait()
            if mesh is not None:  # no rank exits while rank 0 writes
                dist.barrier()
            raise fault.SimulatedFailure(
                f"injected failure at step {step} (relaunch to resume)")
        t0 = time.perf_counter()
        batch = batch_to(data.get_batch(dcfg, step=step), device)
        with obs.span("train.step", step=step):
            metrics = step_fn(opt_state, batch, tel)
            rec = {"step": step,
                   **{k: float(metrics[k])  # the host sync ends the step
                      for k in ("loss", "xent", "aux", "grad_norm", "lr")}}
        rec.update({k: metrics[k] for k in (
            "gathered_bytes", "summed_bytes", "units_held_peak",
            "shared_held_peak") if k in metrics})
        dt = time.perf_counter() - t0
        rec["step_ms"] = 1e3 * dt
        timer.record(dt)
        monitor.heartbeat(dist.get_rank() if mesh is not None else 0, dt)
        rec["straggler"] = timer.is_outlier(dt)
        if stores:
            rec["cache_hit"] = float(np.mean([s.hit_rate() for s in stores]))
        records.append(rec)
        if main_rank and args.json:
            print(json.dumps(rec), flush=True)
        elif main_rank and (step % args.log_every == 0
                            or step == args.steps - 1):
            print(json.dumps({"step": step, "loss": round(rec["loss"], 4),
                              "xent": round(rec["xent"], 4),
                              "grad_norm": round(rec["grad_norm"], 3),
                              "sec": round(dt, 3)})
                  + (" STRAGGLER" if rec["straggler"] else ""))
        if tel is not None and (step % args.log_every == 0
                                or step == args.steps - 1):
            # the dead / hot / cold shares beside the loss, a row set an
            # LRAM segment (the counters stay on the device between)
            for name, t in reported_telemetry(tel).items():
                if main_rank:
                    print(json.dumps({"step": step, "utilisation_report":
                                      memctl.utilisation_report(
                                          t, prefix=f"util_{name}")}),
                          flush=True)
                if obs.enabled():
                    s = memctl.utilisation_summary(t)
                    obs.gauge("train.util_dead_frac").set(s["dead_frac"])
                    obs.gauge("train.util_hot_mass").set(s["hot_mass"])
                    obs.gauge("train.util_cold_frac").set(s["cold_frac"])
        if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, convert.reference_tree(model, opt_state),
                     blocking=False, sharding=spread)
            saved = step + 1
        if args.eval_every and (step + 1) % args.eval_every == 0:
            eval_loss, recall = evaluate(model, dcfg)
            if main_rank:
                print(json.dumps({"eval_loss": round(eval_loss, 4),
                                  "fact_recall": round(recall, 4)}))

    if mgr:
        if saved != args.steps:  # else the last step's save is under way
            mgr.save(args.steps, convert.reference_tree(model, opt_state),
                     sharding=spread)
        mgr.wait()
    eval_loss, recall = evaluate(model, dcfg)
    for store in stores:
        store.flush()
    if main_rank:
        print(json.dumps({"final_eval_loss": round(eval_loss, 4),
                          "final_fact_recall": round(recall, 4)}))
    if args.metrics_dir and main_rank:
        obs.flush()
    if args.json and main_rank:
        steady = [r["step_ms"] for r in records[5:]] or \
            [r["step_ms"] for r in records]
        print(json.dumps({
            "arch": cfg.name, "device": str(device), "steps": args.steps,
            "tokens_per_step": args.batch * args.seq,
            "mesh": mesh.shape if mesh is not None else None,
            "init_s": init_s,
            "step_ms_median_after_5": float(np.median(steady))
            if steady else None,
            "final_eval_loss": eval_loss, "final_fact_recall": recall,
            "cache": [dict(s.stats, hit_rate=s.hit_rate()) for s in stores]
            or None,
        }), flush=True)
    return TrainRun(model, opt_state, step_fn, dcfg, records, eval_loss,
                    recall, stores, start_step,
                    None if tel is None else reported_telemetry(tel),
                    controller.events if controller is not None else [],
                    init_s)


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
