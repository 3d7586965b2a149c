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
`--json` prints one line per step (loss, xent, grad norm, lr, step ms and
the cache hit rate of a tiered table) and a summary.

`--use-mesh` under a launch of several ranks (torchrun: WORLD_SIZE > 1)
joins the process group and builds the host mesh (`launch.mesh`: data x
model, 4 ranks are 2 x 2); with one rank it trains without a mesh, as the
reference does on one device.  Every rank draws the whole model on the
CPU from `--seed`, keeps its rows of a `--placement sharded` table
(`distributed.sharding.shard_params`) and moves to its device; the dense
weights stay replicated.  A step takes the rank's slice of the global
batch, sums the gradients over ``data`` (one all-reduce for the dense
weights, one for the table shard), and clips by the global norm that
counts every table row once.  The losses it reports are the global
batch's.  Rank 0 prints; every rank evaluates the whole eval batch, so
that all of them issue the same collectives.

`--ckpt-dir` on a mesh: every rank takes part in each save (a
row-sharded table and its moments are gathered over ``model`` into the
reference's global arrays, `convert.reference_sharding`) and rank 0 alone
writes, so the checkpoint is a one-process run's, leaf for leaf.  On a
relaunch every rank builds and shards the model, restores (each keeping
its rows: the mesh's shape may differ from the saving run's, or the run
may have one process); the ranks compare the steps they restored and
raise `CheckpointError` unless all found the same (a rank that fell back
alone would train from another step), and rank 0 prints `resumed from
step N`.  On `--simulate-failure-at` every rank waits for rank 0's pending write at a
barrier, then raises.

Not ported yet, and refused with the ROADMAP item that ports them:
gradient compression, telemetry, memory growth and observability.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, data, optim
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.core import lookup
from repro_torch.distributed import collectives, context, fault, sharding
from repro_torch.launch import convert
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import resolve_device
from repro_torch.models import transformer

# flag -> (value that means "off", the ROADMAP item that ports it)
_NOT_PORTED = {
    "compression": ("none", "A3 (optim/compression.py)"),
    "telemetry": (False, "A10 (memctl telemetry)"),
    "grow_at": ("", "A10 (memctl growth)"),
    "metrics_dir": ("", "A13 (observability)"),
    "profile_dir": ("", "A13 (observability)"),
}


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


def batch_to(batch: dict, device) -> dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).long().to(device)
            for k, v in batch.items()}


def build_train_step(model: transformer.Transformer,
                     opt_cfg: optim.OptimConfig, mesh=None):
    """`train_step(opt_state, batch) -> metrics`: loss and backward through
    the model, then Adam over every parameter, IN PLACE (parameters,
    moments, step counter and the batchnorm running stats).  The metrics
    are device tensors: loss, xent, aux, ntokens, grad_norm, lr.

    With a mesh (the ambient one, `context.set_mesh`) `batch` is the
    global batch: the step takes this data rank's slice, sums the
    gradients over ``data`` (one flattened all-reduce for the replicated
    weights, one for the row shards of the tables), clips by the global
    norm (the shards' squares summed over their axis) and steps Adam on
    its own rows.  loss and xent are the global batch's (the parts summed
    over ``data``)."""
    params = dict(model.named_parameters())
    shards = sharding.sharded_tables(model, mesh)
    data_group = context.axis_group("data") if mesh is not None else None
    shard_group = (mesh.group(next(iter(shards.values()))) if shards
                   else None)

    def train_step(opt_state, batch):
        batch = sharding.batch_slice(mesh, batch)
        loss, metrics = transformer.loss_fn(model, batch, train=True)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if data_group is not None:
            collectives.all_reduce_flat_(
                [g for k, g in grads.items() if k not in shards], data_group)
            collectives.all_reduce_flat_([grads[k] for k in shards],
                                         data_group)
            for key in ("xent", "aux"):
                metrics[key] = collectives.all_reduce_(
                    metrics[key].detach().clone(), data_group)
            loss = collectives.all_reduce_(loss.detach().clone(), data_group)
        stats = optim.adam_update(params, grads, opt_state, opt_cfg,
                                  sharded=tuple(shards), group=shard_group)
        for p in params.values():
            p.grad = None
        return {**{k: v.detach() for k, v in metrics.items()}, **stats,
                "loss": loss.detach()}

    return train_step


@torch.no_grad()
def evaluate(model: transformer.Transformer, dcfg: data.DataConfig, *,
             steps: int = 4):
    """(mean held-out loss over `steps` batches, fact recall on the probe)."""
    device = next(model.parameters()).device
    table = data.make_fact_table(dcfg)
    losses = []
    for i in range(steps):
        batch = batch_to(data.get_batch(dcfg, step=10_000_000 + i,
                                        table=table), device)
        loss, _ = transformer.loss_fn(model, batch, train=False)
        losses.append(float(loss))
    probe = batch_to(data.fact_eval_batch(dcfg, n=64, table=table), device)
    pred = transformer.forward(model, probe).argmax(-1)
    mask = probe["labels"] != data.IGNORE
    recall = float((mask & (pred == probe["labels"])).sum() / mask.sum())
    return float(np.mean(losses)), recall


@dataclasses.dataclass
class TrainRun:
    """What `main` leaves behind: the trained model, the optimizer state,
    the step function (for one more, profiled, step), the data config,
    one record per step (from `start_step`, 0 or the step resumed from)
    and the tiered stores it trained by write-back."""

    model: transformer.Transformer
    opt_state: dict
    step_fn: object
    dcfg: data.DataConfig
    records: list
    final_eval_loss: float
    final_fact_recall: float
    stores: list
    start_step: int = 0


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
    # the reference's flags whose machinery is not ported: refused
    p.add_argument("--compression", default="none",
                   choices=["none", "int8", "topk"])
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--grow-at", default="")
    p.add_argument("--metrics-dir", default="")
    p.add_argument("--profile-dir", default="")
    return p


def _refuse_unported(args) -> None:
    for flag, (off, item) in _NOT_PORTED.items():
        if getattr(args, flag) != off:
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported to "
                             f"torch yet: ROADMAP {item}")


def main(argv=None) -> TrainRun:
    args = build_argparser().parse_args(argv)
    _refuse_unported(args)
    mesh = None
    if args.use_mesh and mesh_lib.world_size() > 1:
        mesh, device = mesh_lib.init_mesh(args.device)
    else:
        device = resolve_device(args.device)
    main_rank = mesh is None or dist.get_rank() == 0
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
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
    model = transformer.init(cfg, seed=args.seed)
    if mesh is not None:  # every rank drew the whole model; keep its rows
        sharding.shard_params(model, mesh)
    model = model.to(device)
    # a store's table is no Parameter: Adam and the clip never see it
    stores = bind_stores(model, args.lr * args.memory_lr_mult)
    opt_state = optim.adam_init(dict(model.named_parameters()))
    step_fn = build_train_step(model, opt_cfg, mesh)

    start_step, mgr = 0, None
    # a row-sharded table's leaves: gathered on save, this rank's rows kept
    # on restore
    spread = convert.reference_sharding(model, opt_state)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        found, tree = None, None
        if mgr.latest_step() is not None:
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

    monitor = fault.HeartbeatMonitor(num_hosts=mesh_lib.world_size())
    timer = fault.StepTimer()
    records, saved = [], start_step
    for step in range(start_step, args.steps):
        if step == args.simulate_failure_at:
            if mgr:
                mgr.wait()
            if mesh is not None:  # no rank exits while rank 0 writes
                dist.barrier()
            raise fault.SimulatedFailure(
                f"injected failure at step {step} (relaunch to resume)")
        t0 = time.perf_counter()
        batch = batch_to(data.get_batch(dcfg, step=step), device)
        metrics = step_fn(opt_state, batch)
        rec = {"step": step,
               **{k: float(metrics[k])  # the host sync ends the step
                  for k in ("loss", "xent", "grad_norm", "lr")}}
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
    if args.json and main_rank:
        steady = [r["step_ms"] for r in records[5:]] or \
            [r["step_ms"] for r in records]
        print(json.dumps({
            "arch": cfg.name, "device": str(device), "steps": args.steps,
            "tokens_per_step": args.batch * args.seq,
            "mesh": mesh.shape if mesh is not None else None,
            "step_ms_median_after_5": float(np.median(steady))
            if steady else None,
            "final_eval_loss": eval_loss, "final_fact_recall": recall,
            "cache": [dict(s.stats, hit_rate=s.hit_rate()) for s in stores]
            or None,
        }), flush=True)
    return TrainRun(model, opt_state, step_fn, dcfg, records, eval_loss,
                    recall, stores, start_step)


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
