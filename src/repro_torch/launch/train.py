"""Training entry point of the port (torch counterpart of
`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch lram-bert-medium --placement pallas --batch 8 --seq 256 \\
        --steps 20 --json                                  # on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch lram-bert-small --smoke --device cpu --json  # plain versions

config -> init (weights drawn on the CPU from `--seed`, then moved to
`--device`) -> train step (MLM/CLM loss, backward, Adam with the paper's
10x memory-value learning rate and one global-norm clip) over the
stateless synthetic data (`repro_torch.data`, seeded as the reference
seeds it) -> a final evaluation (held-out loss and fact recall).

The device is `cuda` unless `--device cpu` is given; with no card it
raises rather than falling back.  `--placement` overrides the memory
layer's lookup placement as the serve CLI's does: `pallas` is the dense
table with the CUDA kernels (K2 + K1 forward, the backward kernel
`lookup_bwd`), `reference` the plain path (CPU only).  `--json` prints one
line per step (loss, xent, grad norm, lr, step ms) and a summary.

Not ported yet, and refused with the ROADMAP item that ports them:
checkpoints and failure injection, gradient compression, telemetry,
memory growth, meshes and observability.  Quantized and tiered tables
train through the store's write-back, also not ported (A6/A8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import configs, data, optim
from repro_torch.core import lookup
from repro_torch.launch import resolve_device
from repro_torch.models import transformer

# flag -> (value that means "off", the ROADMAP item that ports it)
_NOT_PORTED = {
    "ckpt_dir": ("", "A5/A9 (checkpoints)"),
    "ckpt_every": (100, "A5/A9 (checkpoints)"),
    "simulate_failure_at": (-1, "A5/A9 (resume from a checkpoint)"),
    "compression": ("none", "A3 (optim/compression.py)"),
    "telemetry": (False, "A10 (memctl telemetry)"),
    "grow_at": ("", "A10 (memctl growth)"),
    "use_mesh": (False, "A12 (distribution)"),
    "metrics_dir": ("", "A13 (observability)"),
    "profile_dir": ("", "A13 (observability)"),
}


def batch_to(batch: dict, device) -> dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).long().to(device)
            for k, v in batch.items()}


def build_train_step(model: transformer.Transformer,
                     opt_cfg: optim.OptimConfig):
    """`train_step(opt_state, batch) -> metrics`: loss and backward through
    the model, then Adam over every parameter, IN PLACE (parameters,
    moments, step counter and the batchnorm running stats).  The metrics
    are device tensors: loss, xent, aux, ntokens, grad_norm, lr."""
    params = dict(model.named_parameters())

    def train_step(opt_state, batch):
        loss, metrics = transformer.loss_fn(model, batch, train=True)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        stats = optim.adam_update(params, grads, opt_state, opt_cfg)
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
    the step function (for one more, profiled, step), the data config and
    one record per step."""

    model: transformer.Transformer
    opt_state: dict
    step_fn: object
    dcfg: data.DataConfig
    records: list
    final_eval_loss: float
    final_fact_recall: float


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
    # the reference's flags whose machinery is not ported: refused
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--simulate-failure-at", type=int, default=-1)
    p.add_argument("--compression", default="none",
                   choices=["none", "int8", "topk"])
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--grow-at", default="")
    p.add_argument("--use-mesh", action="store_true")
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
    device = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.placement:
        if cfg.lram is None:
            raise SystemExit(f"--placement needs a memory arch; {cfg.name} "
                             f"has no LRAM layer")
        cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, interp_impl=args.placement))
    for plan in lookup.model_plans(cfg):
        if plan.placement != "dense" or plan.storage != "fp32":
            raise SystemExit(
                f"training a {plan.placement} {plan.storage} table needs the "
                f"store's write-back, not ported to torch yet: ROADMAP "
                f"A6/A8")
    dcfg = data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, objective=cfg.objective, seed=args.seed,
    )
    opt_cfg = optim.OptimConfig(lr=args.lr,
                                memory_lr_mult=args.memory_lr_mult)
    model = transformer.init(cfg, seed=args.seed).to(device)
    opt_state = optim.adam_init(dict(model.named_parameters()))
    step_fn = build_train_step(model, opt_cfg)

    records = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        batch = batch_to(data.get_batch(dcfg, step=step), device)
        metrics = step_fn(opt_state, batch)
        rec = {"step": step,
               **{k: float(metrics[k])  # the host sync ends the step
                  for k in ("loss", "xent", "grad_norm", "lr")}}
        rec["step_ms"] = 1e3 * (time.perf_counter() - t0)
        records.append(rec)
        if args.json:
            print(json.dumps(rec), flush=True)
        elif step % args.log_every == 0 or step == args.steps - 1:
            print(json.dumps({"step": step, "loss": round(rec["loss"], 4),
                              "xent": round(rec["xent"], 4),
                              "grad_norm": round(rec["grad_norm"], 3),
                              "sec": round(rec["step_ms"] / 1e3, 3)}))
        if args.eval_every and (step + 1) % args.eval_every == 0:
            eval_loss, recall = evaluate(model, dcfg)
            print(json.dumps({"eval_loss": round(eval_loss, 4),
                              "fact_recall": round(recall, 4)}))

    eval_loss, recall = evaluate(model, dcfg)
    print(json.dumps({"final_eval_loss": round(eval_loss, 4),
                      "final_fact_recall": round(recall, 4)}))
    if args.json:
        steady = [r["step_ms"] for r in records[5:]] or \
            [r["step_ms"] for r in records]
        print(json.dumps({
            "arch": cfg.name, "device": str(device), "steps": args.steps,
            "tokens_per_step": args.batch * args.seq,
            "step_ms_median_after_5": float(np.median(steady))
            if steady else None,
            "final_eval_loss": eval_loss, "final_fact_recall": recall,
        }), flush=True)
    return TrainRun(model, opt_state, step_fn, dcfg, records, eval_loss,
                    recall)


if __name__ == "__main__":
    main()
