"""Serving entry point of the port: a thin CLI over the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch lram-tiered \\
        --json                                          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch lram-tiered-q8 \\
        --json --device cpu --smoke                     # plain versions

Builds the model from `--seed` (weights drawn on the CPU, then moved to
`--device`), a mixed-length request trace (all requests queued at t=0),
and replays it through `repro_torch.serving.ServeEngine`.  The device is
`cuda` unless `--device cpu` is given; with no card it raises rather
than falling back.  `--warmup` runs every prefill bucket and one decode
tick before the trace, so its timings exclude each shape's first call.

`lram-tiered` and `lram-tiered-q8` serve on their own placement, `tiered`:
the table lives in host RAM, a device cache holds the hot shards, and the
gathers run the CUDA kernels (their plain versions on the CPU).  The
report's `cache` carries the store's hit rate, hits, misses, uncached
rows, fills and evictions; `--cache-slots` resizes the device cache (128
holds the whole full-width table).  `--placement` overrides the placement:
`pallas` serves from a dense table on the device with the CUDA kernels,
`reference` runs the plain path (CPU only).  `--ckpt-dir` restores the
newest valid checkpoint of that directory (one `repro_torch.launch.train`
or the reference's trainer wrote) into the model before serving: its
parameters and batchnorm stats, a tiered table streamed into the store in
place; it prints `{"restored_step": N}`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import convert, resolve_device
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="lram-tiered")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--mode", choices=["continuous", "static"],
                   default="continuous")
    p.add_argument("--batch", type=int, default=4,
                   help="decode slots (continuous) / batch size (static)")
    p.add_argument("--prompt-len", type=int, default=16,
                   help="max prompt length in the trace")
    p.add_argument("--gen", type=int, default=16,
                   help="max generation budget per request")
    p.add_argument("--requests", type=int, default=None,
                   help="trace size (default: 2x --batch)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--placement", default="",
                   choices=["", "reference", "pallas", "tiered", "sharded",
                            "sharded-tiered"],
                   help="override the memory arch's lookup placement")
    p.add_argument("--cache-slots", type=int, default=0,
                   help="device cache size of a tiered table, in shards "
                        "(default: the arch's TieredSpec)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--ckpt-dir", default="",
                   help="restore params from this checkpoint dir before "
                        "serving (e.g. one written by repro_torch.launch."
                        "train)")
    p.add_argument("--warmup", action="store_true",
                   help="run every prefill bucket and one decode tick "
                        "before the timed trace")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable summary document")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.placement:
        if cfg.lram is None:
            raise SystemExit(f"--placement needs a memory arch; {cfg.name} "
                             f"has no LRAM layer")
        cfg = dataclasses.replace(
            cfg, lram=dataclasses.replace(cfg.lram,
                                          interp_impl=args.placement)
        )
    if args.cache_slots:
        if cfg.lram is None or cfg.lram.tiered is None:
            raise SystemExit(f"--cache-slots needs a tiered arch; {cfg.name} "
                             f"has no TieredSpec")
        cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, tiered=dataclasses.replace(
                cfg.lram.tiered, cache_slots=args.cache_slots)))
    model = transformer.init(cfg, seed=args.seed).to(device)
    if args.ckpt_dir:
        step, restored = CheckpointManager(args.ckpt_dir).restore(
            convert.reference_tree(model, like=True))
        if restored is None:
            raise SystemExit(f"no restorable checkpoint in {args.ckpt_dir}")
        convert.load_reference_tree(model, restored)
        print(json.dumps({"restored_step": step}), flush=True)
    trace = synthetic_trace(
        np.random.default_rng(args.seed),
        2 * args.batch if args.requests is None else args.requests,
        vocab_size=cfg.vocab_size,
        max_prompt=args.prompt_len,
        max_gen=args.gen,
    )
    engine = ServeEngine(model, EngineConfig(
        slots=args.batch,
        max_len=args.prompt_len + args.gen,
        mode=args.mode,
    ))
    if args.warmup:
        engine.warmup()
    report = engine.run(trace)
    if args.json:
        print(json.dumps(report.summary(cfg.name)))
    else:
        print(json.dumps({
            "mode": report.mode,
            "device": str(device),
            "requests": len(report.requests),
            "generated_tokens": report.generated_tokens,
            "tokens_per_sec": round(report.tokens_per_sec, 2),
            "decode_p50_ms": round(report.p50_ms(), 3),
            "decode_p99_ms": round(report.p99_ms(), 3),
            "cache": report.cache,
        }))
    return report


if __name__ == "__main__":
    main()
