"""Serving entry point of the port: a thin CLI over the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch lram-tiered \\
        --json                                          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch lram-tiered-q8 \\
        --json --device cpu --smoke                     # plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --arch lram-tiered \\
        --placement pallas --spill-at-tick 8 --warmup --json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch lram-tiered \\
        --smoke --device cpu --rate 4 --fixed-len --json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --device cpu --json                     # a public arch
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --smoke --device cpu --json                     # an SSM
    PYTHONPATH=src python -m repro_torch.launch.serve --arch lram-tiered \\
        --smoke --device cpu --tenants 4 --overlay-dir /tmp/ov --json

Builds the model from `--seed` (weights drawn on the CPU, then moved to
`--device`), a request trace (mixed lengths, or every request at
`--prompt-len` / `--gen` with `--fixed-len`; all queued at t=0, or
Poisson arrivals at `--rate` requests a second, which the engine
honours), and replays it through `repro_torch.serving.ServeEngine`.  The device is
`cuda` unless `--device cpu` is given; with no card it raises rather
than falling back.  `--warmup` prefills once at every length the
trace's prompts are prefilled at (their buckets; a sliding-window
arch's or an SSM's exact lengths) and runs one decode tick before the
trace, so its timings exclude each shape's first call.

`--arch` takes the public archs of the dense family (`yi-9b`,
`qwen2-1.5b`, `starcoder2-3b`, `h2o-danube-3-4b`), the MoE family
(`phi3.5-moe-42b-a6.6b`, `mixtral-8x7b`), the SSM family (`mamba2-1.3b`)
and the hybrid (`zamba2-2.7b`; both prefilled at exact lengths); full
configs in bfloat16, `--smoke` in float32, as the reference's CLI does
(no flag takes a dtype; a float16 model or table is a config built in
Python, `dataclasses.replace(cfg, dtype="float16")`):
they have no memory layer, so `--placement` and the memory flags are
refused for them.  The enc-dec and VLM archs (`whisper-small`,
`qwen2-vl-72b`) raise the engine's ValueError, as the reference's CLI
does.

`lram-tiered` and `lram-tiered-q8` serve on their own placement, `tiered`:
the table lives in host RAM, a device cache holds the hot shards, and the
gathers run the CUDA kernels (their plain versions on the CPU).
`lram-sharded-tiered` serves on `sharded-tiered`: 4 row ranges, each a
tiered store with its own cache, warmed and prefetched range by range.
The report's `cache` carries the stores' hit rate, hits, misses, uncached
rows, fills and evictions; `--cache-slots` resizes the device cache of a
tiered store or of every range (128 holds the whole full-width
`lram-tiered` table, 32 the whole `lram-sharded-tiered` one).
`--placement` overrides the placement: `pallas` serves from a dense table
on the device with the CUDA kernels, `sharded-tiered` from the row
ranges, `reference` runs the plain path (CPU only).  `--ckpt-dir` restores the
newest valid checkpoint of that directory (one `repro_torch.launch.train`
or the reference's trainer wrote) into the model before serving: its
parameters and batchnorm stats, a tiered table streamed into the store in
place; it prints `{"restored_step": N}`.  A mesh run's checkpoint holds
the global arrays, so it serves as a one-process run's does.
`--grow-to LOG2` grows the memory table to 2^LOG2 rows before that
restore (`repro_torch.memctl.grow_model`): it serves a checkpoint of a
`train --grow-at` run.

The decode tick runs as one CUDA graph where the placement allows it
(the dense `pallas` cells; `serving.engine`); the report's `cuda_graph`
and `graph_captures` say so.  `--hbm-budget-mb` and `--spill-at-tick`
build a `MemoryController` that spills a dense table to the tiered store
between decode ticks with requests in flight (the arch's own
`TieredSpec` where it has one), then prints `{"lifecycle": [events]}`.

Per-tenant memory overlays, as the reference's flags: `--tenants N`
gives each request of the trace a tenant of a pool of N, and the engine
serves each through its copy-on-write overlay of the table
(`--overlay-rows`, 8 a layer by default when `--tenants` > 0; the decode
tick writes back at `--overlay-write-lr`).  `--overlay-ttl` and
`--overlay-budget-kb` add the controller's overlay lifecycle (idle
tenants expire, the least recently used spill beyond the budget), and
`--overlay-dir` (default `<--ckpt-dir>/overlays` with a checkpoint) is
where overlays spill, where they are restored from at the start (it
prints `{"restored_overlays": n}`) and saved to at the end.  The report's
`overlay` carries the manager's summary.

`--metrics-dir DIR` arms `repro_torch.obs` before the model is built:
the engine's, the stores' and the controller's spans and lifecycle
events go to `DIR/metrics.jsonl` as they happen, and at the end one
snapshot of the registry is appended there and the Prometheus textfile
`DIR/metrics.prom` written (the reference's schema and files); the
`--json` summary's `metrics` carries the registry.  `--profile-dir DIR`
writes a `torch.profiler` trace of the `serve.run` span into DIR (a
Chrome / Perfetto JSON trace, not the reference's XLA trace); it needs
`--metrics-dir`, and exits without it (the reference ignores it then).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import configs, memctl, obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import arm_obs, convert, resolve_device
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="lram-tiered",
                   help="a memory arch (lram-tiered, lram-tiered-q8, "
                        "lram-sharded-tiered) or a public one (dense, MoE, "
                        "SSM: repro_torch.configs.ARCHS)")
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
    p.add_argument("--rate", type=float, default=0.0,
                   help="offered load in requests/sec (0 = all at t=0)")
    p.add_argument("--fixed-len", action="store_true",
                   help="pin every request to (--prompt-len, --gen) instead "
                        "of the mixed-length trace")
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
    p.add_argument("--grow-to", type=int, default=0, metavar="LOG2",
                   help="grow the memory table to 2^LOG2 locations before "
                        "restoring (serve a --grow-at run's checkpoint)")
    p.add_argument("--hbm-budget-mb", type=float, default=0.0,
                   help="spill a dense memory table to the tiered store "
                        "when its size exceeds this budget (between decode "
                        "ticks)")
    p.add_argument("--spill-at-tick", type=int, default=-1,
                   help="spill dense->tiered at this decode tick")
    p.add_argument("--warmup", action="store_true",
                   help="run every prefill bucket and one decode tick "
                        "before the timed trace")
    p.add_argument("--tenants", type=int, default=0,
                   help="give each request of the trace a tenant of a pool "
                        "of this size (per-tenant memory overlays; 0 = "
                        "anonymous trace)")
    p.add_argument("--overlay-rows", type=int, default=0,
                   help="per-tenant overlay capacity in rows a memory "
                        "layer (0 = off; 8 when --tenants > 0)")
    p.add_argument("--overlay-write-lr", type=float, default=0.1,
                   help="the decode tick's Hebbian write-back rate into "
                        "the tenant's overlay")
    p.add_argument("--overlay-ttl", type=int, default=0,
                   help="expire a detached tenant's overlay after this "
                        "many idle decode ticks (0 = never)")
    p.add_argument("--overlay-budget-kb", type=float, default=0.0,
                   help="the overlays' byte budget; least recently used "
                        "detached tenants are offloaded beyond it (0 = "
                        "unlimited)")
    p.add_argument("--overlay-dir", default="",
                   help="keep tenant overlays here (spills, and a restore "
                        "at the start and a save at the end); default "
                        "<--ckpt-dir>/overlays with a checkpoint dir")
    p.add_argument("--metrics-dir", default="",
                   help="arm the observability layer (repro_torch.obs): "
                        "spans stream to <dir>/metrics.jsonl, a Prometheus "
                        "textfile snapshot lands at <dir>/metrics.prom")
    p.add_argument("--profile-dir", default="",
                   help="torch.profiler capture dir for the serve.run span "
                        "(needs --metrics-dir)")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable summary document")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    arm_obs(args)
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
    model = transformer.init(cfg, seed=args.seed)
    if args.grow_to:
        if cfg.lram is None:
            raise SystemExit(f"--grow-to needs a memory arch; {cfg.name} "
                             f"has no LRAM layer")
        cfg = memctl.grow_model(model, 2**args.grow_to)
    model = model.to(device)
    if args.ckpt_dir:
        step, restored = CheckpointManager(args.ckpt_dir).restore(
            convert.reference_tree(model, like=True))
        if restored is None:
            raise SystemExit(f"no restorable checkpoint in {args.ckpt_dir}")
        convert.load_reference_tree(model, restored)
        print(json.dumps({"restored_step": step}), flush=True)
    overlay_rows = args.overlay_rows
    if overlay_rows == 0 and args.tenants > 0:
        overlay_rows = 8
    overlay_dir = args.overlay_dir
    if not overlay_dir and args.ckpt_dir and overlay_rows > 0:
        overlay_dir = os.path.join(args.ckpt_dir, "overlays")
    controller = None
    if (args.hbm_budget_mb > 0 or args.spill_at_tick >= 0
            or args.overlay_ttl > 0 or args.overlay_budget_kb > 0):
        controller = memctl.MemoryController(memctl.LifecyclePolicy(
            hbm_budget_bytes=(int(args.hbm_budget_mb * 2**20)
                              if args.hbm_budget_mb > 0 else None),
            spill_at_tick=(args.spill_at_tick
                           if args.spill_at_tick >= 0 else None),
            tenant_ttl_ticks=(args.overlay_ttl
                              if args.overlay_ttl > 0 else None),
            tenant_budget_bytes=(int(args.overlay_budget_kb * 1024)
                                 if args.overlay_budget_kb > 0 else None),
            overlay_spill_dir=overlay_dir or None,
        ))
    trace = synthetic_trace(
        np.random.default_rng(args.seed),
        2 * args.batch if args.requests is None else args.requests,
        vocab_size=cfg.vocab_size,
        max_prompt=args.prompt_len,
        max_gen=args.gen,
        rate=args.rate,
        mixed=not args.fixed_len,
        tenants=args.tenants,
    )
    engine = ServeEngine(model, EngineConfig(
        slots=args.batch,
        max_len=args.prompt_len + args.gen,
        mode=args.mode,
        overlay_rows=overlay_rows,
        overlay_write_lr=args.overlay_write_lr,
    ), controller=controller)
    if engine.overlays is not None and overlay_dir:
        engine.overlays.spill_dir = overlay_dir
        restored = engine.overlays.load_all(overlay_dir)
        if restored:
            print(json.dumps({"restored_overlays": restored}), flush=True)
    if args.warmup:
        engine.warmup([r.prompt_len for r in trace])
    report = engine.run(trace)
    if engine.overlays is not None and overlay_dir:
        engine.overlays.save_all(overlay_dir)
    if controller is not None and controller.events:
        print(json.dumps({"lifecycle": controller.events}), flush=True)
    if args.metrics_dir:
        obs.flush()
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
            "cuda_graph": report.cuda_graph,
            "graph_captures": report.graph_captures,
            **({"overlay": {k: report.overlay[k] for k in (
                "tenants", "hit_rate", "bytes_per_tenant", "writebacks")}}
               if report.overlay else {}),
        }))
    return report


if __name__ == "__main__":
    main()
