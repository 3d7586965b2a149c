"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from `src/repro_torch/kernels/csrc` (nvcc,
     one process per source, started together) and print each kernel's
     registers, spills and shared memory (-Xptxas -v) on one line;
  3. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes (n = 128, 2048, 65536 queries, top-k 32, m 64)
     and time kernel, plain version and, where one PyTorch call computes
     the same function, that call (`F.embedding_bag`); a device time is
     the mean of a kernel's launches under torch.profiler, and a session
     that lost launch records is run again (up to 4):
       K2 `lram_query`, its weights and indices bit-equal to the plain
       version's on uniform queries and on `lattice.tie_queries` (exact
       ties of weight, and ties in the canonical sort), and K1
       `gather_interp`, on the full 2^20-row table, and K1 again at
       n = 65536 on clustered queries (64 near each of n / 64 points, as
       training's queries crowd rows);
       B4 `gather_interp_quant` on the table quantized to int8 and e4m3,
       at n = 128 and 2048 also at every split (warps a query) with and
       without its wide loads (through its C entry, not counted);
       B5 `tiered_gather` and B6 `tiered_gather_quant` (int8, e4m3) on a
       full-width device cache (32 slots x 8192 rows) with resident
       indices, B5's call and its yardstick's timed again in turns;
       at n = 128 and 2048 serve paths (e)'s and (f)'s calls: one of
       the 4 row ranges, every token's k elements with the other ranges'
       reading the range's first routed row at weight 0, K1 over the
       range's flat route (8 of its 32 shards cached) and B5 on the
       range resident in 32 shuffled slots;
       the backward kernel `lookup_bwd` in both instantiations (B3's
       backward with dq, B1's VJP with dw) on the full table with K2's
       indices, library yardstick for the dw instance: the backward of
       `F.embedding_bag` through `torch.autograd.grad`;
       the tiered train step's kernels at n = 128, 2048, 16384 (its n)
       and 65536, on a tiered store's flat route (32 of 128 shards
       cached, the other rows appended): K2 at 16384, K1 and B4 (int8,
       e4m3) over the flat table, and the backward's instances without
       scatter, `lookup_bwd_rows` (fp32 rows, with dq: path (a)'s
       backward; with dw, library yardstick the backward of
       `F.embedding_bag` to its per-sample weights) and
       `lookup_bwd_quant` (int8 and e4m3 rows, with dq: path (b)'s
       backward; with dw: B4's VJP); the same at 16384 and 65536 on
       clustered queries;
       row 9's kernels at n = 128, 2048 and 32768 (one data rank's n on
       the mesh step), on both halves of the table (2^19-row shards at
       base 0 and 2^19): the range gather over fp32 (library yardstick
       `F.embedding_bag` with the clamped rows and masked weights), int8
       and e4m3 shards, and the range backward (fp32 with scatter,
       1-byte without; each with dq and with dw);
  4. serve at full width through `repro_torch.launch.serve.main --warmup`
     (every prefill bucket and one decode tick first; then 8 requests, 4
     slots, prompts <= 64, generation <= 32, all queued at t=0).  Each
     path is driven with every launch count set to 0 just before it and
     read just after, and fails unless its kernels launched, 8 of 8
     requests finished and every logit is finite:
       dense  `lram-tiered --placement pallas`: K2 + K1;
       (a)    `lram-tiered` on its own tiered spec (32 of 128 shards
              cached): K2 + K1 on the overflow route;
       (b)    `lram-tiered-q8` on its own spec: K2 + B4;
       (c)    `lram-tiered --cache-slots 128` (the whole table resident
              after warm()): K2 + B5 on every lookup;
       (d)    `lram-tiered-q8 --cache-slots 128`: K2 + B6;
       (e)    `lram-sharded-tiered` on its own spec (4 row ranges, each a
              tiered store caching 8 of its 32 shards; each range the
              indices name gathers all k of every token, the other
              ranges' elements at weight 0, and the partials are added
              in range order): K2 + K1 on the ranges' overflow routes;
       (f)    `lram-sharded-tiered --cache-slots 32` (every range
              resident): K2 + B5 on every range's lookups.
     All seven serve the same seed's weights, so (a), (c), (e) and (f)
     must give the dense path's first logits and (d) those of (b), to
     1e-5;
  5. a shorter serve of each path's warmed engine under torch.profiler:
     kernel time by name and the device's busy share;
  6. train `lram-bert-medium` at full width through
     `repro_torch.launch.train.main` (`--placement pallas --batch 8 --seq
     256 --steps 20`: 2,048 tokens, n = 65,536 lookups a step), with every
     launch count set to 0 just before and read just after; fails unless
     K2, K1 and the backward kernel `lookup_bwd` launched (the backward
     once a step), every loss and grad norm is finite and the mean loss of
     steps 16-20 is below that of steps 1-5.  Step-time median over steps
     6-20, tokens/s, peak device memory; then one more step under
     torch.profiler (busy share, top kernels, and K1's device time in it
     beside its bound on that step's own indices: each distinct row they
     name read once);
 6a. crash and resume (dense): the same training with `--ckpt-dir` (under
     the system temp directory, deleted afterwards) `--ckpt-every 10
     --simulate-failure-at 15`: only `SimulatedFailure` is caught, then
     the same command again.  Fails unless the relaunch prints `resumed
     from step 10`, its step-10 loss is the crashed run's bit for bit,
     steps 10-14 are within rtol 1e-4 and 15-19 within 1e-3 of phase 6's
     uninterrupted run, and K2, K1 and `lookup_bwd` launched in both runs
     (counts reset just before each, read just after).  Each save's
     snapshot and write ms and bytes, the restore's ms;
 6b. the mesh: 4 ranks spawned on the one card (gloo, which sums CUDA
     tensors through host memory: data 2 x model 2, the 2^20-row table
     row-sharded over model, 128 MiB a rank).  Each rank checks two
     full-width forwards first: the first eval batch's logits on its
     shard against the dense pallas table's (1e-5), and the sharded int8
     and e4m3 cells' `lram_apply` against the dense 1-byte cell's (B4) on
     the same payloads (1e-5).  Then `train.main` (`--placement sharded
     --use-mesh --batch 8 --seq 256 --steps 20`: n = 32,768 lookups a
     rank a step), launch counts reset just before and read just after;
     fails unless K2, the range gather and the range backward launched
     on every rank (the backward once a step), the losses are finite and
     fall, and they match phase 6's (rtol 1e-4 over steps 1-5, 1e-3 over
     all 20: atomics sum in another order).  Step-time median, tokens/s,
     peak memory per rank, and two more steps with every sum across
     ranks timed (their share of the step);
 6c. crash, resume and elastic restore on the mesh: 6b's run with
     `--steps 12 --ckpt-every 6 --ckpt-dir` (every rank snapshots, the
     table shard and its moments gathered over model on a gloo group of
     host arrays; rank 0 writes) fails before step 9 on every rank (only
     `SimulatedFailure` caught, after a barrier behind rank 0's write);
     4 new ranks relaunch it.  Fails unless rank 0 alone prints `resumed
     from step 6`, the step-6 loss is the crashed run's bit for bit,
     steps 6-11 are within rtol 1e-5 of 6b's, K2, the range gather and
     the range backward launched on every rank in both runs, and the
     step-12 checkpoint has 6a's leaf names, shapes, dtypes and bytes (to
     256 B of JSON).  Then one process restores it into the dense pallas
     table (`--steps 14`): `resumed from step 12`, steps 12-13 within
     rtol 1e-5 of 6b's, K2, K1 and `lookup_bwd` launched.  Every rank's
     snapshot (gather included), write and restore ms, and the bytes;
  7. train `lram-tiered` (path (a)) and `lram-tiered-q8` (path (b)) at
     full width on their own tiered spec through `train.main` (`--batch 8
     --seq 64 --steps 20`: n = 16,384 lookups a step, the table in host
     RAM, 32 of 128 shards cached, the write-back's sparse SGD at 1e-3),
     and (7c) `lram-sharded-tiered` 10 steps (4 ranges, 8 of 32 shards
     cached a range; K1 over the ranges' concatenated flat tables), each
     with the launch counts set to 0 just before and read just after;
     fails unless K2, the gather (K1 or B4) and the path's backward
     instance launched (the backward once a step), one write-back ran a
     step (a range write-back a range), the loss fell (the last 5 steps
     below steps 1-5), and the host tier changed on rows the write-back
     touched and nowhere else.  Step-time
     median over steps 6-20, tokens/s, peak device memory, the write-back's
     and the flat route's host ms a step, bytes copied to the host a step,
     hit rate and overflow share; then one more step under torch.profiler;
 7a. crash, resume and serve (tiered int8): `lram-tiered-q8` at full width
     (`--batch 8 --seq 64 --steps 6 --ckpt-every 3`), a failure before step
     4, the relaunch: its step-3 loss is the crashed run's bit for bit and
     every shard it restored (payload and scales) equals the saved file;
     then `serve --ckpt-dir --warmup --json` restores step 6, serves 8 of 8
     requests through K2 + B4, from the trained table bit for bit;
 7b. train the paper's PKM baseline `lram-bert-pkm` at full width (2^16 x
     512 table, 8 heads, top-32; `--batch 8 --seq 256 --steps 20`): the
     reference has no Pallas kernel there, so no kernel of the port may
     launch (counts reset just before, read just after, all 0); the loss
     falls; step-time median over 6-20, tokens/s, peak memory and one
     profiled step (busy share, top kernels);
  8. serve the smoke configs (tiered and q8) on the card and on the CPU
     (plain versions), and tiered against dense on the card, with the same
     weights, comparing every request's first logits to 1e-5; train the
     lram-bert-medium, lram-tiered, lram-tiered-q8 and
     lram-sharded-tiered smoke configs 5 steps on the card and on the CPU
     from the same seed's weights and batches, per-step losses and
     gradient norms to rtol 1e-4, and lram-bert-pkm's smoke config the
     same way;
  9. last lines: the card again, the `kernels` JSON line, and
     {"ok": true, "device": {...}}.

It imports nothing of JAX, of the JAX package or of ml_dtypes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# fails here, printing nothing, when the checkout around the script is missing
from repro_torch import configs, data, quant  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _load, _tree_items  # noqa: E402
from repro_torch.core import indexing, lattice, lookup  # noqa: E402
from repro_torch.distributed import collectives, fault, sharding  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, e8_lookup, gather_interp, ops, sharded_gather, tiered_gather)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.distributed.sharded_lram import (  # noqa: E402
    ShardedTieredStore)
from repro_torch.memstore import TieredValueStore  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig, ServeEngine, synthetic_trace)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
PROFILE_SESSIONS = 4  # profiler sessions a device time may take
FP32_OPS_PER_S = 67e12
SHAPES = (128, 2048, 65536)  # decode tick (4 slots x 32 heads), 64-token
#                              prefill (64 x 32 heads), a large batch
ROWS_SHAPES = (128, 2048, 16384, 65536)  # + the tiered train step's n
RANGE_SHAPES = (128, 2048, 32768)  # + one data rank's n on the mesh step
RANGE_ROWS = 2**19  # one rank's shard of the 2^20-row table, model 2
TOP_K = 32
LOG2_LOCATIONS = 20
M = 64
SHARD_ROWS, CACHE_SLOTS = 8192, 32  # lram-tiered's full-width TieredSpec
ST_RANGES, ST_CACHE_SLOTS = 4, 8  # lram-sharded-tiered's, a range
PAYLOADS = ("int8", "fp8")

CSRC = "src/repro_torch/kernels/csrc"
# name -> (wrapper with its launch count, CUDA source, TPU kernel replaced)
KERNELS = {
    "lram_query": (e8_lookup.lram_query, f"{CSRC}/e8_lookup.cu",
                   "src/repro/kernels/e8_lookup.py:189"),
    "gather_interp": (gather_interp.gather_interp,
                      f"{CSRC}/gather_interp.cu",
                      "src/repro/kernels/gather_interp.py:73"),
    "gather_interp_quant": (gather_interp.gather_interp_quant,
                            f"{CSRC}/gather_interp_quant.cu",
                            "src/repro/kernels/gather_interp.py:138"),
    "tiered_gather": (tiered_gather.tiered_gather,
                      f"{CSRC}/tiered_gather.cu",
                      "src/repro/kernels/tiered_gather.py:91"),
    "tiered_gather_quant": (tiered_gather.tiered_gather_quant,
                            f"{CSRC}/tiered_gather.cu",
                            "src/repro/kernels/tiered_gather.py:162"),
    "lookup_bwd": (ops.lookup_bwd, f"{CSRC}/lookup_bwd.cu",
                   "src/repro/kernels/ops.py:51 (backward :78); "
                   "src/repro/kernels/gather_interp.py:189 (backward :206)"),
    "lookup_bwd_rows": (ops.lookup_bwd_rows, f"{CSRC}/lookup_bwd.cu",
                        "src/repro/kernels/gather_interp.py:189 (B1's VJP "
                        "dw, backward :206, without the scatter: the "
                        "tiered VJP, src/repro/memstore/interp.py:99)"),
    "lookup_bwd_quant": (ops.lookup_bwd_quant, f"{CSRC}/lookup_bwd.cu",
                         "src/repro/kernels/gather_interp.py:148 (B4's "
                         "VJP, backward :165)"),
    "sharded_gather": (sharded_gather.sharded_gather,
                       f"{CSRC}/sharded_gather.cu",
                       "src/repro/distributed/sharded_lram.py:62 "
                       "(sharded_gather_interp, fp32 shard :92-102: "
                       "src/repro/kernels/gather_interp.py:73)"),
    "sharded_gather_quant": (sharded_gather.sharded_gather_quant,
                             f"{CSRC}/sharded_gather.cu",
                             "src/repro/distributed/sharded_lram.py:62 "
                             "(sharded_gather_interp, 1-byte shard "
                             ":104-118: src/repro/kernels/"
                             "gather_interp.py:138)"),
    "lookup_bwd_range": (ops.lookup_bwd_range, f"{CSRC}/lookup_bwd.cu",
                         "src/repro/distributed/sharded_lram.py:62 (the "
                         "autodiff of its shard-local gathers: "
                         "src/repro/kernels/gather_interp.py:206, :165)"),
}
# the shape of the kernels line's headline numbers: the serving decode tick
# (n = 128), or a train step's n for the backward kernel's instances
HEAD_N = {"lookup_bwd": 65536, "lookup_bwd_rows": 16384,
          "lookup_bwd_quant": 16384, "sharded_gather": 32768,
          "sharded_gather_quant": 32768, "lookup_bwd_range": 32768}

SERVE_ARGS = ["--batch", "4", "--prompt-len", "64", "--gen", "32",
              "--requests", "8", "--seed", "0", "--warmup"]
# path -> (serve arguments, kernels that must launch)
PATHS = {
    "dense": (["--arch", "lram-tiered", "--placement", "pallas"],
              ("lram_query", "gather_interp")),
    "a_tiered": (["--arch", "lram-tiered"],
                 ("lram_query", "gather_interp")),
    "b_tiered_q8": (["--arch", "lram-tiered-q8"],
                    ("lram_query", "gather_interp_quant")),
    "c_tiered_resident": (["--arch", "lram-tiered", "--cache-slots", "128"],
                          ("lram_query", "tiered_gather")),
    "d_tiered_q8_resident": (["--arch", "lram-tiered-q8",
                              "--cache-slots", "128"],
                             ("lram_query", "tiered_gather_quant")),
    "e_sharded_tiered": (["--arch", "lram-sharded-tiered"],
                         ("lram_query", "gather_interp")),
    "f_sharded_tiered_resident": (["--arch", "lram-sharded-tiered",
                                   "--cache-slots", "32"],
                                  ("lram_query", "tiered_gather")),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def reset_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def time_ms(fn, budget_ms: float = 200.0) -> float:
    """Mean time of one call, by CUDA events over repeated calls."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max(budget_ms / once, 3), 200))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_bound(distinct_rows: int, row_bytes: int, n: int):
    """A gather's bound: each distinct row this run's indices name read
    once, plus the indices, weights and output."""
    return bound_ms(distinct_rows * row_bytes + n * TOP_K * 8 + 4 * n * M,
                    2 * n * TOP_K * M)


def no_scatter_bound(n: int, distinct: int, row_bytes: int, stage: str,
                     terms: int, rows_apart: bool):
    """The bound of a backward instance without scatter: each distinct row
    read once; g, w and the rows read (with dq also q, and idx where the
    rows are not idx), the output (dq or dw); 2 flops a term of the dots
    (`terms` (t, k) pairs), 40 more a term for dq."""
    if stage == "dq":
        small = 4 * n * TOP_K * rows_apart + 32 * n + 32 * n
    else:
        small = 4 * n * TOP_K
    return bound_ms(distinct * row_bytes + 4 * n * M + 8 * n * TOP_K + small,
                    2 * terms * M + (40 * terms if stage == "dq" else 0))


def b4_split(table, scale, ix, w, split: int, wide: int) -> torch.Tensor:
    """B4 through its C entry with an explicit split (warps a query) and
    variant (wide 1: 8-byte loads where they fit; 0: byte pairs); counts
    no launch."""
    name = "i8" if table.dtype == torch.int8 else "e4m3"
    fn = _build.function(
        "gather_interp_quant", f"gather_interp_quant_{name}_split",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = torch.empty(ix.shape[0], table.shape[1], device=table.device)
    _build.check(fn(table.data_ptr(), scale.data_ptr(), ix.data_ptr(),
                    w.data_ptr(), out.data_ptr(), ix.shape[0], ix.shape[1],
                    table.shape[1], split, wide, table.device.index,
                    torch.cuda.current_stream().cuda_stream), "B4 split")
    return out


def b5_split(cache, gid, slot_table, w, split: int) -> torch.Tensor:
    """B5 through its C entry with an explicit split; counts no launch."""
    fn = _build.function(
        "tiered_gather", "tiered_gather_f32_split",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = torch.empty(gid.shape[0], cache.shape[1], device=cache.device)
    _build.check(fn(cache.data_ptr(), gid.data_ptr(), slot_table.data_ptr(),
                    w.data_ptr(), out.data_ptr(), gid.shape[0], gid.shape[1],
                    cache.shape[1], tiered_gather._log2(SHARD_ROWS), split,
                    cache.device.index,
                    torch.cuda.current_stream().cuda_stream), "B5 split")
    return out


def b6_split(cache, scale, gid, slot_table, w, split: int,
             wide: int) -> torch.Tensor:
    """B6 through its C entry with an explicit split and variant (wide 1:
    8-byte loads where they fit; 0: byte pairs); counts no launch."""
    name = "i8" if cache.dtype == torch.int8 else "e4m3"
    fn = _build.function(
        "tiered_gather", f"tiered_gather_quant_{name}_split",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    out = torch.empty(gid.shape[0], cache.shape[1], device=cache.device)
    _build.check(fn(cache.data_ptr(), scale.data_ptr(), gid.data_ptr(),
                    slot_table.data_ptr(), w.data_ptr(), out.data_ptr(),
                    gid.shape[0], gid.shape[1], cache.shape[1],
                    tiered_gather._log2(SHARD_ROWS), split, wide,
                    cache.device.index,
                    torch.cuda.current_stream().cuda_stream), "B6 split")
    return out


def split_ms(what: str, call, want, kernel: str, wides=(0, 1)) -> dict:
    """A gather at every split (warps a query) and variant through its C
    entry, `call(split, wide)`, each held against the plain version's
    output `want` (rtol 2e-5 / atol 1e-6): device ms of `kernel` by split
    ("8w": 8 warps a query, wide loads; "8p": pairs)."""
    out = {}
    for split in (1, 2, 4, 8):
        for wide in wides:
            got = call(split, wide)
            check(torch.allclose(got, want, rtol=2e-5, atol=1e-6),
                  f"{what} split {split} wide {wide} differs from its plain "
                  f"version by {(got - want).abs().max().item()}")
            out[f"{split}{'w' if wide else 'p'}"] = device_ms(
                lambda: call(split, wide), kernel)
    return out


def _kernel_of(symbol: str) -> tuple[str, str]:
    """(kernel name, instance) of a mangled kernel symbol: the name whose
    length prefix ends in `_kernel`, and its template arguments (payload
    type, then each bool as 0 / 1 and each int), e.g. ("lookup_bwd_kernel",
    "f32,1,0,0,1")."""
    for m in re.finditer(r"\d+", symbol):  # a hash may run into the prefix
        sizes = {int(m.group()[i:]) for i in range(len(m.group()))}
        name = next((symbol[m.end():m.end() + n] for n in sizes
                     if symbol[m.end():m.end() + n].endswith("_kernel")
                     and m.end() + n <= len(symbol)), None)
        if name:
            rest = symbol[m.end() + len(name):]
            if not rest.startswith("I"):
                return name, ""
            args = rest.split("EEv")[0] + "E"
            payload = ("f32" if args.startswith("If") else "i8"
                       if args.startswith("Ia") else "e4m3"
                       if args.startswith("I13__nv_fp8_e4m3") else "")
            return name, ",".join([payload]
                                  + re.findall(r"L[bi](\d+)E", args))
    return symbol, ""


def ptxas_report(log: str) -> list[dict]:
    """Registers, spill bytes and static shared memory of each kernel in
    nvcc's -Xptxas -v output."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, instance = _kernel_of(m.group(1))
            out.append({"kernel": name, "instance": instance})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(m.group(1)) if m else 0
    return out


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(fn):
    """Run fn under torch.profiler; (result, {device activity: us},
    {device activity: calls}).  Only device-side events count (kernels,
    copies): the CPU ops that launched them would count the same time
    twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    per_kernel, calls = {}, {}
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        if us > 0 and evt.device_type == DeviceType.CUDA:
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us
            calls[evt.key] = calls.get(evt.key, 0) + evt.count
    return out, per_kernel, calls


def device_split(fn, kernel: str, calls: int = 20):
    """Device ms of one call's kernels whose names hold `kernel` (a call
    may launch several: the backward's scatter instances launch a
    pipeline, each kernel once), the sum of each one's mean over the
    launches the profiler recorded; and of everything else the call ran
    (fills, copies) per call; and the kernel names it matched.  A profiler session now and then delivers none or
    only some of its kernel records (the cells of the table that read
    "not measured"): a session that recorded fewer than `calls` launches
    of a matched kernel is run again, up to PROFILE_SESSIONS sessions, and
    the one that recorded the most launches is kept (`profile_sessions`:
    each session's launches of ours and all its device events).  None
    where no session saw device time."""
    fn()
    best, by_session = None, []
    for session in range(1, PROFILE_SESSIONS + 1):
        _, per_kernel, counts = profile(lambda: [fn() for _ in range(calls)])
        ours = [k for k in per_kernel if kernel in k]
        check(all(counts[k] <= calls for k in ours),
              f"{kernel}: a call launched one of {ours} more than once")
        recorded = sum(counts[k] for k in ours)
        # launches of ours, and all device events, each session recorded
        by_session.append([recorded, sum(counts.values())])
        if best is None or recorded > best[0]:
            best = (recorded, per_kernel, counts, ours)
        if ours and all(counts[k] == calls for k in ours):
            break
    recorded, per_kernel, counts, ours = best
    rest = [k for k in per_kernel if k not in ours]
    ours_ms = (sum(per_kernel[k] / counts[k] for k in ours) / 1e3
               if ours else None)
    rest_ms = (sum(per_kernel[k] for k in rest) / calls / 1e3
               if rest else None)
    return ours_ms, rest_ms, {
        "device_events": recorded, "device_calls": calls,
        "profile_sessions": by_session,
        "device_kernels": [k[:120] for k in ours]}


def device_ms(fn, kernel: str, calls: int = 20):
    """Device time of one launch of `kernel` (profiler), or None if the
    profiler saw no device time."""
    return device_split(fn, kernel, calls)[0]


def measure(name, n, fn, plain, tol, *, device_kernel, bound, extra=None,
            library=None, library_tol=(1e-5, 1e-5)):
    """Hold `fn` against `plain` (allclose with tol = (rtol, atol)) and
    time kernel, plain version and library call (held against the plain
    version to library_tol): one row of the table."""
    out, want = fn(), plain()
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    check(torch.allclose(out, want, rtol=tol[0], atol=tol[1]),
          f"{name} differs from its plain version by {err} at n={n}")
    lib_ms = None
    if library is not None:
        check(torch.allclose(library(), want, rtol=library_tol[0],
                             atol=library_tol[1]),
              f"{name}: the library yardstick disagrees at n={n}")
        lib_ms = time_ms(library)
    b, by = bound
    dev, _, seen = device_split(fn, device_kernel)
    return {"n": n, "max_abs_err": err, "ms": time_ms(fn),
            "device_ms": dev, **seen,
            "plain_ms": time_ms(plain), "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms, **(extra or {})}


def backward_rows(n, spec, values, q, idx, w, gen):
    """The backward kernel at one n, both scatter instances (dq, dw: the
    body and the scatter's pipeline), against `lookup_bwd_plain`: dvalues
    to atol 1e-5 (a row's sum runs in placement order, which atomics set),
    dq / dw to rtol 1e-4 / atol 1e-5."""
    g = torch.randn(n, M, generator=gen, device=values.device)
    distinct = torch.unique(idx).numel()
    rows = []
    for stage in ("dq", "dw"):
        extra = {"q": q, "spec": spec} if stage == "dq" else {}
        fn = lambda: ops.lookup_bwd(values, idx, w, g, **extra)  # noqa: E731
        plain = lambda: ops.lookup_bwd_plain(  # noqa: E731
            values, idx, w, g, **extra)
        (dv, small), (dv_p, small_p) = fn(), plain()
        torch.cuda.synchronize()
        err_dv = (dv - dv_p).abs().max().item()
        err_small = (small - small_p).abs().max().item()
        check(torch.allclose(dv, dv_p, rtol=0, atol=1e-5)
              and torch.allclose(small, small_p, rtol=1e-4, atol=1e-5),
              f"lookup_bwd ({stage}) differs from its plain version at "
              f"n={n}: dvalues {err_dv}, {stage} {err_small}")
        lib_ms = None
        if stage == "dw":  # one PyTorch call computing dvalues and dw
            vals = values.detach().requires_grad_()
            ww = w.detach().requires_grad_()
            bag = F.embedding_bag(idx.long(), vals, per_sample_weights=ww,
                                  mode="sum")
            lib = lambda: torch.autograd.grad(  # noqa: E731
                bag, (vals, ww), g, retain_graph=True)
            l_dv, l_dw = lib()
            check(torch.allclose(l_dv, dv_p, rtol=0, atol=1e-5)
                  and torch.allclose(l_dw, small_p, rtol=1e-4, atol=1e-5),
                  f"lookup_bwd: the embedding_bag yardstick disagrees at "
                  f"n={n}")
            lib_ms = time_ms(lib)
            del vals, ww, bag, l_dv, l_dw
        # g, idx + w, q; the output (dq or dw)
        small = (4 * n * M + 8 * n * TOP_K
                 + (64 * n if stage == "dq" else 4 * n * TOP_K))
        fill = values.numel() * 4  # the dense dvalues, written once
        ops_n = 4 * n * TOP_K * M + (n * TOP_K * 40 if stage == "dq" else 0)
        # the function (the call): each distinct row read once, dvalues
        # written once (the kernels write it whole)
        b, by = bound_ms(distinct * 4 * M + fill + small, ops_n)
        dev, rest, seen = device_split(fn, "lookup_bwd")
        rows.append({
            "n": n, "stage": stage, "max_abs_err": max(err_dv, err_small),
            "dvalues_max_abs_err": err_dv, f"{stage}_max_abs_err": err_small,
            "ms": time_ms(fn), "device_ms": dev, **seen,
            "fill_device_ms": rest, "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms, "distinct_rows": distinct})
        del dv, small, dv_p, small_p
    return rows


def k2_row(rows, n, q, spec, values):
    """K2 at one n against its plain version, bit for bit: weights and
    indices on the uniform queries q and on `lattice.tie_queries` (exact
    ties of weight, most at the top-32's cut; and ties in the canonical
    sort), and the output the uniform set gathers; the timings on q, with
    the device time on the weight-tie set beside them.  Appends its row
    and returns the kernel's (idx, w) on q."""
    sets = {"uniform": q}
    for name, distinct in (("weight_ties", True), ("sort_ties", False)):
        sets[name] = torch.from_numpy(lattice.tie_queries(
            n, spec.K, seed=n, distinct=distinct)).to(q.device)
    same = {}
    for name, qs in sets.items():
        idx, w = e8_lookup.lram_query(qs, spec, TOP_K)
        idx_p, w_p = e8_lookup.lram_query_plain(qs, spec, TOP_K)
        torch.cuda.synchronize()
        same[name] = (idx == idx_p).float().mean().item()
        w_err = (w - w_p).abs().max().item()
        check(same[name] == 1.0 and torch.equal(w, w_p),
              f"K2 differs from its plain version on the {name} queries at "
              f"n={n}: {same[name]} of the indices equal, weights by "
              f"{w_err}")
        if name == "uniform":
            idx_u, w_u = idx, w
            out = gather_interp.gather_interp_plain(values, idx, w)
            out_p = gather_interp.gather_interp_plain(values, idx_p, w_p)
            check(torch.allclose(out, out_p, rtol=2e-5, atol=1e-5),
                  f"K2 gathered output differs at n={n}: max "
                  f"{(out - out_p).abs().max().item()}")
    k2 = lambda: e8_lookup.lram_query(q, spec, TOP_K)  # noqa: E731
    # per query: 232 distances of 23 fp32 ops, and the compares a top-k of
    # 232 needs (232 * log2 k), not the kernel's k full passes
    b2 = bound_ms(n * 8 * 4 + n * TOP_K * 8,
                  n * 232 * (23 + math.log2(TOP_K)))
    dev, _, seen = device_split(k2, "lram_query_kernel")
    rows["lram_query"].append({
        "n": n, "max_abs_err": 0.0, "same_idx_frac": same["uniform"],
        "same_idx_frac_by_set": same, "w_bit_equal": True,
        "out_max_abs_err": (out - out_p).abs().max().item(),
        "ms": time_ms(k2), "device_ms": dev, **seen,
        "weight_ties_device_ms": device_ms(
            lambda: e8_lookup.lram_query(sets["weight_ties"], spec, TOP_K),
            "lram_query_kernel"),
        "plain_ms": time_ms(lambda: e8_lookup.lram_query_plain(
            q, spec, TOP_K)),
        "bound_ms": b2[0], "bound_by": b2[1], "library_ms": None})
    return idx_u, w_u


def in_turns(fn_a, fn_b) -> tuple[list, list]:
    """Call ms of fn_a and fn_b, timed a, b, b, a."""
    a, b = [], []
    for which in (a, b, b, a):
        which.append(time_ms(fn_a if which is a else fn_b))
    return a, b


def kernel_phase(device):
    spec = indexing.choose_torus(LOG2_LOCATIONS)
    gen = torch.Generator(device=device).manual_seed(0)
    values = torch.randn(spec.num_locations, M, generator=gen,
                         device=device)
    wrap = torch.tensor(spec.K, dtype=torch.float32, device=device)
    host_values = values.cpu().numpy()
    tables = {}   # payload -> (q, scale) of the full table
    for kind in PAYLOADS:
        q, s = quant.quantize_rows_np(host_values, kind)
        tables[kind] = (quant.as_torch_payload(q).to(device),
                        torch.from_numpy(s).to(device))
    # a full-width device cache: 32 of the 128 shards resident, in
    # shuffled slots
    cache = torch.randn(CACHE_SLOTS * SHARD_ROWS, M, generator=gen,
                        device=device)
    caches = {}
    for kind in PAYLOADS:
        q, s = quant.quantize_rows_np(cache.cpu().numpy(), kind)
        caches[kind] = (quant.as_torch_payload(q).to(device),
                        torch.from_numpy(s).to(device))
    num_shards = spec.num_locations // SHARD_ROWS
    host_gen = torch.Generator().manual_seed(0)
    resident = torch.randperm(num_shards, generator=host_gen)[:CACHE_SLOTS]
    slot_table = torch.full((num_shards,), -1, dtype=torch.int32)
    slot_table[resident] = torch.randperm(CACHE_SLOTS,
                                          generator=host_gen).int()
    slot_table = slot_table.to(device)
    resident = resident.to(device)
    identity = torch.arange(num_shards, dtype=torch.int32, device=device)
    log2r = SHARD_ROWS.bit_length() - 1

    rows = {name: [] for name in KERNELS}
    for n in SHAPES:
        # torus coordinates in [0, K), as the memory layer hands them over
        q = torch.rand(n, 8, generator=gen, device=device) * wrap
        idx, w = k2_row(rows, n, q, spec, values)

        distinct = torch.unique(idx).numel()
        k1_dense_row(rows, n, values, idx, w, "uniform")
        rows["lookup_bwd"] += backward_rows(n, spec, values, q, idx, w, gen)
        for kind in PAYLOADS:
            tq, ts = tables[kind]
            b4 = measure(
                f"B4 ({kind})", n,
                lambda: gather_interp.gather_interp_quant(tq, ts, idx, w),
                lambda: gather_interp.gather_interp_quant_plain(tq, ts, idx,
                                                                w),
                (2e-5, 1e-6), device_kernel="gather_interp_quant_kernel",
                bound=gather_bound(distinct, M + 4, n),
                extra={"payload": kind, "route": "dense",
                       "distinct_rows": distinct})
            if n <= 2048:  # decode sizes: every split, both variants
                b4["split_device_ms"] = split_ms(
                    "B4", lambda sp, wd: b4_split(tq, ts, idx, w, sp, wd),
                    gather_interp.gather_interp_quant_plain(tq, ts, idx, w),
                    "gather_interp_quant_kernel")
            rows["gather_interp_quant"].append(b4)

        # the same access pattern moved into the resident shards of the
        # 32-slot cache; then the whole table resident, as serve paths (c)
        # and (d) hold it after warm() (128 slots, shard s in slot s), so
        # that B5 and B6 read the rows K1 and B4 read above
        gid = ((resident[(idx >> log2r) % CACHE_SLOTS] << log2r)
               | (idx & (SHARD_ROWS - 1))).int()
        tiered_rows(rows, n, cache, caches, slot_table, gid, w, CACHE_SLOTS)
        tiered_rows(rows, n, values, tables, identity, idx, w, num_shards)
        if n <= 2048:  # serve (e)'s and (f)'s decode tick and prefill
            sharded_tiered_rows(rows, n, values, idx, w, gen)
    # K1 on clustered queries (64 near each of n / 64 points), as
    # training's queries crowd rows
    n = SHAPES[-1]
    q = torch.rand(n // 64, 8, generator=gen, device=device) * wrap
    q = (q.repeat(64, 1) + 1e-3 * torch.rand(n, 8, generator=gen,
                                             device=device)).contiguous()
    idx, w = e8_lookup.lram_query(q, spec, TOP_K)
    k1_dense_row(rows, n, values, idx, w, "clustered")
    for n in ROWS_SHAPES:
        no_scatter_rows(rows, n, spec, values, tables, wrap, gen)
    for n in ROWS_SHAPES[-2:]:  # training's crowded rows
        no_scatter_rows(rows, n, spec, values, tables, wrap, gen,
                        "clustered")
    for n in RANGE_SHAPES:
        range_rows(rows, n, spec, values, tables, wrap, gen)
    return rows


def tiered_rows(rows, n, cache, caches, slot_table, gid, w, slots):
    """B5 on the fp32 cache and B6 on each 1-byte one (`caches`: payload
    -> (q, scale)) through `slot_table`, against their plain versions
    (rtol 2e-5 / atol 1e-6); library yardstick for B5 `F.embedding_bag`
    on the rows already translated (the translation not timed); at the
    decode sizes every split (B6: with and without the wide loads)."""
    distinct = torch.unique(gid).numel()
    rows64 = tiered_gather.cache_rows(gid, slot_table, SHARD_ROWS)
    extra = {"cache_slots": slots, "distinct_rows": distinct}

    def b5():
        return tiered_gather.tiered_gather(cache, gid, slot_table, w,
                                           shard_rows=SHARD_ROWS,
                                           resident=True)

    def b5_library():
        return F.embedding_bag(rows64, cache, per_sample_weights=w,
                               mode="sum")
    row = measure(
        f"B5 ({slots} slots)", n, b5,
        lambda: tiered_gather.tiered_gather_plain(
            cache, gid, slot_table, w, shard_rows=SHARD_ROWS),
        (2e-5, 1e-6), device_kernel="tiered_gather_kernel",
        bound=gather_bound(distinct, 4 * M, n),
        extra={**extra, "library_note": "embedding_bag on pre-translated "
                                        "rows; translation not timed"},
        library=b5_library)
    # call ms of B5 and of its yardstick again, in turns
    row["ms_turns"], row["library_ms_turns"] = in_turns(b5, b5_library)
    if n <= 2048:
        row["split_device_ms"] = split_ms(
            f"B5 ({slots} slots)",
            lambda sp, _: b5_split(cache, gid, slot_table, w, sp),
            tiered_gather.tiered_gather_plain(cache, gid, slot_table, w,
                                              shard_rows=SHARD_ROWS),
            "tiered_gather_kernel", wides=(0,))
    rows["tiered_gather"].append(row)
    for kind in PAYLOADS:
        cq, cs = caches[kind]

        def plain():
            return tiered_gather.tiered_gather_quant_plain(
                cq, cs, gid, slot_table, w, shard_rows=SHARD_ROWS)
        row = measure(
            f"B6 ({kind}, {slots} slots)", n,
            lambda: tiered_gather.tiered_gather_quant(
                cq, cs, gid, slot_table, w, shard_rows=SHARD_ROWS,
                resident=True),
            plain, (2e-5, 1e-6), device_kernel="tiered_gather_quant_kernel",
            bound=gather_bound(distinct, M + 4, n),
            extra={**extra, "payload": kind})
        if n <= 2048:
            row["split_device_ms"] = split_ms(
                f"B6 ({kind}, {slots} slots)",
                lambda sp, wd: b6_split(cq, cs, gid, slot_table, w, sp, wd),
                plain(), "tiered_gather_quant_kernel")
        rows["tiered_gather_quant"].append(row)


def k1_dense_row(rows, n, values, idx, w, queries):
    """K1 on the dense table against its plain version to 1e-5; library
    yardstick `F.embedding_bag`."""
    distinct = torch.unique(idx).numel()
    idx64 = idx.long()
    rows["gather_interp"].append(measure(
        "K1", n, lambda: gather_interp.gather_interp(values, idx, w),
        lambda: gather_interp.gather_interp_plain(values, idx, w),
        (1e-5, 1e-5), device_kernel="gather_interp_kernel",
        bound=gather_bound(distinct, 4 * M, n),
        extra={"route": "dense", "queries": queries,
               "distinct_rows": distinct},
        library=lambda: F.embedding_bag(idx64, values,
                                        per_sample_weights=w,
                                        mode="sum")))


def range_rows(rows, n, spec, values, tables, wrap, gen):
    """Row 9's kernels at one n, on both halves of the table split over a
    2-way model axis (shards of 2^19 rows at base 0 and 2^19) with K2's
    indices (K2 itself where the serving shapes do not hold n): the range
    gather over fp32 (to K1's tolerance, 1e-5; library yardstick
    `F.embedding_bag` over the shard with the clamped indices and the
    masked weights) and int8 / e4m3 shards (B4's, rtol 2e-5 / atol 1e-6),
    and the range backward, fp32 (scatter into the shard's dvalues) and
    1-byte (no scatter), each with dq and with dw, against
    `lookup_bwd_plain` with the range mask (dvalues atol 1e-5, atomics;
    dq / dw rtol 1e-4 / atol 1e-5)."""
    q = torch.rand(n, 8, generator=gen, device=values.device) * wrap
    if n in SHAPES:
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
    else:
        idx, w = k2_row(rows, n, q, spec, values)
    g = torch.randn(n, M, generator=gen, device=values.device)
    for base in (0, RANGE_ROWS):
        shard = values[base:base + RANGE_ROWS]
        rel, ok = sharded_gather.local_rows(idx, base, RANGE_ROWS)
        wm = (w * ok).contiguous()
        distinct = torch.unique(idx[ok]).numel()
        where = {"base": base, "shard_rows": RANGE_ROWS,
                 "in_range_share": float(ok.float().mean()),
                 "distinct_rows": distinct}
        rows["sharded_gather"].append(measure(
            "range gather (fp32)", n,
            lambda: sharded_gather.sharded_gather(shard, idx, w, base),
            lambda: sharded_gather.sharded_gather_plain(shard, idx, w, base),
            (1e-5, 1e-5), device_kernel="sharded_gather_kernel",
            bound=gather_bound(distinct, 4 * M, n), extra=where,
            library=lambda: F.embedding_bag(rel, shard,
                                            per_sample_weights=wm,
                                            mode="sum")))
        cells = [("fp32", shard, None)]
        for kind in PAYLOADS:
            tq, ts = tables[kind]
            sq, ss = tq[base:base + RANGE_ROWS], ts[base:base + RANGE_ROWS]
            cells.append((kind, sq, ss))
            rows["sharded_gather_quant"].append(measure(
                f"range gather ({kind})", n,
                lambda: sharded_gather.sharded_gather_quant(sq, ss, idx, w,
                                                            base),
                lambda: sharded_gather.sharded_gather_quant_plain(
                    sq, ss, idx, w, base),
                (2e-5, 1e-6), device_kernel="sharded_gather_kernel",
                bound=gather_bound(distinct, M + 4, n),
                extra={"payload": kind, **where}))
        for payload, table, scale in cells:
            for stage in ("dq", "dw"):
                rows["lookup_bwd_range"].append(range_backward_row(
                    n, stage, payload, table, scale, base, spec, q, idx, w,
                    g, rel, ok, where))


def range_backward_row(n, stage, payload, table, scale, base, spec, q, idx,
                       w, g, rel, ok, where):
    """One instance of the range backward against `lookup_bwd_plain` with
    the range mask; its bound is the function's: each distinct in-range
    row read once, the shard's dvalues written once (fp32), g, idx, w, q
    and the output."""
    extra = {"q": q, "spec": spec} if stage == "dq" else {}
    fn = lambda: ops.lookup_bwd_range(  # noqa: E731
        table, idx, w, g, base, scale=scale, **extra)
    plain = lambda: ops.lookup_bwd_plain(  # noqa: E731
        table, idx, w, g, extra.get("q"), spec, scale=scale,
        scatter=scale is None, base=base)
    (dv, small), (dv_p, small_p) = fn(), plain()
    torch.cuda.synchronize()
    err_dv = 0.0 if dv is None else (dv - dv_p).abs().max().item()
    err_small = (small - small_p).abs().max().item()
    check((dv is None or torch.allclose(dv, dv_p, rtol=0, atol=1e-5))
          and torch.allclose(small, small_p, rtol=1e-4, atol=1e-5),
          f"lookup_bwd_range ({payload}, {stage}) differs from its plain "
          f"version at n={n}, base={base}: dvalues {err_dv}, {stage} "
          f"{err_small}")
    lib_ms = None
    if scale is None and stage == "dw":
        # one PyTorch call: the backward of embedding_bag over the shard
        # with the clamped rows and masked weights (its dw, times the mask,
        # is the partial dw)
        vals = table.detach().requires_grad_()
        wm = (w * ok).detach().requires_grad_()
        bag = F.embedding_bag(rel, vals, per_sample_weights=wm, mode="sum")
        lib = lambda: torch.autograd.grad(  # noqa: E731
            bag, (vals, wm), g, retain_graph=True)
        l_dv, l_dw = lib()
        check(torch.allclose(l_dv, dv_p, rtol=0, atol=1e-5)
              and torch.allclose(l_dw * ok, small_p, rtol=1e-4, atol=1e-5),
              f"lookup_bwd_range: the embedding_bag yardstick disagrees at "
              f"n={n}")
        lib_ms = time_ms(lib)
        del vals, wm, bag, l_dv, l_dw
    distinct = where["distinct_rows"]
    row_bytes = 4 * M if scale is None else M + 4
    fill = table.shape[0] * 4 * M if scale is None else 0
    small_bytes = (4 * n * M + 8 * n * TOP_K
                   + (64 * n if stage == "dq" else 4 * n * TOP_K))
    terms = int(ok.sum())  # the in-range (t, k): a dot, and a scatter
    ops_n = (4 if scale is None else 2) * terms * M \
        + (terms * 40 if stage == "dq" else 0)
    b, by = bound_ms(distinct * row_bytes + fill + small_bytes, ops_n)
    dev, rest, seen = device_split(fn, "lookup_bwd")
    out = {"n": n, "stage": stage, "payload": payload,
           "max_abs_err": max(err_dv, err_small),
           "dvalues_max_abs_err": err_dv if dv is not None else None,
           f"{stage}_max_abs_err": err_small, "ms": time_ms(fn),
           "device_ms": dev, **seen, "fill_device_ms": rest,
           "plain_ms": time_ms(plain), "bound_ms": b, "bound_by": by,
           "library_ms": lib_ms, **where}
    del dv, small, dv_p, small_p
    return out


def flat_route(values, idx, resident):
    """A tiered store's flat route over its table `values`: the resident
    shards' rows (the device cache, `resident` in slot order) with the
    other rows appended, one per index, and each index's row in that
    flat table."""
    log2r = SHARD_ROWS.bit_length() - 1
    slots = resident.numel()
    shard, row = idx.long() >> log2r, idx.long() & (SHARD_ROWS - 1)
    slot_of = torch.full((values.shape[0] // SHARD_ROWS,), -1,
                         dtype=torch.long, device=values.device)
    slot_of[resident] = torch.arange(slots, device=values.device)
    slot = slot_of[shard]
    mask = slot >= 0
    rows = torch.where(mask, slot * SHARD_ROWS + row, 0)
    rows[~mask] = slots * SHARD_ROWS + torch.arange(
        int((~mask).sum()), device=values.device)
    cache_rows = (resident[:, None] * SHARD_ROWS + torch.arange(
        SHARD_ROWS, device=values.device)).reshape(-1)
    flat = torch.cat([cache_rows, idx.long()[~mask]])
    return flat, rows.int().contiguous()


def sharded_tiered_rows(rows, n, values, idx, w, gen):
    """The gathers of serve paths (e) and (f) at one of their n (a decode
    tick, a prefill), on K2's indices over the full table split into
    `lram-sharded-tiered`'s 4 row ranges: one range's call as
    `ShardedTieredStore.gather` makes it, every token's k elements with
    those of the other ranges reading the range's first routed row at
    weight 0.  K1 over the range's flat route with 8 of its 32 shards
    cached (path (e)) and B5 on its whole range resident in 32 shuffled
    slots (path (f)), each against its plain version at the tolerance of
    its other rows; library yardstick `F.embedding_bag` on the same rows
    (B5's pre-translated)."""
    rng_rows, r = values.shape[0] // ST_RANGES, 1
    part = values[r * rng_rows:(r + 1) * rng_rows]
    sel = (idx // rng_rows) == r
    local = idx[sel] - r * rng_rows    # the routed elements, in order
    wm = torch.where(sel, w, 0.0).contiguous()
    shards = rng_rows // SHARD_ROWS
    extra = {"range": f"{r} of {ST_RANGES}",
             "routed_share": float(sel.float().mean())}

    cached = torch.randperm(shards, generator=gen,
                            device=values.device)[:ST_CACHE_SLOTS]
    flat, routed = flat_route(part, local, cached)
    table = part[flat].contiguous()
    rws = torch.full_like(idx, int(routed[0]))
    rws[sel] = routed
    distinct = torch.unique(rws).numel()
    rows["gather_interp"].append(measure(
        "K1 (sharded-tiered (e), one range's flat route)", n,
        lambda: gather_interp.gather_interp(table, rws, wm),
        lambda: gather_interp.gather_interp_plain(table, rws, wm),
        (1e-5, 1e-5), device_kernel="gather_interp_kernel",
        bound=gather_bound(distinct, 4 * M, n),
        extra={**extra, "route": "sharded-tiered (e)",
               "cache_slots": ST_CACHE_SLOTS, "distinct_rows": distinct,
               "overflow_share": float(
                   (routed >= ST_CACHE_SLOTS * SHARD_ROWS).float().mean())},
        library=lambda: F.embedding_bag(rws.long(), table,
                                        per_sample_weights=wm, mode="sum")))

    slot_of = torch.randperm(shards, generator=gen, device=values.device)
    cache = torch.empty_like(part)
    cache.view(shards, SHARD_ROWS, M)[slot_of] = part.view(
        shards, SHARD_ROWS, M)
    slot_table = slot_of.int()
    gid = torch.full_like(idx, int(local[0]))
    gid[sel] = local
    distinct = torch.unique(gid).numel()
    rows64 = tiered_gather.cache_rows(gid, slot_table, SHARD_ROWS)
    rows["tiered_gather"].append(measure(
        "B5 (sharded-tiered (f), one range resident)", n,
        lambda: tiered_gather.tiered_gather(cache, gid, slot_table, wm,
                                            shard_rows=SHARD_ROWS,
                                            resident=True),
        lambda: tiered_gather.tiered_gather_plain(
            cache, gid, slot_table, wm, shard_rows=SHARD_ROWS),
        (2e-5, 1e-6), device_kernel="tiered_gather_kernel",
        bound=gather_bound(distinct, 4 * M, n),
        extra={**extra, "route": "sharded-tiered (f)", "cache_slots": shards,
               "distinct_rows": distinct,
               "library_note": "embedding_bag on pre-translated rows; "
                               "translation not timed"},
        library=lambda: F.embedding_bag(rows64, cache,
                                        per_sample_weights=wm, mode="sum")))


def no_scatter_rows(rows, n, spec, values, tables, wrap, gen,
                    queries="uniform"):
    """The tiered train step's kernels at one n, on the flat route of K2's
    indices (32 of 128 shards cached, the other rows appended) for uniform
    or clustered queries (64 near each of n / 64 points): K2 itself where
    the serving shapes do not hold n (uniform queries); the forward
    gathers over the flat table, K1 (fp32) and B4 (int8, e4m3), to the
    serving rows' tolerances; the backward's instances without scatter,
    `lookup_bwd_rows` (fp32) and `lookup_bwd_quant` (int8, e4m3), each with
    dq and with dw, against `lookup_bwd_plain` to rtol 1e-4 / atol 1e-5
    (the scatter instances' tolerance for dq and dw)."""
    q = torch.rand(n, 8, generator=gen, device=values.device) * wrap
    if queries == "clustered":
        q = (q[:n // 64].repeat(64, 1) + 1e-3 * torch.rand(
            n, 8, generator=gen, device=values.device)).contiguous()
    if n in SHAPES or queries == "clustered":
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
    else:
        idx, w = k2_row(rows, n, q, spec, values)
    g = torch.randn(n, M, generator=gen, device=values.device)
    resident = torch.randperm(values.shape[0] // SHARD_ROWS,
                              generator=gen, device=values.device)[
                                  :CACHE_SLOTS]
    flat, rws = flat_route(values, idx, resident)
    rws64 = rws.long()
    distinct = torch.unique(rws).numel()
    overflow = float((rws >= CACHE_SLOTS * SHARD_ROWS).float().mean())
    cells = [("lookup_bwd_rows", "fp32", values[flat].contiguous(), None)]
    for kind in PAYLOADS:
        tq, ts = tables[kind]
        # rows taken through the payload's bytes (indexing takes no fp8)
        cells.append(("lookup_bwd_quant", kind,
                      tq.view(torch.uint8)[flat].view(tq.dtype),
                      ts[flat].contiguous()))
    route = {"route": "flat", "queries": queries, "distinct_rows": distinct,
             "overflow_share": overflow}
    for name, payload, table, scale in cells:
        fn = KERNELS[name][0]
        row_bytes = 4 * M if scale is None else M + 4
        if scale is None:
            rows["gather_interp"].append(measure(
                "K1 (flat route)", n,
                lambda: gather_interp.gather_interp(table, rws, w),
                lambda: gather_interp.gather_interp_plain(table, rws, w),
                (1e-5, 1e-5), device_kernel="gather_interp_kernel",
                bound=gather_bound(distinct, row_bytes, n), extra=route,
                library=lambda: F.embedding_bag(rws64, table,
                                                per_sample_weights=w,
                                                mode="sum")))
        else:
            rows["gather_interp_quant"].append(measure(
                f"B4 ({payload}, flat route)", n,
                lambda: gather_interp.gather_interp_quant(table, scale, rws,
                                                          w),
                lambda: gather_interp.gather_interp_quant_plain(
                    table, scale, rws, w),
                (2e-5, 1e-6), device_kernel="gather_interp_quant_kernel",
                bound=gather_bound(distinct, row_bytes, n),
                extra={"payload": payload, **route}))
        for stage in ("dq", "dw"):
            extra = ({"idx": idx, "q": q, "spec": spec} if stage == "dq"
                     else {})
            args = (table, rws) if scale is None else (table, scale, rws)
            call = lambda: fn(*args, w, g, **extra)  # noqa: E731
            plain = lambda: ops.lookup_bwd_plain(  # noqa: E731
                table, idx, w, g, extra.get("q"), spec, scale=scale,
                rows=rws, scatter=False)[1]
            library = None
            if scale is None and stage == "dw":
                # one PyTorch call computing dw alone: the backward of
                # embedding_bag to its per-sample weights, the table
                # taking no gradient
                ww = w.detach().requires_grad_()
                bag = F.embedding_bag(rws64, table, per_sample_weights=ww,
                                      mode="sum")
                library = lambda: torch.autograd.grad(  # noqa: E731
                    bag, ww, g, retain_graph=True)[0]
            rows[name].append(measure(
                f"{name} ({payload}, {stage})", n, call, plain, (1e-4, 1e-5),
                device_kernel="lookup_bwd",
                bound=no_scatter_bound(n, distinct, row_bytes, stage,
                                       n * TOP_K, rows_apart=True),
                extra={"payload": payload, "stage": stage, **route},
                library=library, library_tol=(1e-4, 1e-5)))


def serve_path(name: str):
    """Serve one path at full width; returns (launch counts, report)."""
    argv, needs = PATHS[name]
    finite = []
    decode_step = transformer.decode_step

    def checked_decode(*args, **kw):
        logits = decode_step(*args, **kw)
        finite.append(torch.isfinite(logits).all())  # no host sync here
        return logits

    transformer.decode_step = checked_decode
    reset_counts()
    t0 = time.perf_counter()
    try:
        report = serve.main(argv + SERVE_ARGS)
        torch.cuda.synchronize()
    finally:
        transformer.decode_step = decode_step
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    args = serve.build_argparser().parse_args(argv + SERVE_ARGS)
    vocab = (configs.get_smoke_config(args.arch) if args.smoke
             else configs.get_config(args.arch)).vocab_size
    check(len(report.requests) == 8,
          f"{name}: served {len(report.requests)} of 8 requests")
    for kernel in needs:
        check(launches[kernel] > 0,
              f"{name}: {kernel} never launched on the serve path")
    check(bool(torch.stack(finite).all()), f"{name}: non-finite logits")
    for r in report.requests:
        check(np.isfinite(r.first_logits).all()
              and r.first_logits.shape == (vocab,),
              f"{name}: request {r.id}: bad prefill logits")
    cache = report.cache
    if name != "dense":
        check(cache is not None, f"{name}: no cache summary")
        if name.endswith("resident"):
            check(cache["uncached"] == 0 and cache["misses"] == 0,
                  f"{name}: the whole table should be resident: {cache}")
    touched = (cache["hits"] + cache["misses"] + cache["uncached"]
               if cache else 0)
    print(json.dumps({
        "serve": name, "argv": argv,
        "requests": len(report.requests),
        "generated_tokens": report.generated_tokens,
        "tokens_per_sec": report.tokens_per_sec,
        "decode_p50_ms": report.p50_ms(), "decode_p99_ms": report.p99_ms(),
        "prefill_median_ms": 1e3 * float(np.median(report.prefill_s)),
        "decode_ticks": len(report.step_s), "wall_s": report.wall_s,
        "serve_s_incl_init": serve_s, "cache": cache,
        "overflow_share": cache["uncached"] / touched if touched else None,
        "launches": launches,
    }), flush=True)
    return launches, report


def same_first_logits(name: str, got, want, tol: float = 1e-5) -> float:
    err = max(float(np.abs(a.first_logits - b.first_logits).max())
              for a, b in zip(got.requests, want.requests))
    check(err <= tol, f"{name}: first logits differ by {err}")
    return err


def profile_path(name: str):
    """A shorter serve of the path's warmed engine under torch.profiler:
    kernel time by name and the device's busy share of the engine's wall
    time (profiling slows the host, so the share is a lower bound).  Only
    the trace's replay is profiled: model build and warm-up run before."""
    argv, _ = PATHS[name]
    args = serve.build_argparser().parse_args(argv + SERVE_ARGS)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.placement:
        cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, interp_impl=args.placement))
    if args.cache_slots:
        cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
            cfg.lram, tiered=dataclasses.replace(
                cfg.lram.tiered, cache_slots=args.cache_slots)))
    model = transformer.init(cfg, seed=args.seed).to(args.device)
    engine = ServeEngine(model, EngineConfig(slots=4, max_len=64 + 16))
    engine.warmup()
    trace = synthetic_trace(np.random.default_rng(0), 4,
                            vocab_size=cfg.vocab_size, max_prompt=64,
                            max_gen=16)
    report, per_kernel, _ = profile(lambda: engine.run(trace))
    del engine, model
    kernels = {k: v for k, v in per_kernel.items()
               if not k.startswith(("Memcpy", "Memset"))}
    copies = {k: v for k, v in per_kernel.items()
              if k.startswith(("Memcpy", "Memset"))}
    total_ms = sum(kernels.values()) / 1e3
    ours = ("lram_query_kernel", "gather_interp_kernel",
            "gather_interp_quant_kernel", "tiered_gather_kernel",
            "tiered_gather_quant_kernel")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "profile": name, "requests": 4, "max_gen": 16,
        "wall_ms": 1e3 * report.wall_s, "kernel_ms": total_ms,
        "copy_ms": sum(copies.values()) / 1e3,
        "busy_share": total_ms / (1e3 * report.wall_s),
        "decode_ticks": len(report.step_s),
        "decode_p50_ms": report.p50_ms(),
        "memory_kernels_ms": sum(v for k, v in kernels.items()
                                 if any(o in k for o in ours)) / 1e3,
        "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
        "copies_ms": [[k[:60], v / 1e3] for k, v in copies.items()],
    }), flush=True)


def parity_phase():
    """The smoke configs: tiered on the card against the CPU's plain
    versions (both archs), and tiered against dense on the card."""
    base = ["--smoke", "--batch", "2", "--prompt-len", "16", "--gen", "4",
            "--requests", "3", "--seed", "1"]
    out = {}
    for arch in ("lram-tiered", "lram-tiered-q8"):
        argv = base + ["--arch", arch]
        gpu = serve.main(argv + ["--device", "cuda"])
        cpu = serve.main(argv + ["--device", "cpu"])
        check(len(gpu.requests) == len(cpu.requests) == 3,
              "parity trace lost requests")
        out[arch] = {
            "card_vs_cpu_first_logits_max_abs_err": same_first_logits(
                f"{arch} smoke card vs CPU", gpu, cpu),
            "greedy_tokens_equal": all(
                a.tokens == b.tokens
                for a, b in zip(gpu.requests, cpu.requests)),
            "cache_card": gpu.cache, "cache_cpu": cpu.cache}
    tiered = serve.main(base + ["--arch", "lram-tiered", "--device", "cuda"])
    dense = serve.main(base + ["--arch", "lram-tiered", "--device", "cuda",
                               "--placement", "pallas"])
    out["tiered_vs_dense_card_first_logits_max_abs_err"] = \
        same_first_logits("smoke tiered vs dense on the card", tiered, dense)
    print(json.dumps({"parity": "smoke configs", **out}), flush=True)


TRAIN_STEPS = 20
TRAIN_ARGS = ["--arch", "lram-bert-medium", "--placement", "pallas",
              "--batch", "8", "--seq", "256", "--steps", str(TRAIN_STEPS),
              "--json"]


def train_path():
    """Train lram-bert-medium at full width; returns (launch counts, run).
    The launch counts are reset just before and read just after."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(run.records) == TRAIN_STEPS, "train: steps missing")
    for kernel in ("lram_query", "gather_interp"):
        check(launches[kernel] >= TRAIN_STEPS,
              f"train: {kernel} launched {launches[kernel]} times in "
              f"{TRAIN_STEPS} steps")
    check(launches["lookup_bwd"] == TRAIN_STEPS,
          f"train: the backward kernel launched {launches['lookup_bwd']} "
          f"times in {TRAIN_STEPS} steps (one memory layer: once a step)")
    losses = [r["loss"] for r in run.records]
    norms = [r["grad_norm"] for r in run.records]
    check(all(math.isfinite(x) for x in losses + norms),
          f"train: non-finite loss or grad norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"train: the loss did not fall (steps 1-5 mean "
                        f"{first}, steps 16-20 mean {last})")
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[5:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    print(json.dumps({
        "train": "lram-bert-medium", "argv": TRAIN_ARGS,
        "tokens_per_step": tokens, "lookups_per_step": tokens * 32,
        "losses": losses, "grad_norms": norms,
        "loss_mean_steps_1_5": first, "loss_mean_steps_16_20": last,
        "step_ms": step_ms, "step_ms_median_steps_6_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "peak_memory_bytes": peak, "wall_s_incl_init_and_eval": wall_s,
        "final_eval_loss": run.final_eval_loss,
        "final_fact_recall": run.final_fact_recall, "launches": launches,
    }), flush=True)
    return launches, run


def profile_train_step(run, label: str = "train step",
                       ours=("lram_query_kernel", "gather_interp_kernel",
                             "lookup_bwd")) -> None:
    """One more full-width train step under torch.profiler: device busy
    share of the step's wall time and the top kernels; and K1 in that
    step beside its bound on the step's own indices (each distinct row
    they name read once)."""
    batch = train.batch_to(data.get_batch(run.dcfg, step=TRAIN_STEPS),
                           next(run.model.parameters()).device)
    wall, k1_calls = [], []
    k1 = gather_interp.gather_interp

    def recorded_k1(values, idx, w):
        k1_calls.append(idx)
        return k1(values, idx, w)

    def step():
        t0 = time.perf_counter()
        out = run.step_fn(run.opt_state, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        return out

    # the wrapper counts its launches through its module's name
    recorded_k1.launches = k1.launches
    gather_interp.gather_interp = recorded_k1
    try:
        _, per_kernel, calls = profile(step)
    finally:
        gather_interp.gather_interp = k1
        k1.launches = recorded_k1.launches
    k1_step = None
    if k1_calls:
        n = sum(idx.numel() // TOP_K for idx in k1_calls)
        distinct = sum(torch.unique(idx).numel() for idx in k1_calls)
        b, by = gather_bound(distinct, 4 * M, n)
        k1_step = {
            "calls": len(k1_calls), "n": n, "distinct_rows": distinct,
            "device_ms": sum(v for k, v in per_kernel.items()
                             if "gather_interp_kernel" in k) / 1e3,
            "device_events": sum(c for k, c in calls.items()
                                 if "gather_interp_kernel" in k),
            "bound_ms": b, "bound_by": by}
        del k1_calls
    kernels = {k: v for k, v in per_kernel.items()
               if not k.startswith(("Memcpy", "Memset"))}
    copies = {k: v for k, v in per_kernel.items()
              if k.startswith(("Memcpy", "Memset"))}
    total_ms = sum(kernels.values()) / 1e3
    mine = {name: sum(v for k, v in kernels.items() if name in k) / 1e3
            for name in ours}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "profile": label, "wall_ms": 1e3 * wall[0],
        "kernel_ms": total_ms, "copy_ms": sum(copies.values()) / 1e3,
        "busy_share": total_ms / (1e3 * wall[0]),
        "kernel_launches": sum(c for k, c in calls.items() if k in kernels),
        "memory_kernels_ms": mine, "k1": k1_step,
        "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
        "copies_ms": [[k[:60], v / 1e3] for k, v in copies.items()],
    }), flush=True)


# path -> (arch, its store's class, its forward gather, its backward
# instance, steps)
TIERED_TRAIN = {
    "a_train_tiered": ("lram-tiered", TieredValueStore, "gather_interp",
                       "lookup_bwd_rows", TRAIN_STEPS),
    "b_train_tiered_q8": ("lram-tiered-q8", TieredValueStore,
                          "gather_interp_quant", "lookup_bwd_quant",
                          TRAIN_STEPS),
    "c_train_sharded_tiered": ("lram-sharded-tiered", ShardedTieredStore,
                               "gather_interp", "lookup_bwd_rows", 10),
}
TIERED_ARGS = ["--batch", "8", "--seq", "64", "--json"]


def _host_tier(store):
    """A copy of the host tier: its payload as (N, m) rows and its scales
    (or None), every range's for a sharded-tiered store."""
    parts = getattr(store, "parts", [store])
    host = np.concatenate([p._host.reshape(p.num_rows, -1) for p in parts])
    if parts[0]._host_scale is None:
        return host, None
    return host, np.concatenate([p._host_scale.reshape(-1) for p in parts])


def tiered_train_path(name: str):
    """Train a tiered arch at full width through the store's write-back;
    returns (launch counts, run).  The launch counts are reset just
    before and read just after.  Inside the timed steps the wrappers only
    read clocks and keep references: the host tier is copied when the
    trainer binds the store, the write-back is timed (the wait for the
    backward, by the synchronize its own copy to the host would make, and
    its host work), the host index arrays it applies are kept and reduced
    to the touched rows after the run, and the flat route's host time and
    stats are read per call.  A sharded-tiered store writes back once a
    step and each of its ranges once a step."""
    arch, cls, gather, bwd, steps = TIERED_TRAIN[name]
    argv = ["--arch", arch, *TIERED_ARGS, "--steps", str(steps)]
    before, applied, wb, fwd = {}, [], [], []
    bind = train.bind_stores
    writeback = cls.writeback
    apply_writeback = cls.apply_writeback
    lookup_rows = cls.lookup_rows

    def bind_and_copy(model, lr):
        stores = bind(model, lr)
        for store in stores:
            before[id(store)] = _host_tier(store)
        return stores

    def timed_writeback(self, idx, w, g):
        t0 = time.perf_counter()
        torch.cuda.synchronize()  # the backward queued ahead of the sink
        t1 = time.perf_counter()
        writeback(self, idx, w, g)
        wb.append({"wait_ms": 1e3 * (t1 - t0),
                   "host_ms": 1e3 * (time.perf_counter() - t1),
                   "to_host_bytes": idx.nbytes + w.nbytes + g.nbytes})

    def kept_apply_writeback(self, idx, wg):
        applied.append(idx)  # the host copy the write-back made; unchanged
        apply_writeback(self, idx, wg)

    def timed_lookup_rows(self, idx):
        prev = dict(self.stats)
        t0 = time.perf_counter()
        out = lookup_rows(self, idx)
        d = {k: self.stats[k] - prev[k] for k in prev}
        seen = d["hits"] + d["misses"] + d["uncached"]
        fwd.append({"host_ms": 1e3 * (time.perf_counter() - t0),
                    "overflow_share": d["uncached"] / seen,
                    "hit_rate": d["hits"] / seen,
                    "fill_bytes": d["fill_bytes"],
                    "overflow_bytes": d["uncached"]
                    * self.bytes_per_entry()})
        return out

    torch.cuda.reset_peak_memory_stats()
    train.bind_stores = bind_and_copy
    cls.writeback = timed_writeback
    cls.apply_writeback = kept_apply_writeback
    cls.lookup_rows = timed_lookup_rows
    reset_counts()
    t0 = time.perf_counter()
    try:
        run = train.main(argv)
        torch.cuda.synchronize()
    finally:
        train.bind_stores = bind
        cls.writeback = writeback
        cls.apply_writeback = apply_writeback
        cls.lookup_rows = lookup_rows
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(run.records) == steps, f"{name}: steps missing")
    for kernel in ("lram_query", gather):
        check(launches[kernel] >= steps,
              f"{name}: {kernel} launched {launches[kernel]} times in "
              f"{steps} steps")
    check(launches[bwd] == steps,
          f"{name}: the backward instance {bwd} launched {launches[bwd]} "
          f"times in {steps} steps (one memory layer: once a step)")
    (store,) = run.stores
    ranges = getattr(store, "num_ranges", 1)
    check(store.stats["writebacks"] == steps * ranges
          and steps == len(wb) == len(applied),
          f"{name}: {len(wb)} write-backs ({store.stats['writebacks']} "
          f"range write-backs) in {steps} steps")
    check(not any(p._dirty for p in getattr(store, "parts", [store])),
          f"{name}: dirty slots after the flush")
    host0, scale0 = before[id(store)]
    host1, scale1 = _host_tier(store)
    rows_n = store.num_rows
    changed = (host1 != host0).any(-1)
    if scale0 is not None:
        changed |= scale1 != scale0
    hit = np.zeros(rows_n, bool)
    hit[np.concatenate([i.reshape(-1) for i in applied])] = True
    check(not (changed & ~hit).any(),
          f"{name}: {int((changed & ~hit).sum())} rows the write-back never "
          f"touched changed on the host tier")
    check((changed & hit).any(), f"{name}: no touched row changed")
    losses = [r["loss"] for r in run.records]
    norms = [r["grad_norm"] for r in run.records]
    check(all(math.isfinite(x) for x in losses + norms),
          f"{name}: non-finite loss or grad norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"{name}: the loss did not fall (steps 1-5 mean "
                        f"{first}, the last 5 steps' mean {last})")
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[5:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    steady = lambda recs, key: float(np.median(  # noqa: E731
        [r[key] for r in recs[5:]]))
    print(json.dumps({
        "train": name, "argv": argv, "ranges": ranges,
        "tokens_per_step": tokens, "lookups_per_step": tokens * 32,
        "losses": losses, "grad_norms": norms,
        "loss_mean_steps_1_5": first, "loss_mean_last_5_steps": last,
        "step_ms": step_ms, "step_ms_median_steps_6_on": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "peak_memory_bytes": peak, "wall_s_incl_init_and_eval": wall_s,
        "writeback_host_ms_median_6_on": steady(wb, "host_ms"),
        "writeback_wait_ms_median_6_on": steady(wb, "wait_ms"),
        "to_host_bytes_per_step": wb[0]["to_host_bytes"],
        "flat_route_host_ms_median_6_on": steady(fwd, "host_ms"),
        "fill_bytes_per_step_median_6_on": steady(fwd, "fill_bytes"),
        "overflow_bytes_per_step_median_6_on": steady(fwd,
                                                      "overflow_bytes"),
        "hit_rate_train": float(np.mean([f["hit_rate"] for f in fwd])),
        "overflow_share_train": float(np.mean([f["overflow_share"]
                                               for f in fwd])),
        "rows_touched": int(hit.sum()), "rows_changed": int(changed.sum()),
        "store_stats": store.stats,
        "final_eval_loss": run.final_eval_loss,
        "final_fact_recall": run.final_fact_recall, "launches": launches,
    }), flush=True)
    return launches, run


MESH_RANKS = 4
MESH_ARGS = ["--arch", "lram-bert-medium", "--placement", "sharded",
             "--use-mesh", "--batch", "8", "--seq", "256", "--steps",
             str(TRAIN_STEPS), "--json"]
MESH_TIMEOUT_S = 600


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_config(args, placement: str, **lram_kw):
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    return dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl=placement, **lram_kw))


def _logits_agree(args, device, mesh) -> float:
    """The eval forward of the run's first eval batch on the dense pallas
    table and on this rank's shard, from the same seed's weights: the
    largest logit difference."""
    cfg = _mesh_config(args, "pallas")
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, objective=cfg.objective,
                           seed=args.seed)
    batch = train.batch_to(data.get_batch(dcfg, step=10_000_000), device)
    out = []
    for placement in ("pallas", "sharded"):
        model = transformer.init(_mesh_config(args, placement),
                                 seed=args.seed)
        if placement == "sharded":
            sharding.shard_params(model, mesh)
        with torch.no_grad():
            out.append(transformer.forward(model.to(device), batch))
        del model
    return (out[0] - out[1]).abs().max().item()


def _quant_cells_agree(args, device, mesh) -> dict:
    """The sharded int8 and e4m3 cells' memory layer (`lram_apply`, eval)
    against the dense 1-byte pallas cell (B4) on the same payloads, at the
    run's width (full: a 2^20 x 64 table, 32 heads) on one data rank's
    tokens (full: 1,024, n = 32,768 queries): the largest difference per
    payload."""
    from repro_torch.core import lram as lram_mod

    tokens = args.batch * args.seq // 2
    errs = {}
    for kind in PAYLOADS:
        # one draw on every rank: the model ranks' shards are one table
        dense = lram_mod.LRAM(
            _mesh_config(args, "pallas", table_quant=kind).lram,
            generator=torch.Generator().manual_seed(args.seed))
        shard = lram_mod.LRAM(_mesh_config(args, "sharded",
                                           table_quant=kind).lram)
        shard.load_state_dict(dense.state_dict())
        sharding.shard_params(shard, mesh)
        x = torch.randn(tokens, dense.cfg.in_dim,
                        generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            want = lram_mod.lram_apply(dense.to(device), x.to(device))
            got = lram_mod.lram_apply(shard.to(device), x.to(device))
        errs[kind] = (got - want).abs().max().item()
        del dense, shard
    return errs


def _rank_env(rank: int, port: int) -> None:
    """A spawned rank's torchrun environment (all ranks on the one card),
    and no TF32, as in the parent."""
    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(MESH_RANKS),
                       "LOCAL_WORLD_SIZE": str(MESH_RANKS),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _spawn_ranks(fn, args, what: str) -> tuple[list[dict], float]:
    """Run fn(rank, port, results, *args) in MESH_RANKS spawned processes
    (a free port for their rendezvous); fails if a rank fails, dies or
    outlasts MESH_TIMEOUT_S, or fewer than all report.  Returns every
    rank's result, by rank, and the wall seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = mp.start_processes(fn, args=(port, results, *args),
                               nprocs=MESH_RANKS, join=False,
                               start_method="spawn")
    got = []
    try:
        while True:
            while not results.empty():  # a rank blocks on a full pipe
                got.append(results.get())
            if procs.join(timeout=5):
                break
            check(time.perf_counter() - t0 < MESH_TIMEOUT_S,
                  f"{what}: the ranks outlasted {MESH_TIMEOUT_S} s "
                  f"(a missing collective?)")
    except mp.ProcessRaisedException as e:
        fail(f"{what}: a rank failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"{what}: a rank died: {e}")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    wall_s = time.perf_counter() - t0
    while not results.empty():
        got.append(results.get())
    check(len(got) == MESH_RANKS, f"{what}: {len(got)} of {MESH_RANKS} "
                                  f"ranks reported")
    return sorted(got, key=lambda r: r["rank"]), wall_s


def mesh_rank(rank: int, port: int, results, argv, device_name) -> None:
    """One rank of the mesh phase (a spawned process; all ranks on the one
    card): the two forward checks, the mesh training through `train.main`
    with its launch counts reset just before and read just after, then two
    more steps with every sum across ranks timed."""
    _rank_env(rank, port)
    args = train.build_argparser().parse_args(argv)
    mesh, device = mesh_lib.init_mesh(device_name)
    out = {"rank": rank, "coords": mesh.coords, "mesh": mesh.shape,
           "backend": dist.get_backend()}
    out["logits_max_abs_err"] = _logits_agree(args, device, mesh)
    reset_counts()
    out["quant_max_abs_err"] = _quant_cells_agree(args, device, mesh)
    out["quant_launches"] = read_counts()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train.main(argv)
    _sync(device)
    out["launches"] = read_counts()
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                if device.type == "cuda" else None)
    out["records"] = run.records
    out["final_eval_loss"] = run.final_eval_loss
    # two more steps, every sum across ranks timed (the device synchronized
    # before and after each, so its time is the collective's alone)
    all_reduce = collectives.all_reduce_
    comm = []

    def timed(t, group):
        _sync(device)
        t0 = time.perf_counter()
        all_reduce(t, group)
        _sync(device)
        comm.append((time.perf_counter() - t0, t.numel() * t.element_size()))
        return t

    collectives.all_reduce_ = timed
    walls = []
    try:
        for step in (args.steps, args.steps + 1):
            batch = train.batch_to(data.get_batch(run.dcfg, step=step),
                                   device)
            comm.clear()
            t0 = time.perf_counter()
            run.step_fn(run.opt_state, batch)
            _sync(device)
            walls.append((time.perf_counter() - t0,
                          sum(c for c, _ in comm), len(comm),
                          sum(b for _, b in comm)))
    finally:
        collectives.all_reduce_ = all_reduce
    out["timed_steps"] = [{"wall_ms": 1e3 * w, "collective_ms": 1e3 * c,
                           "collectives": k, "collective_bytes": b,
                           "collective_share": c / w}
                          for w, c, k, b in walls]
    results.put(out)
    dist.destroy_process_group()


def mesh_phase(dense_records, argv=MESH_ARGS, device_name="cuda"):
    """Spawn 4 ranks on the one card (gloo: a data 2 x model 2 mesh, the
    2^20-row table row-sharded over model, 128 MiB a rank) to train
    lram-bert-medium at full width 20 steps; fails unless every rank
    launched K2, the range gather and the range backward (once a step),
    the losses are finite and fall, they match the dense run of phase 6
    (rtol 1e-4 over steps 1-5, 1e-3 over all 20), and the two forward
    checks hold to 1e-5.  Returns the launch counts summed over ranks
    (training, and the 1-byte forward check) and rank 0's losses."""
    if device_name == "cuda":
        torch.cuda.empty_cache()
    steps = train.build_argparser().parse_args(argv).steps
    ranks, wall_s = _spawn_ranks(mesh_rank, (argv, device_name),
                                 "mesh phase")
    dense = [r["loss"] for r in dense_records]
    for r in ranks:
        who = f"mesh rank {r['rank']}"
        c = r["launches"]
        check(c["lram_query"] >= steps and c["sharded_gather"] >= steps,
              f"{who}: K2 / the range gather launched {c['lram_query']} / "
              f"{c['sharded_gather']} times in {steps} steps")
        check(c["lookup_bwd_range"] == steps,
              f"{who}: the range backward launched "
              f"{c['lookup_bwd_range']} times in {steps} steps")
        check(r["quant_launches"]["sharded_gather_quant"] == len(PAYLOADS),
              f"{who}: the 1-byte range gather did not launch")
        losses = [x["loss"] for x in r["records"]]
        norms = [x["grad_norm"] for x in r["records"]]
        check(len(losses) == steps
              and all(math.isfinite(x) for x in losses + norms),
              f"{who}: steps missing or non-finite: {losses} {norms}")
        check(np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"{who}: the loss did not fall: {losses}")
        check(np.allclose(losses[:5], dense[:5], rtol=1e-4, atol=0)
              and np.allclose(losses, dense, rtol=1e-3, atol=0),
              f"{who}: losses differ from the dense run: {losses} vs "
              f"{dense}")
        check(r["logits_max_abs_err"] <= 1e-5,
              f"{who}: eval logits differ from the dense path by "
              f"{r['logits_max_abs_err']}")
        check(all(e <= 1e-5 for e in r["quant_max_abs_err"].values()),
              f"{who}: the 1-byte sharded cells differ from the dense "
              f"B4 cell: {r['quant_max_abs_err']}")
    r0 = ranks[0]
    args = train.build_argparser().parse_args(argv)
    step_ms = [x["step_ms"] for x in r0["records"]]
    median_ms = float(np.median(step_ms[5:]))
    tokens = args.batch * args.seq
    losses = np.array([x["loss"] for x in r0["records"]])
    print(json.dumps({
        "train": "mesh", "argv": argv, "ranks": MESH_RANKS,
        "mesh": r0["mesh"], "backend": r0["backend"], "device": device_name,
        "tokens_per_step": tokens,
        "lookups_per_rank_step": tokens // 2
        * _mesh_config(args, "sharded").lram.heads,
        "losses": losses.tolist(),
        "grad_norms": [x["grad_norm"] for x in r0["records"]],
        "dense_losses": dense,
        "loss_max_rel_err_steps_1_5": float(np.max(np.abs(
            losses[:5] / np.array(dense[:5]) - 1))),
        "loss_max_rel_err": float(np.max(np.abs(
            losses / np.array(dense) - 1))),
        "loss_mean_steps_1_5": float(np.mean(losses[:5])),
        "loss_mean_steps_16_20": float(np.mean(losses[-5:])),
        "step_ms": step_ms, "step_ms_median_steps_6_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                      for r in ranks],
        "timed_steps_by_rank": [r["timed_steps"] for r in ranks],
        "logits_max_abs_err_by_rank": [r["logits_max_abs_err"]
                                       for r in ranks],
        "quant_max_abs_err_by_rank": [r["quant_max_abs_err"]
                                      for r in ranks],
        "launches_by_rank": [r["launches"] for r in ranks],
        "final_eval_loss": r0["final_eval_loss"],
        "wall_s_incl_spawn_init_checks_eval": wall_s,
    }), flush=True)
    total = {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
    quant_total = {k: sum(r["quant_launches"][k] for r in ranks)
                   for k in KERNELS}
    return total, quant_total, losses.tolist()


PKM_ARGS = ["--arch", "lram-bert-pkm", "--batch", "8", "--seq", "256",
            "--steps", str(TRAIN_STEPS), "--json"]


def pkm_train_path():
    """Train the paper's PKM baseline at full width (2^16 x 512 table, 8
    heads, top-32); returns (launch counts, run).  The reference computes
    PKM without a Pallas kernel, so no kernel of the port may launch here:
    the counts are reset just before and read just after, and must all be
    0."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = train.main(PKM_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    check(not any(launches.values()),
          f"pkm: a kernel of the port launched on the PKM path: {launches}")
    check(len(run.records) == TRAIN_STEPS, "pkm: steps missing")
    losses = [r["loss"] for r in run.records]
    norms = [r["grad_norm"] for r in run.records]
    check(all(math.isfinite(x) for x in losses + norms),
          f"pkm: non-finite loss or grad norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"pkm: the loss did not fall (steps 1-5 mean "
                        f"{first}, steps 16-20 mean {last})")
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[5:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    print(json.dumps({
        "train": "lram-bert-pkm", "argv": PKM_ARGS,
        "tokens_per_step": tokens, "losses": losses, "grad_norms": norms,
        "loss_mean_steps_1_5": first, "loss_mean_steps_16_20": last,
        "step_ms": step_ms, "step_ms_median_steps_6_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "wall_s_incl_init_and_eval": wall_s,
        "final_eval_loss": run.final_eval_loss, "launches": launches,
    }), flush=True)
    return launches, run


class _Tee(io.TextIOBase):
    """Standard output that also keeps what was written."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        return self.kept.write(text)

    def flush(self):
        self.out.flush()


class RecordingManager(CheckpointManager):
    """The CLIs' checkpoint manager, kept for its save and restore
    timings; right after a restore it holds every store it streamed into
    against the checkpoint's shard files (payload and scales equal)."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.restored_stores = []
        RecordingManager.made.append(self)

    def restore(self, like, **kw):
        step, tree = super().restore(like, **kw)
        stores = {id(x): x for _, x in _tree_items(like)
                  if lookup.is_store(x)}
        self.restored_stores = list(stores.values())
        d = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(d, "manifest.json")) as f:
            metas = [m for m in json.load(f)["leaves"].values()
                     if m.get("kind") == "tiered"]
        check(len(metas) == len(self.restored_stores),
              "restore: one tiered entry a store")
        for store, meta in zip(self.restored_stores, metas):
            shards = os.path.join(d, meta["dir"])
            for i in range(store.num_shards):
                same = np.array_equal(store.shard_host(i), _load(
                    os.path.join(shards, f"shard_{i:06d}.npy")))
                if store.quant != "none":
                    same &= np.array_equal(store.shard_scale_host(i), _load(
                        os.path.join(shards, f"scale_{i:06d}.npy")))
                check(same, f"restore: shard {i} differs from the saved one")
        return step, tree


def _cli(main, argv, *, crash: bool = False):
    """Run a CLI's `main` with the launch counts reset just before and
    read just after; returns (result or the failure, its step records,
    its output, launch counts).  With `crash` it must raise
    SimulatedFailure, and only that is caught."""
    tee = _Tee(sys.stdout)
    reset_counts()
    with contextlib.redirect_stdout(tee):
        if crash:
            try:
                main(argv)
            except fault.SimulatedFailure as e:
                result = e
            else:
                fail(f"{argv}: no SimulatedFailure")
        else:
            result = main(argv)
        torch.cuda.synchronize()
    launches = read_counts()
    out = tee.kept.getvalue()
    steps = [json.loads(x) for x in out.splitlines()
             if x.startswith('{"step"')]
    return result, steps, out, launches


def _history(managers) -> list[dict]:
    """Each save's snapshot and write ms and bytes, each restore's ms."""
    return [h for m in managers for h in m.history]


def dense_resume_path(dense_records, ckpt_dir):
    """lram-bert-medium (`--placement pallas`) at full width saves every 10
    steps, fails before step 15 and is relaunched: the relaunch resumes
    from step 10; its step-10 loss is the crashed run's bit for bit (the
    forward's kernels K2 and K1 are deterministic); steps 10-14 within
    rtol 1e-4 and 15-19 within 1e-3 of `train_path`'s uninterrupted run
    (the backward's scatter adds in atomic order).  Returns the launch
    counts of both runs."""
    argv = TRAIN_ARGS + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "10"]
    _, crashed, _, crash_launches = _cli(
        train.main, argv + ["--simulate-failure-at", "15"], crash=True)
    check([r["step"] for r in crashed] == list(range(15)),
          "dense resume: the crashed run's steps")
    run, _, out, resume_launches = _cli(train.main, argv)
    check("resumed from step 10\n" in out and run.start_step == 10,
          "dense resume: the relaunch did not resume from step 10")
    for name, launches in (("crashed", crash_launches),
                           ("resumed", resume_launches)):
        for kernel in ("lram_query", "gather_interp", "lookup_bwd"):
            check(launches[kernel] > 0,
                  f"dense resume: {kernel} never launched in the {name} run")
    got = [r["loss"] for r in run.records]
    want = [r["loss"] for r in dense_records[10:]]
    check(got[0] == crashed[10]["loss"],
          f"dense resume: step 10 loss {got[0]} != the crashed run's "
          f"{crashed[10]['loss']}")
    err = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    check(len(got) == 10 and max(err[:5]) <= 1e-4 and max(err) <= 1e-3,
          f"dense resume: losses {got} against {want}")
    print(json.dumps({
        "resume": "lram-bert-medium", "argv": argv,
        "crashed_losses": [r["loss"] for r in crashed],
        "resumed_losses": got, "uninterrupted_losses": want,
        "rel_err_steps_10_14": max(err[:5]), "rel_err_steps_10_19": max(err),
        "checkpoints": _history(RecordingManager.made),
        "launches_crashed": crash_launches,
        "launches_resumed": resume_launches,
    }), flush=True)
    saved = {"layout": _layout(ckpt_dir, 10), "bytes": next(
        h["bytes"] for h in _history(RecordingManager.made)
        if h["op"] == "save" and h["step"] == 10)}
    return crash_launches, resume_launches, saved


def _layout(ckpt_dir: str, step: int) -> dict:
    """A checkpoint's leaf names, shapes, dtypes and kinds (no checksums)."""
    with open(os.path.join(ckpt_dir, f"step_{step:012d}",
                           "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {n: [m.get("shape"), m.get("dtype"), m.get("kind")]
            for n, m in leaves.items()}


MESH_CKPT_ARGS = ["--arch", "lram-bert-medium", "--placement", "sharded",
                  "--use-mesh", "--batch", "8", "--seq", "256", "--steps",
                  "12", "--ckpt-every", "6", "--json"]
MESH_CRASH_AT = 9
# one process restores the mesh's step-12 checkpoint into the dense table
ELASTIC_ARGS = ["--arch", "lram-bert-medium", "--placement", "pallas",
                "--batch", "8", "--seq", "256", "--steps", "14", "--json"]


def mesh_ckpt_rank(rank: int, port: int, results, argv, device_name,
                   crash: bool) -> None:
    """One rank of phase 6c (a spawned process): `train.main(argv)` with
    its launch counts reset just before and read just after and its
    checkpoint managers recorded; with `crash` it must raise
    SimulatedFailure, and only that is caught."""
    _rank_env(rank, port)
    train.CheckpointManager = RecordingManager
    RecordingManager.made = []
    tee = _Tee(sys.stdout)
    reset_counts()
    with contextlib.redirect_stdout(tee):
        try:
            run = train.main(argv)
        except fault.SimulatedFailure:
            run = None
    _sync(torch.device(device_name))
    launches = read_counts()
    check((run is None) == crash, f"mesh resume rank {rank}: "
          f"{'no' if crash else 'a'} SimulatedFailure")
    out = tee.kept.getvalue().splitlines()
    results.put({
        "rank": rank, "launches": launches,
        "history": _history(RecordingManager.made),
        "steps": [json.loads(x) for x in out if x.startswith('{"step"')],
        "resumed": [x for x in out if x.startswith("resumed from")],
        "start_step": None if run is None else run.start_step,
        "records": [] if run is None else run.records})
    dist.destroy_process_group()


# the mesh resume's and the elastic restore's losses against phase 6b's:
# the same steps from the same state, apart in float rounding only (the
# scatter's atomics; one process's sums against the mesh's): 1.3e-7 at
# most measured on an H100
RESUME_RTOL = 1e-5


def mesh_resume_path(mesh_losses, dense_saved, ckpt_dir,
                     argv=MESH_CKPT_ARGS, device_name="cuda",
                     dense_argv=ELASTIC_ARGS):
    """Phase 6c: the mesh run of phase 6b (4 ranks, data 2 x model 2, the
    table row-sharded over model) with a save every 6 steps fails before
    step 9 on every rank and is relaunched on 4 new ranks: rank 0 alone
    prints `resumed from step 6`, the step-6 loss is the crashed run's
    bit for bit, steps 6-11 are within rtol 1e-5 of phase 6b's, K2, the
    range gather and the range backward launched on every rank in both
    runs, and the step-12 checkpoint has phase 6a's leaf names, shapes,
    dtypes and bytes (a one-process checkpoint's).  Then one process
    restores it into the dense pallas table and trains steps 12-13 (rtol
    1e-5 of phase 6b's; K2, K1 and `lookup_bwd` launched).  Returns the
    three runs' launch counts (the mesh runs' summed over ranks)."""
    if device_name == "cuda":
        torch.cuda.empty_cache()
    argv = argv + ["--ckpt-dir", ckpt_dir]
    crashed, crash_s = _spawn_ranks(
        mesh_ckpt_rank, (argv + ["--simulate-failure-at",
                                 str(MESH_CRASH_AT)], device_name, True),
        "mesh crash")
    resumed, resume_s = _spawn_ranks(
        mesh_ckpt_rank, (argv, device_name, False), "mesh resume")
    crash_losses = [x["loss"] for x in crashed[0]["steps"]]
    check(len(crash_losses) == MESH_CRASH_AT,
          f"mesh crash: {len(crash_losses)} steps before the failure")
    check(resumed[0]["resumed"] == ["resumed from step 6"]
          and not any(r["resumed"] for r in resumed[1:])
          and all(r["start_step"] == 6 for r in resumed),
          "mesh resume: rank 0 alone should print resumed from step 6")
    got = [x["loss"] for x in resumed[0]["records"]]
    check(len(got) == 6 and got[0] == crash_losses[6],
          f"mesh resume: step 6 loss {got[:1]} != the crashed run's "
          f"{crash_losses[6]}")
    err = [abs(a - b) / abs(b) for a, b in zip(got, mesh_losses[6:12])]
    check(max(err) <= RESUME_RTOL, f"mesh resume: losses {got} against phase "
                            f"6b's {mesh_losses[6:12]}")
    for name, ranks in (("crashed", crashed), ("resumed", resumed)):
        for r in ranks:
            for kernel in ("lram_query", "sharded_gather",
                           "lookup_bwd_range"):
                check(r["launches"][kernel] > 0,
                      f"mesh {name} rank {r['rank']}: {kernel} never "
                      f"launched")
    layout = _layout(ckpt_dir, 12)
    check(layout == dense_saved["layout"],
          "mesh resume: the step-12 checkpoint's leaves differ from phase "
          "6a's one-process checkpoint")
    saves = [h for h in resumed[0]["history"] if h["op"] == "save"]
    check(abs(saves[-1]["bytes"] - dense_saved["bytes"]) <= 256,
          f"mesh resume: {saves[-1]['bytes']} bytes saved against phase "
          f"6a's {dense_saved['bytes']}")
    run, _, out, dense_launches = _cli(train.main,
                                       dense_argv + ["--ckpt-dir", ckpt_dir])
    check("resumed from step 12\n" in out and run.start_step == 12,
          "mesh elastic restore: one process did not resume from step 12")
    dense_got = [r["loss"] for r in run.records]
    dense_err = [abs(a - b) / abs(b)
                 for a, b in zip(dense_got, mesh_losses[12:14])]
    check(len(dense_got) == 2 and max(dense_err) <= RESUME_RTOL,
          f"mesh elastic restore: losses {dense_got} against phase 6b's "
          f"{mesh_losses[12:14]}")
    for kernel in ("lram_query", "gather_interp", "lookup_bwd"):
        check(dense_launches[kernel] > 0,
              f"mesh elastic restore: {kernel} never launched")
    print(json.dumps({
        "resume": "mesh lram-bert-medium", "argv": argv,
        "crashed_losses": crash_losses, "resumed_losses": got,
        "uninterrupted_losses": mesh_losses[6:12],
        "rel_err_steps_6_11": max(err),
        "checkpoints_by_rank": {
            "crashed": [r["history"] for r in crashed],
            "resumed": [r["history"] for r in resumed]},
        "wall_s_crashed": crash_s, "wall_s_resumed": resume_s,
        "elastic_restore_one_process": {
            "argv": dense_argv, "losses": dense_got,
            "mesh_losses": mesh_losses[12:14], "rel_err": max(dense_err),
            "checkpoints": _history(RecordingManager.made[-1:]),
            "launches": dense_launches},
        "launches_crashed_by_rank": [r["launches"] for r in crashed],
        "launches_resumed_by_rank": [r["launches"] for r in resumed],
    }), flush=True)
    total = [{k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
             for ranks in (crashed, resumed)]
    return total[0], total[1], dense_launches


Q8_CKPT_ARGS = ["--arch", "lram-tiered-q8", "--batch", "8", "--seq", "64",
                "--steps", "6", "--ckpt-every", "3", "--json"]


def tiered_resume_path(ckpt_dir):
    """lram-tiered-q8 at full width saves at step 3, fails before step 4
    and is relaunched: its step-3 loss is the crashed run's bit for bit,
    and every shard it restored (payload, scales) is the saved one.  Then
    `serve --ckpt-dir` restores step 6 and serves 8 requests through K2 +
    B4 from a table equal to the trained one bit for bit.  Returns the
    three runs' launch counts."""
    argv = Q8_CKPT_ARGS + ["--ckpt-dir", ckpt_dir]
    _, crashed, _, crash_launches = _cli(
        train.main, argv + ["--simulate-failure-at", "4"], crash=True)
    run, _, out, resume_launches = _cli(train.main, argv)
    check("resumed from step 3\n" in out and run.start_step == 3,
          "q8 resume: the relaunch did not resume from step 3")
    check(run.records[0]["loss"] == crashed[3]["loss"],
          f"q8 resume: step 3 loss {run.records[0]['loss']} != the crashed "
          f"run's {crashed[3]['loss']}")
    (trained,) = run.stores
    train_managers = list(RecordingManager.made)
    serve_argv = ["--arch", "lram-tiered-q8", "--ckpt-dir", ckpt_dir,
                  "--json"] + SERVE_ARGS
    report, _, out, serve_launches = _cli(serve.main, serve_argv)
    check('{"restored_step": 6}' in out.splitlines(),
          "q8 serve: did not restore step 6")
    check(len(report.requests) == 8,
          f"q8 serve: served {len(report.requests)} of 8 requests")
    for kernel in ("lram_query", "gather_interp_quant"):
        check(serve_launches[kernel] > 0,
              f"q8 serve: {kernel} never launched")
    (served,) = RecordingManager.made[-1].restored_stores
    served.flush()
    check(np.array_equal(served._host, trained._host)
          and np.array_equal(served._host_scale, trained._host_scale),
          "q8 serve: the served table is not the trained one")
    for name, launches in (("crashed", crash_launches),
                           ("resumed", resume_launches)):
        for kernel in ("lram_query", "gather_interp_quant",
                       "lookup_bwd_quant"):
            check(launches[kernel] > 0,
                  f"q8 resume: {kernel} never launched in the {name} run")
    print(json.dumps({
        "resume": "lram-tiered-q8", "argv": argv,
        "crashed_losses": [r["loss"] for r in crashed],
        "resumed_losses": [r["loss"] for r in run.records],
        "checkpoints": _history(train_managers),
        "serve_restore": _history(RecordingManager.made[-1:]),
        "serve_tokens_per_sec": report.tokens_per_sec,
        "serve_decode_p50_ms": report.p50_ms(),
        "launches_crashed": crash_launches,
        "launches_resumed": resume_launches,
        "launches_serve": serve_launches,
    }), flush=True)
    return crash_launches, resume_launches, serve_launches


@contextlib.contextmanager
def checkpoint_dir():
    """A checkpoint directory under the system temp directory, deleted
    afterwards; meanwhile the CLIs make RecordingManagers."""
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    patched = (train.CheckpointManager, serve.CheckpointManager)
    train.CheckpointManager = serve.CheckpointManager = RecordingManager
    RecordingManager.made = []
    try:
        yield root
    finally:
        train.CheckpointManager, serve.CheckpointManager = patched
        shutil.rmtree(root, ignore_errors=True)


def train_parity(arch: str, extra=()) -> None:
    """A smoke config, 5 steps on the card and on the CPU (plain versions)
    from the same seed's weights and batches: per-step losses and gradient
    norms to rtol 1e-4 (atomics and another summation order; for the
    tiered archs w (x) g rounds differently, which may flip a stochastic
    floor of the int8 write-back now and then)."""
    argv = ["--arch", arch, "--smoke", *extra, "--steps", "5", "--batch",
            "4", "--seq", "32", "--seed", "1"]
    card = train.main(argv + ["--device", "cuda"])
    cpu = train.main(argv + ["--device", "cpu"])
    out = {"parity": f"smoke train card vs CPU: {arch}"}
    for key in ("loss", "grad_norm"):
        pairs = [(a[key], b[key]) for a, b in zip(card.records, cpu.records)]
        err = max(abs(a - b) / abs(b) for a, b in pairs)
        check(len(pairs) == 5 and err <= 1e-4,
              f"{arch} smoke train {key} differs card vs CPU: {pairs}")
        out.update({key: pairs, f"{key}_max_rel_err": err})
    if card.stores:
        out["writebacks"] = [card.stores[0].stats["writebacks"],
                             cpu.stores[0].stats["writebacks"]]
        out["table_max_abs_diff"] = float(np.abs(
            card.stores[0].to_dense() - cpu.stores[0].to_dense()).max())
    print(json.dumps(out), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}", flush=True)
    print(json.dumps({"ptxas": [dict(r, source=name)
                                for name, log in logs.items()
                                for r in ptxas_report(log)]}), flush=True)

    rows = kernel_phase(device)
    launches, reports = {}, {}
    for name in PATHS:
        launches[name], reports[name] = serve_path(name)
    print(json.dumps({"placements_agree": {
        "a_vs_dense": same_first_logits("(a) vs dense", reports["a_tiered"],
                                        reports["dense"]),
        "c_vs_dense": same_first_logits(
            "(c) vs dense", reports["c_tiered_resident"], reports["dense"]),
        "d_vs_b": same_first_logits(
            "(d) vs (b)", reports["d_tiered_q8_resident"],
            reports["b_tiered_q8"]),
        "e_vs_dense": same_first_logits(
            "(e) vs dense", reports["e_sharded_tiered"], reports["dense"]),
        "f_vs_dense": same_first_logits(
            "(f) vs dense", reports["f_sharded_tiered_resident"],
            reports["dense"]),
    }}), flush=True)
    del reports
    for name in PATHS:
        profile_path(name)
    launches["train"], run = train_path()
    profile_train_step(run)
    dense_records = run.records
    del run
    with checkpoint_dir() as ckpt:
        launches["ckpt_crashed"], launches["ckpt_resumed"], dense_saved = \
            dense_resume_path(dense_records, ckpt)
    launches["mesh_train"], launches["mesh_quant_forward"], mesh_losses = \
        mesh_phase(dense_records)
    with checkpoint_dir() as ckpt:
        (launches["mesh_ckpt_crashed"], launches["mesh_ckpt_resumed"],
         launches["mesh_ckpt_one_process"]) = mesh_resume_path(
            mesh_losses, dense_saved, ckpt)
    for name, (_, _, gather, _, _) in TIERED_TRAIN.items():
        launches[name], run = tiered_train_path(name)
        profile_train_step(run, f"train step {name}", (
            "lram_query_kernel", f"{gather}_kernel", "lookup_bwd"))
        del run
    with checkpoint_dir() as ckpt:
        (launches["q8_ckpt_crashed"], launches["q8_ckpt_resumed"],
         launches["q8_ckpt_serve"]) = tiered_resume_path(ckpt)
    launches["pkm_train"], run = pkm_train_path()
    profile_train_step(run, "train step lram-bert-pkm", ours=())
    del run
    parity_phase()
    train_parity("lram-bert-medium", ["--placement", "pallas"])
    train_parity("lram-bert-pkm")
    train_parity("lram-tiered")
    train_parity("lram-tiered-q8")
    train_parity("lram-sharded-tiered")
    check(not {"jax", "repro", "ml_dtypes"} & set(sys.modules),
          "the port pulled in JAX, the JAX package or ml_dtypes")

    kernels = kernels_line(rows, launches)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def kernels_line(rows, launches) -> list[dict]:
    """One entry per kernel: the headline shape's numbers, every shape,
    and its launches summed over the serve and train paths (and by
    path)."""
    kernels = []
    for name, per_shape in rows.items():
        _, source, replaces = KERNELS[name]
        # the decode tick (int8 for B4/B6), the serving path's most frequent
        # call; a train step's shape (the dq instance, int8 for the 1-byte
        # rows) for the backward kernel's instances
        head = next(r for r in per_shape
                    if r["n"] == HEAD_N.get(name, SHAPES[0]))
        by_path = {p: c[name] for p, c in launches.items() if c[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "n": head["n"], "shapes": per_shape,
        })
    check(all(math.isfinite(k["ms"]) and k["launches"] > 0
              for k in kernels), "bad timing or a kernel never launched")
    return kernels


if __name__ == "__main__":
    main()
