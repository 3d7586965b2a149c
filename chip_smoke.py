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
     the same function, that call (`F.embedding_bag`):
       K2 `lram_query`, its weights and indices bit-equal to the plain
       version's on uniform queries and on `lattice.tie_queries` (exact
       ties of weight, and ties in the canonical sort), and K1
       `gather_interp`, on the full 2^20-row table;
       B4 `gather_interp_quant` on the table quantized to int8 and e4m3;
       B5 `tiered_gather` and B6 `tiered_gather_quant` (int8, e4m3) on a
       full-width device cache (32 slots x 8192 rows) with resident
       indices, B5's call and its yardstick's timed again in turns;
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
       backward; with dw: B4's VJP);
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
       (d)    `lram-tiered-q8 --cache-slots 128`: K2 + B6.
     All five serve the same seed's weights, so (a) and (c) must give the
     dense path's first logits and (d) those of (b), to 1e-5;
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
     torch.profiler (busy share, top kernels);
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
  7. train `lram-tiered` (path (a)) and `lram-tiered-q8` (path (b)) at
     full width on their own tiered spec through `train.main` (`--batch 8
     --seq 64 --steps 20`: n = 16,384 lookups a step, the table in host
     RAM, 32 of 128 shards cached, the write-back's sparse SGD at 1e-3),
     each with the launch counts set to 0 just before and read just
     after; fails unless K2, the gather (K1 or B4) and the path's backward
     instance launched (the backward once a step), one write-back ran a
     step, the loss fell (steps 16-20 below steps 1-5), and the host tier
     changed on rows the write-back touched and nowhere else.  Step-time
     median over steps 6-20, tokens/s, peak device memory, the write-back's
     and the flat route's host ms a step, bytes copied to the host a step,
     hit rate and overflow share; then one more step under torch.profiler;
  8. serve the smoke configs (tiered and q8) on the card and on the CPU
     (plain versions), and tiered against dense on the card, with the same
     weights, comparing every request's first logits to 1e-5; train the
     lram-bert-medium, lram-tiered and lram-tiered-q8 smoke configs 5
     steps on the card and on the CPU from the same seed's weights and
     batches, per-step losses and gradient norms to rtol 1e-4;
  9. last lines: the card again, the `kernels` JSON line, and
     {"ok": true, "device": {...}}.

It imports nothing of JAX, of the JAX package or of ml_dtypes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# fails here, printing nothing, when the checkout around the script is missing
from repro_torch import configs, data, quant  # noqa: E402
from repro_torch.core import indexing, lattice  # noqa: E402
from repro_torch.distributed import collectives, sharding  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, e8_lookup, gather_interp, ops, sharded_gather, tiered_gather)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.memstore import TieredValueStore  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig, ServeEngine, synthetic_trace)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
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


def _kernel_of(symbol: str) -> tuple[str, str]:
    """(kernel name, instance) of a mangled kernel symbol: the name whose
    length prefix ends in `_kernel`, and its template arguments (payload
    type, then each bool as 0 / 1), e.g. ("lookup_bwd_kernel",
    "f32,1,0")."""
    for m in re.finditer(r"\d+", symbol):  # a hash may run into the prefix
        sizes = {int(m.group()[i:]) for i in range(len(m.group()))}
        name = next((symbol[m.end():m.end() + n] for n in sizes
                     if symbol[m.end():m.end() + n].endswith("_kernel")
                     and m.end() + n <= len(symbol)), None)
        if name:
            rest = symbol[m.end() + len(name):]
            if not rest.startswith("I"):
                return name, ""
            args = rest.split("EEv")[0]
            payload = ("f32" if args.startswith("If") else "i8"
                       if args.startswith("Ia") else "e4m3"
                       if args.startswith("I13__nv_fp8_e4m3") else "")
            return name, ",".join([payload]
                                  + re.findall(r"Lb([01])E", args))
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
    launches the profiler recorded (it may drop some); and of everything
    else the call ran (fills, copies) per call; and the kernel names it
    matched.  None where the profiler saw no device time."""
    fn()
    _, per_kernel, counts = profile(lambda: [fn() for _ in range(calls)])
    ours = [k for k in per_kernel if kernel in k]
    rest = [k for k in per_kernel if kernel not in k]
    check(all(counts[k] <= calls for k in ours),
          f"{kernel}: a call launched one of {ours} more than once")
    ours_ms = (sum(per_kernel[k] / counts[k] for k in ours) / 1e3
               if ours else None)
    rest_ms = (sum(per_kernel[k] for k in rest) / calls / 1e3
               if rest else None)
    return ours_ms, rest_ms, {
        "device_events": sum(counts[k] for k in ours), "device_calls": calls,
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
    log2r = SHARD_ROWS.bit_length() - 1

    rows = {name: [] for name in KERNELS}
    for n in SHAPES:
        # torus coordinates in [0, K), as the memory layer hands them over
        q = torch.rand(n, 8, generator=gen, device=device) * wrap
        idx, w = k2_row(rows, n, q, spec, values)

        distinct = torch.unique(idx).numel()
        idx64 = idx.long()
        rows["gather_interp"].append(measure(
            "K1", n, lambda: gather_interp.gather_interp(values, idx, w),
            lambda: gather_interp.gather_interp_plain(values, idx, w),
            (1e-5, 1e-5), device_kernel="gather_interp_kernel",
            bound=gather_bound(distinct, 4 * M, n),
            extra={"route": "dense", "distinct_rows": distinct},
            library=lambda: F.embedding_bag(idx64, values,
                                            per_sample_weights=w,
                                            mode="sum")))
        rows["lookup_bwd"] += backward_rows(n, spec, values, q, idx, w, gen)
        for kind in PAYLOADS:
            tq, ts = tables[kind]
            rows["gather_interp_quant"].append(measure(
                f"B4 ({kind})", n,
                lambda: gather_interp.gather_interp_quant(tq, ts, idx, w),
                lambda: gather_interp.gather_interp_quant_plain(tq, ts, idx,
                                                                w),
                (2e-5, 1e-6), device_kernel="gather_interp_quant_kernel",
                bound=gather_bound(distinct, M + 4, n),
                extra={"payload": kind, "route": "dense",
                       "distinct_rows": distinct}))

        # the same access pattern moved into the resident shards
        gid = ((resident[(idx >> log2r) % CACHE_SLOTS] << log2r)
               | (idx & (SHARD_ROWS - 1))).int()
        distinct = torch.unique(gid).numel()
        rows64 = tiered_gather.cache_rows(gid, slot_table, SHARD_ROWS)
        rows["tiered_gather"].append(b5 := measure(
            "B5", n,
            lambda: tiered_gather.tiered_gather(
                cache, gid, slot_table, w, shard_rows=SHARD_ROWS,
                resident=True),
            lambda: tiered_gather.tiered_gather_plain(
                cache, gid, slot_table, w, shard_rows=SHARD_ROWS),
            (2e-5, 1e-6), device_kernel="tiered_gather_kernel",
            bound=gather_bound(distinct, 4 * M, n),
            extra={"distinct_rows": distinct,
                   "library_note": "embedding_bag on pre-translated "
                                   "rows; translation not timed"},
            # the translation to cache rows is left out of the timing
            library=lambda: F.embedding_bag(rows64, cache,
                                            per_sample_weights=w,
                                            mode="sum")))
        # call ms of B5 and of its yardstick again, in turns
        b5["ms_turns"], b5["library_ms_turns"] = in_turns(
            lambda: tiered_gather.tiered_gather(
                cache, gid, slot_table, w, shard_rows=SHARD_ROWS,
                resident=True),
            lambda: F.embedding_bag(rows64, cache, per_sample_weights=w,
                                    mode="sum"))
        for kind in PAYLOADS:
            cq, cs = caches[kind]
            rows["tiered_gather_quant"].append(measure(
                f"B6 ({kind})", n,
                lambda: tiered_gather.tiered_gather_quant(
                    cq, cs, gid, slot_table, w, shard_rows=SHARD_ROWS,
                    resident=True),
                lambda: tiered_gather.tiered_gather_quant_plain(
                    cq, cs, gid, slot_table, w, shard_rows=SHARD_ROWS),
                (2e-5, 1e-6), device_kernel="tiered_gather_quant_kernel",
                bound=gather_bound(distinct, M + 4, n),
                extra={"payload": kind, "distinct_rows": distinct}))
    for n in ROWS_SHAPES:
        no_scatter_rows(rows, n, spec, values, tables, wrap, gen)
    for n in RANGE_SHAPES:
        range_rows(rows, n, spec, values, tables, wrap, gen)
    return rows


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
    """A tiered store's flat route over the full table: the resident
    shards' rows (the device cache) with the other rows appended, one per
    index, and each index's row in that flat table."""
    log2r = SHARD_ROWS.bit_length() - 1
    shard, row = idx.long() >> log2r, idx.long() & (SHARD_ROWS - 1)
    slot_of = torch.full((values.shape[0] // SHARD_ROWS,), -1,
                         dtype=torch.long, device=values.device)
    slot_of[resident] = torch.arange(CACHE_SLOTS, device=values.device)
    slot = slot_of[shard]
    mask = slot >= 0
    rows = torch.where(mask, slot * SHARD_ROWS + row, 0)
    rows[~mask] = CACHE_SLOTS * SHARD_ROWS + torch.arange(
        int((~mask).sum()), device=values.device)
    cache_rows = (resident[:, None] * SHARD_ROWS + torch.arange(
        SHARD_ROWS, device=values.device)).reshape(-1)
    flat = torch.cat([cache_rows, idx.long()[~mask]])
    return flat, rows.int().contiguous()


def no_scatter_rows(rows, n, spec, values, tables, wrap, gen):
    """The tiered train step's kernels at one n, on the flat route of K2's
    indices (32 of 128 shards cached, the other rows appended): K2 itself
    where the serving shapes do not hold n; the forward gathers over the
    flat table, K1 (fp32) and B4 (int8, e4m3), to the serving rows'
    tolerances; the backward's instances without scatter,
    `lookup_bwd_rows` (fp32) and `lookup_bwd_quant` (int8, e4m3), each with
    dq and with dw, against `lookup_bwd_plain` to rtol 1e-4 / atol 1e-5
    (the scatter instances' tolerance for dq and dw)."""
    q = torch.rand(n, 8, generator=gen, device=values.device) * wrap
    if n in SHAPES:
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
    route = {"route": "flat", "distinct_rows": distinct,
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
            # g, rows and w, and for dq idx and q; the output (dq or dw)
            small = (4 * n * M + 8 * n * TOP_K
                     + (4 * n * TOP_K + 32 * n + 32 * n if stage == "dq"
                        else 4 * n * TOP_K))
            ops_n = 2 * n * TOP_K * M + (n * TOP_K * 40 if stage == "dq"
                                         else 0)
            rows[name].append(measure(
                f"{name} ({payload}, {stage})", n, call, plain, (1e-4, 1e-5),
                device_kernel="lookup_bwd",
                bound=bound_ms(distinct * row_bytes + small, ops_n),
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
    share of the step's wall time and the top kernels."""
    batch = train.batch_to(data.get_batch(run.dcfg, step=TRAIN_STEPS),
                           next(run.model.parameters()).device)
    wall = []

    def step():
        t0 = time.perf_counter()
        out = run.step_fn(run.opt_state, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        return out

    _, per_kernel, calls = profile(step)
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
        "memory_kernels_ms": mine,
        "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
        "copies_ms": [[k[:60], v / 1e3] for k, v in copies.items()],
    }), flush=True)


# path -> (arch, its forward gather, its backward instance)
TIERED_TRAIN = {
    "a_train_tiered": ("lram-tiered", "gather_interp", "lookup_bwd_rows"),
    "b_train_tiered_q8": ("lram-tiered-q8", "gather_interp_quant",
                          "lookup_bwd_quant"),
}
TIERED_ARGS = ["--batch", "8", "--seq", "64", "--steps", str(TRAIN_STEPS),
               "--json"]


def tiered_train_path(name: str):
    """Train a tiered arch at full width through the store's write-back;
    returns (launch counts, run).  The launch counts are reset just
    before and read just after.  Inside the timed steps the wrappers only
    read clocks and keep references: the host tier is copied when the
    trainer binds the store, the write-back is timed (the wait for the
    backward, by the synchronize its own copy to the host would make, and
    its host work), the host index arrays it applies are kept and reduced
    to the touched rows after the run, and the flat route's host time and
    stats are read per call."""
    arch, gather, bwd = TIERED_TRAIN[name]
    argv = ["--arch", arch, *TIERED_ARGS]
    before, applied, wb, fwd = {}, [], [], []
    bind = train.bind_stores
    writeback = TieredValueStore.writeback
    apply_writeback = TieredValueStore.apply_writeback
    lookup_rows = TieredValueStore.lookup_rows

    def bind_and_copy(model, lr):
        stores = bind(model, lr)
        for store in stores:
            before[id(store)] = (store._host.copy(),
                                 None if store._host_scale is None
                                 else store._host_scale.copy())
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
    TieredValueStore.writeback = timed_writeback
    TieredValueStore.apply_writeback = kept_apply_writeback
    TieredValueStore.lookup_rows = timed_lookup_rows
    reset_counts()
    t0 = time.perf_counter()
    try:
        run = train.main(argv)
        torch.cuda.synchronize()
    finally:
        train.bind_stores = bind
        TieredValueStore.writeback = writeback
        TieredValueStore.apply_writeback = apply_writeback
        TieredValueStore.lookup_rows = lookup_rows
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(run.records) == TRAIN_STEPS, f"{name}: steps missing")
    for kernel in ("lram_query", gather):
        check(launches[kernel] >= TRAIN_STEPS,
              f"{name}: {kernel} launched {launches[kernel]} times in "
              f"{TRAIN_STEPS} steps")
    check(launches[bwd] == TRAIN_STEPS,
          f"{name}: the backward instance {bwd} launched {launches[bwd]} "
          f"times in {TRAIN_STEPS} steps (one memory layer: once a step)")
    (store,) = run.stores
    check(store.stats["writebacks"] == TRAIN_STEPS == len(wb)
          == len(applied),
          f"{name}: {store.stats['writebacks']} write-backs in "
          f"{TRAIN_STEPS} steps")
    check(not store._dirty, f"{name}: dirty slots after the flush")
    host0, scale0 = before[id(store)]
    rows_n = store.num_rows
    changed = (store._host.reshape(rows_n, -1)
               != host0.reshape(rows_n, -1)).any(-1)
    if scale0 is not None:
        changed |= store._host_scale.reshape(-1) != scale0.reshape(-1)
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
                        f"{first}, steps 16-20 mean {last})")
    step_ms = [r["step_ms"] for r in run.records]
    median_ms = float(np.median(step_ms[5:]))
    tokens = run.dcfg.global_batch * run.dcfg.seq_len
    steady = lambda recs, key: float(np.median(  # noqa: E731
        [r[key] for r in recs[5:]]))
    print(json.dumps({
        "train": name, "argv": argv,
        "tokens_per_step": tokens, "lookups_per_step": tokens * 32,
        "losses": losses, "grad_norms": norms,
        "loss_mean_steps_1_5": first, "loss_mean_steps_16_20": last,
        "step_ms": step_ms, "step_ms_median_steps_6_20": median_ms,
        "tokens_per_sec": tokens / (median_ms / 1e3),
        "peak_memory_bytes": peak, "wall_s_incl_init_and_eval": wall_s,
        "writeback_host_ms_median_6_20": steady(wb, "host_ms"),
        "writeback_wait_ms_median_6_20": steady(wb, "wait_ms"),
        "to_host_bytes_per_step": wb[0]["to_host_bytes"],
        "flat_route_host_ms_median_6_20": steady(fwd, "host_ms"),
        "fill_bytes_per_step_median_6_20": steady(fwd, "fill_bytes"),
        "overflow_bytes_per_step_median_6_20": steady(fwd,
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


def mesh_rank(rank: int, port: int, results, argv, device_name) -> None:
    """One rank of the mesh phase (a spawned process; all ranks on the one
    card): the two forward checks, the mesh training through `train.main`
    with its launch counts reset just before and read just after, then two
    more steps with every sum across ranks timed."""
    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(MESH_RANKS),
                       "LOCAL_WORLD_SIZE": str(MESH_RANKS),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    (training, and the 1-byte forward check)."""
    import torch.multiprocessing as mp

    if device_name == "cuda":
        torch.cuda.empty_cache()
    steps = train.build_argparser().parse_args(argv).steps
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = mp.start_processes(mesh_rank,
                               args=(port, results, argv, device_name),
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
                  f"mesh phase: the ranks outlasted {MESH_TIMEOUT_S} s "
                  f"(a missing collective?)")
    except mp.ProcessRaisedException as e:
        fail(f"mesh phase: a rank failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"mesh phase: a rank died: {e}")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    wall_s = time.perf_counter() - t0
    while not results.empty():
        got.append(results.get())
    check(len(got) == MESH_RANKS, f"mesh phase: {len(got)} of "
                                  f"{MESH_RANKS} ranks reported")
    ranks = sorted(got, key=lambda r: r["rank"])
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
    return total, quant_total


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
    }}), flush=True)
    del reports
    for name in PATHS:
        profile_path(name)
    launches["train"], run = train_path()
    profile_train_step(run)
    dense_records = run.records
    del run
    launches["mesh_train"], launches["mesh_quant_forward"] = mesh_phase(
        dense_records)
    for name, (_, gather, bwd) in TIERED_TRAIN.items():
        launches[name], run = tiered_train_path(name)
        profile_train_step(run, f"train step {name}", (
            "lram_query_kernel", f"{gather}_kernel", "lookup_bwd"))
        del run
    parity_phase()
    train_parity("lram-bert-medium", ["--placement", "pallas"])
    train_parity("lram-tiered")
    train_parity("lram-tiered-q8")
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
