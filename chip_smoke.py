"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from `src/repro_torch/kernels/csrc` (nvcc,
     one process per source, started together);
  3. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes (n = 128, 2048, 65536 queries, top-k 32, m 64)
     and time kernel, plain version and, where one PyTorch call computes
     the same function, that call (`F.embedding_bag`):
       K2 `lram_query` and K1 `gather_interp` on the full 2^20-row table;
       B4 `gather_interp_quant` on the table quantized to int8 and e4m3;
       B5 `tiered_gather` and B6 `tiered_gather_quant` (int8, e4m3) on a
       full-width device cache (32 slots x 8192 rows) with resident
       indices;
       the backward kernel `lookup_bwd` in both instantiations (B3's
       backward with dq, B1's VJP with dw) on the full table with K2's
       indices, library yardstick for the dw instance: the backward of
       `F.embedding_bag` through `torch.autograd.grad`;
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
  7. serve the smoke configs (tiered and q8) on the card and on the CPU
     (plain versions), and tiered against dense on the card, with the same
     weights, comparing every request's first logits to 1e-5; train the
     lram-bert-medium smoke config 5 steps on the card and on the CPU from
     the same seed's weights and batches, per-step losses and gradient
     norms to rtol 1e-4;
  8. last lines: the card again, the `kernels` JSON line, and
     {"ok": true, "device": {...}}.

It imports nothing of JAX, of the JAX package or of ml_dtypes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# fails here, printing nothing, when the checkout around the script is missing
from repro_torch import configs, data, quant  # noqa: E402
from repro_torch.core import indexing  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, e8_lookup, gather_interp, ops, tiered_gather)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig, ServeEngine, synthetic_trace)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SHAPES = (128, 2048, 65536)  # decode tick (4 slots x 32 heads), 64-token
#                              prefill (64 x 32 heads), a large batch
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
}
# the shape of the kernels line's headline numbers: the serving decode tick
# (n = 128), or the train step's n = 65,536 for the backward kernel
HEAD_N = {"lookup_bwd": 65536}

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
    """Device ms per call of `kernel` and of everything else the call ran
    (profiler); None where the profiler saw no device time."""
    fn()
    _, per_kernel, _ = profile(lambda: [fn() for _ in range(calls)])
    ours = sum(v for k, v in per_kernel.items() if kernel in k)
    rest = sum(v for k, v in per_kernel.items() if kernel not in k)
    return (ours / calls / 1e3 if ours > 0 else None,
            rest / calls / 1e3 if rest > 0 else None)


def device_ms(fn, kernel: str, calls: int = 20):
    """Device time of one call of `kernel` (profiler), or None if the
    profiler saw no device time."""
    return device_split(fn, kernel, calls)[0]


def measure(name, n, fn, plain, tol, *, device_kernel, bound, extra=None,
            library=None):
    """Hold `fn` against `plain` (allclose with tol = (rtol, atol)) and
    time kernel, plain version and library call: one row of the table."""
    out, want = fn(), plain()
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    check(torch.allclose(out, want, rtol=tol[0], atol=tol[1]),
          f"{name} differs from its plain version by {err} at n={n}")
    lib_ms = None
    if library is not None:
        check(torch.allclose(library(), want, rtol=1e-5, atol=1e-5),
              f"{name}: the library yardstick disagrees at n={n}")
        lib_ms = time_ms(library)
    b, by = bound
    return {"n": n, "max_abs_err": err, "ms": time_ms(fn),
            "device_ms": device_ms(fn, device_kernel),
            "plain_ms": time_ms(plain), "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms, **(extra or {})}


def backward_rows(n, spec, values, q, idx, w, gen):
    """The backward kernel at one n, both instantiations, against
    `lookup_bwd_plain`: dvalues to atol 1e-5 (atomics add in a varying
    order), dq / dw to rtol 1e-4 / atol 1e-5."""
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
        # written once; the kernel alone, on the zeroed dvalues: each
        # distinct row read once and its gradient row written once
        b, by = bound_ms(distinct * 4 * M + fill + small, ops_n)
        kb, kby = bound_ms(distinct * 8 * M + small, ops_n)
        dev, rest = device_split(fn, "lookup_bwd_kernel")
        rows.append({
            "n": n, "stage": stage, "max_abs_err": max(err_dv, err_small),
            "dvalues_max_abs_err": err_dv, f"{stage}_max_abs_err": err_small,
            "ms": time_ms(fn), "device_ms": dev,
            "zero_fill_device_ms": rest, "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by,
            "kernel_bound_ms": kb, "kernel_bound_by": kby,
            "zero_fill_bound_ms": fill / HBM_BYTES_PER_S * 1e3,
            "library_ms": lib_ms, "distinct_rows": distinct})
        del dv, small, dv_p, small_p
    return rows


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
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
        idx_p, w_p = e8_lookup.lram_query_plain(q, spec, TOP_K)
        torch.cuda.synchronize()
        w_err = (torch.sort(w, -1).values
                 - torch.sort(w_p, -1).values).abs().max().item()
        out = gather_interp.gather_interp_plain(values, idx, w)
        out_p = gather_interp.gather_interp_plain(values, idx_p, w_p)
        check(w_err <= 1e-5, f"K2 weights differ by {w_err} at n={n}")
        check(torch.allclose(out, out_p, rtol=2e-5, atol=1e-5),
              f"K2 gathered output differs at n={n}: max "
              f"{(out - out_p).abs().max().item()}")
        k2 = lambda: e8_lookup.lram_query(q, spec, TOP_K)  # noqa: E731
        # per query: 232 distances of 23 fp32 ops, and the compares a
        # top-k of 232 needs (232 * log2 k), not the kernel's k full passes
        b2 = bound_ms(n * 8 * 4 + n * TOP_K * 8,
                      n * 232 * (23 + math.log2(TOP_K)))
        rows["lram_query"].append({
            "n": n, "max_abs_err": w_err,
            "same_idx_frac": (idx == idx_p).float().mean().item(),
            "out_max_abs_err": (out - out_p).abs().max().item(),
            "ms": time_ms(k2), "device_ms": device_ms(k2,
                                                      "lram_query_kernel"),
            "plain_ms": time_ms(lambda: e8_lookup.lram_query_plain(
                q, spec, TOP_K)),
            "bound_ms": b2[0], "bound_by": b2[1], "library_ms": None})

        distinct = torch.unique(idx).numel()
        idx64 = idx.long()
        rows["gather_interp"].append(measure(
            "K1", n, lambda: gather_interp.gather_interp(values, idx, w),
            lambda: gather_interp.gather_interp_plain(values, idx, w),
            (1e-5, 1e-5), device_kernel="gather_interp_kernel",
            bound=gather_bound(distinct, 4 * M, n),
            extra={"distinct_rows": distinct},
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
                extra={"payload": kind, "distinct_rows": distinct}))

        # the same access pattern moved into the resident shards
        gid = ((resident[(idx >> log2r) % CACHE_SLOTS] << log2r)
               | (idx & (SHARD_ROWS - 1))).int()
        distinct = torch.unique(gid).numel()
        rows64 = tiered_gather.cache_rows(gid, slot_table, SHARD_ROWS)
        rows["tiered_gather"].append(measure(
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
    return rows


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


def profile_train_step(run) -> None:
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
    ours = {name: sum(v for k, v in kernels.items() if name in k) / 1e3
            for name in ("lram_query_kernel", "gather_interp_kernel",
                         "lookup_bwd_kernel")}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "profile": "train step", "wall_ms": 1e3 * wall[0],
        "kernel_ms": total_ms, "copy_ms": sum(copies.values()) / 1e3,
        "busy_share": total_ms / (1e3 * wall[0]),
        "kernel_launches": sum(c for k, c in calls.items() if k in kernels),
        "memory_kernels_ms": ours,
        "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
    }), flush=True)


def train_parity() -> None:
    """The lram-bert-medium smoke config, 5 steps on the card and on the
    CPU (plain versions) from the same seed's weights and batches:
    per-step losses and gradient norms to rtol 1e-4 (atomics and another
    summation order)."""
    argv = ["--arch", "lram-bert-medium", "--smoke", "--placement", "pallas",
            "--steps", "5", "--batch", "4", "--seq", "32", "--seed", "1"]
    card = train.main(argv + ["--device", "cuda"])
    cpu = train.main(argv + ["--device", "cpu"])
    out = {"parity": "smoke train card vs CPU"}
    for key in ("loss", "grad_norm"):
        pairs = [(a[key], b[key]) for a, b in zip(card.records, cpu.records)]
        err = max(abs(a - b) / abs(b) for a, b in pairs)
        check(len(pairs) == 5 and err <= 1e-4,
              f"smoke train {key} differs card vs CPU: {pairs}")
        out.update({key: pairs, f"{key}_max_rel_err": err})
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
    del run
    parity_phase()
    train_parity()
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
        # call; the train step's shape (dq instance) for the backward kernel
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
