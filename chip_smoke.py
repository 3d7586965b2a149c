"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build both CUDA kernels from `src/repro_torch/kernels/csrc` (nvcc,
     one process per source, started together);
  3. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes and time kernel, plain version and (for K1) the
     library call `F.embedding_bag`;
  4. (the `kernels` JSON line is printed at the end, with the launch
     counts of phase 5);
  5. serve `lram-tiered` at its full width on the dense placement through
     `repro_torch.launch.serve.main --warmup` (every prefill bucket and one
     decode tick first, so the timed ticks are warm; then 8 requests, 4
     slots, prompts <= 64, generation <= 32, all queued at t=0), checking
     that both kernels launched and every logit is finite;
  6. a shorter full-width serve of a warmed engine under torch.profiler:
     kernel time by name and the device's busy share;
  7. serve the smoke config on the card and on the CPU (plain versions)
     with the same weights and compare every request's first logits;
  8. last lines: the card again, the `kernels` JSON line, and
     {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
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
from repro_torch import configs  # noqa: E402
from repro_torch.core import indexing  # noqa: E402
from repro_torch.kernels import _build, e8_lookup, gather_interp  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, budget_ms: float = 200.0) -> float:
    """Mean device time of one call, by CUDA events over repeated calls."""
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


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(fn):
    """Run fn under torch.profiler; (result, {device activity: us}).
    Only device-side events count (kernels, copies): the CPU ops that
    launched them would count the same time twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        if us > 0 and evt.device_type == DeviceType.CUDA:
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us
    return out, per_kernel


def device_ms(fn, kernel: str, calls: int = 20):
    """Device time of one call of `kernel` (profiler), or None if the
    profiler saw no device time."""
    fn()
    _, per_kernel = profile(lambda: [fn() for _ in range(calls)])
    us = sum(v for k, v in per_kernel.items() if kernel in k)
    return us / calls / 1e3 if us > 0 else None


def kernel_phase(device):
    spec = indexing.choose_torus(LOG2_LOCATIONS)
    gen = torch.Generator(device=device).manual_seed(0)
    values = torch.randn(spec.num_locations, M, generator=gen,
                         device=device)
    wrap = torch.tensor(spec.K, dtype=torch.float32, device=device)
    rows = {"lram_query": [], "gather_interp": []}
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
        same_idx = (idx == idx_p).float().mean().item()
        k2_ms = time_ms(lambda: e8_lookup.lram_query(q, spec, TOP_K))
        k2_plain = time_ms(lambda: e8_lookup.lram_query_plain(q, spec,
                                                              TOP_K))
        k2_dev = device_ms(lambda: e8_lookup.lram_query(q, spec, TOP_K),
                           "lram_query_kernel")
        # per query: 232 distances of 23 fp32 ops, and the compares a
        # top-k of 232 needs (232 * log2 k), not the kernel's k full passes
        b2, by2 = bound_ms(n * 8 * 4 + n * TOP_K * 8,
                           n * 232 * (23 + math.log2(TOP_K)))
        rows["lram_query"].append({
            "n": n, "max_abs_err": w_err, "same_idx_frac": same_idx,
            "out_max_abs_err": (out - out_p).abs().max().item(),
            "ms": k2_ms, "device_ms": k2_dev, "plain_ms": k2_plain,
            "bound_ms": b2,
            "bound_by": by2, "library_ms": None})

        g = gather_interp.gather_interp(values, idx, w)
        g_p = gather_interp.gather_interp_plain(values, idx, w)
        torch.cuda.synchronize()
        g_err = (g - g_p).abs().max().item()
        check(g_err <= 1e-5, f"K1 differs by {g_err} at n={n}")
        idx64 = idx.long()
        lib = F.embedding_bag(idx64, values, per_sample_weights=w,
                              mode="sum")
        check(torch.allclose(lib, g_p, rtol=1e-5, atol=1e-5),
              "embedding_bag yardstick disagrees with the plain version")
        k1_ms = time_ms(lambda: gather_interp.gather_interp(values, idx, w))
        k1_plain = time_ms(
            lambda: gather_interp.gather_interp_plain(values, idx, w))
        k1_lib = time_ms(lambda: F.embedding_bag(
            idx64, values, per_sample_weights=w, mode="sum"))
        k1_dev = device_ms(lambda: gather_interp.gather_interp(values, idx, w),
                           "gather_interp_kernel")
        # each distinct row this run's indices name is read once, plus the
        # indices, weights and output
        rows_read = torch.unique(idx).numel()
        b1, by1 = bound_ms(rows_read * 4 * M + n * TOP_K * 8 + 4 * n * M,
                           2 * n * TOP_K * M)
        rows["gather_interp"].append({
            "n": n, "max_abs_err": g_err, "distinct_rows": rows_read,
            "ms": k1_ms, "device_ms": k1_dev,
            "plain_ms": k1_plain, "bound_ms": b1, "bound_by": by1,
            "library_ms": k1_lib})
    return rows


def serve_phase():
    finite = []
    decode_step = transformer.decode_step

    def checked_decode(*args, **kw):
        logits = decode_step(*args, **kw)
        finite.append(torch.isfinite(logits).all())  # no host sync here
        return logits

    transformer.decode_step = checked_decode
    e8_lookup.lram_query.launches = 0
    gather_interp.gather_interp.launches = 0
    t0 = time.perf_counter()
    try:
        report = serve.main([
            "--arch", "lram-tiered", "--placement", "pallas",
            "--batch", "4", "--prompt-len", "64", "--gen", "32",
            "--requests", "8", "--seed", "0", "--warmup",
        ])
    finally:
        transformer.decode_step = decode_step
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"lram_query": e8_lookup.lram_query.launches,
                "gather_interp": gather_interp.gather_interp.launches}
    check(len(report.requests) == 8,
          f"served {len(report.requests)} of 8 requests")
    for name, count in launches.items():
        check(count > 0, f"{name} kernel never launched on the serve path")
    check(bool(torch.stack(finite).all()), "non-finite decode logits")
    for r in report.requests:
        check(np.isfinite(r.first_logits).all()
              and r.first_logits.shape == (30000,),
              f"request {r.id}: bad prefill logits")
    print(json.dumps({
        "serve": "lram-tiered full width, dense placement, CUDA kernels, "
                 "warmed engine",
        "requests": len(report.requests),
        "generated_tokens": report.generated_tokens,
        "tokens_per_sec": report.tokens_per_sec,
        "decode_p50_ms": report.p50_ms(), "decode_p99_ms": report.p99_ms(),
        "prefill_median_ms": 1e3 * float(np.median(report.prefill_s)),
        "decode_ticks": len(report.step_s), "wall_s": report.wall_s,
        "serve_s_incl_init": serve_s, "launches": launches,
    }), flush=True)
    return launches


def profile_phase():
    """A second, shorter full-width serve of a warmed engine under
    torch.profiler: kernel time by name and the device's busy share of the
    engine's wall time (profiling slows the host, so the share is a lower
    bound).  Only the trace's replay is profiled: model build and warm-up
    run before it."""
    cfg = configs.get_config("lram-tiered")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    model = transformer.init(cfg, seed=0).to("cuda")
    engine = ServeEngine(model, EngineConfig(slots=4, max_len=64 + 16))
    engine.warmup()
    trace = synthetic_trace(np.random.default_rng(0), 4,
                            vocab_size=cfg.vocab_size, max_prompt=64,
                            max_gen=16)
    report, per_kernel = profile(lambda: engine.run(trace))
    del engine, model
    kernels = {k: v for k, v in per_kernel.items()
               if not k.startswith(("Memcpy", "Memset"))}
    total_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "profile": "lram-tiered full width, 4 requests, gen <= 16",
        "wall_ms": 1e3 * report.wall_s, "kernel_ms": total_ms,
        "busy_share": total_ms / (1e3 * report.wall_s),
        "decode_ticks": len(report.step_s),
        "memory_kernels_ms": sum(v for k, v in kernels.items()
                                 if "lram_query_kernel" in k
                                 or "gather_interp_kernel" in k) / 1e3,
        "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
    }), flush=True)


def parity_phase():
    argv = ["--arch", "lram-tiered", "--smoke", "--placement", "pallas",
            "--batch", "2", "--prompt-len", "16", "--gen", "4",
            "--requests", "3", "--seed", "1"]
    gpu = serve.main(argv + ["--device", "cuda"])
    cpu = serve.main(argv + ["--device", "cpu"])
    err = max(float(np.abs(a.first_logits - b.first_logits).max())
              for a, b in zip(gpu.requests, cpu.requests))
    check(len(gpu.requests) == len(cpu.requests) == 3, "parity trace lost "
          "requests")
    check(err <= 1e-4, f"smoke logits card vs CPU differ by {err}")
    same = all(a.tokens == b.tokens for a, b in zip(gpu.requests,
                                                    cpu.requests))
    print(json.dumps({"parity": "smoke config, card vs CPU plain versions",
                      "first_logits_max_abs_err": err,
                      "greedy_tokens_equal": same}), flush=True)


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
    launches = serve_phase()
    profile_phase()
    parity_phase()
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in JAX or the JAX package")

    sources = {
        "lram_query": ("src/repro_torch/kernels/csrc/e8_lookup.cu",
                       "src/repro/kernels/e8_lookup.py:189"),
        "gather_interp": ("src/repro_torch/kernels/csrc/gather_interp.cu",
                          "src/repro/kernels/gather_interp.py:73"),
    }
    kernels = []
    for name, per_shape in rows.items():
        head = per_shape[0]  # the decode tick: the serving path's most
        #                      frequent call
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "n": head["n"],
            "shapes": per_shape,
        })
    check(all(math.isfinite(k["ms"]) for k in kernels), "bad timing")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
