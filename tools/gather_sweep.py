"""Sweep the tuning of the batched gather (K1 and the range gather) on one
card: row loads in flight (kBatch) and blocks an SM (the register cap:
kMinBlocks of `csrc/gather_batched.cuh`, and the range gather's own
kOneWarpMinBlocks in `csrc/sharded_gather.cu`, set alike in a variant),
against a parent checkout's kernels.

    mkdir -p build/parent && git archive <parent> src | tar -x -C build/parent
    python3 tools/gather_sweep.py --old build/parent [--variants 8x4,4x8]

Each variant is this checkout's `csrc/` copied into `build/gather_sweep/`
with the constants replaced, and `gather_interp.cu` and
`sharded_gather.cu` built from it (one nvcc each, all started together,
the port's flags).  Every variant and the parent's kernels are held to
the plain versions (K1 1e-5; the range gather fp32 1e-5, 1-byte rtol 2e-5
/ atol 1e-6) and timed through their C entry points: the mean device time
of 20 launches under torch.profiler (`chip_smoke.device_ms`), in the order
old, variants, variants reversed, old.  Shapes: K1 at n = 128, 2,048,
16,384 and 65,536 on uniform and clustered queries (64 near each of n / 64
points) on the dense table, and at 16,384 and 65,536 on the tiered flat
route; the range gather at n = 128 and 32,768 on the lower 2^19-row shard,
fp32, int8 and e4m3.  Prints the card, each build's registers and spills,
and one JSON line per shape.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kernel_ab import make_queries, stream  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.core import indexing  # noqa: E402
from repro_torch.kernels import (_build, e8_lookup, gather_interp,  # noqa: E402
                                 sharded_gather)

SWEEP_DIR = ROOT / "build" / "gather_sweep"
SOURCES = ("gather_interp", "sharded_gather")
TOP_K, M, SHARD = 32, 64, 2**19


def build(old_root: Path, variants: dict) -> dict:
    """{(variant or "old", source): CDLL}; prints each build's ptxas."""
    procs = {}
    for name, (batch, blocks) in variants.items():
        d = SWEEP_DIR / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        h = (d / "gather_batched.cuh").read_text()
        h, n1 = re.subn(r"constexpr int kBatch = \d+;",
                        f"constexpr int kBatch = {batch};", h)
        h, n2 = re.subn(r"constexpr int kMinBlocks = \d+;",
                        f"constexpr int kMinBlocks = {blocks};", h)
        r = (d / "sharded_gather.cu").read_text()
        r, n3 = re.subn(r"constexpr int kOneWarpMinBlocks = \d+;",
                        f"constexpr int kOneWarpMinBlocks = {blocks};", r)
        cs.check(n1 == n2 == n3 == 1, "the gathers' tuning not found")
        (d / "gather_batched.cuh").write_text(h)
        (d / "sharded_gather.cu").write_text(r)
        for src in SOURCES:
            procs[(name, src)] = d / src
    for src in SOURCES:
        procs[("old", src)] = (old_root / "src" / "repro_torch" / "kernels"
                               / "csrc" / src)
    running = {}
    for key, stem in procs.items():
        out = SWEEP_DIR / f"lib{key[1]}-{key[0]}.so"
        running[key] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             f"{stem}.cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (out, proc) in running.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {key}:\n{log}")
        print(json.dumps({"build": key, "ptxas": cs.ptxas_report(log)}),
              flush=True)
        libs[key] = ctypes.CDLL(str(out))
    return libs


def timed(names, calls, kernel: str) -> dict:
    """Device ms of each call, in the order names, names reversed."""
    got = {}
    for name in list(names) + list(names)[::-1]:
        got.setdefault(name, []).append(cs.device_ms(calls[name], kernel))
    return {name: float(np.mean(v)) for name, v in got.items()}


def k1_calls(libs, names, table, idx, w, want):
    calls = {}
    for name in names:
        fn = libs[(name, "gather_interp")].gather_interp_f32
        fn.argtypes, fn.restype = gather_interp._ARGS, ctypes.c_int
        out = torch.empty_like(want)

        def call(fn=fn, out=out):
            _build.check(fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                            out.data_ptr(), idx.shape[0], TOP_K, M,
                            table.device.index, stream()), "K1")
            return out
        got = call()
        torch.cuda.synchronize()
        cs.check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                 f"K1 {name} differs from its plain version")
        calls[name] = call
    return calls


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--old", required=True, type=Path)
    p.add_argument("--variants", default="8x4,8x8,4x8,16x4,12x5,16x2,32x2",
                   help="kBatch x kMinBlocks, comma-separated")
    args = p.parse_args()
    cs.check(torch.cuda.is_available(), "needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    variants = {v: tuple(int(x) for x in v.split("x"))
                for v in args.variants.split(",")}
    libs = build(args.old, variants)
    names = ["old", *variants]
    device = torch.device("cuda", 0)
    spec = indexing.choose_torus(20)
    gen = torch.Generator(device=device).manual_seed(0)
    values = torch.randn(spec.num_locations, M, generator=gen, device=device)
    for n in (128, 2048, 16384, 65536):
        for kind in ("uniform", "clustered"):
            q = make_queries(n, kind, spec, gen, device)
            idx, w = e8_lookup.lram_query(q, spec, TOP_K)
            routes = [("dense", values, idx)]
            if n >= 16384 and kind == "uniform":
                resident = torch.randperm(
                    values.shape[0] // cs.SHARD_ROWS, generator=gen,
                    device=device)[:cs.CACHE_SLOTS]
                flat, rws = cs.flat_route(values, idx, resident)
                routes.append(("flat", values[flat].contiguous(), rws))
            for route, table, ix in routes:
                want = gather_interp.gather_interp_plain(table, ix, w)
                calls = k1_calls(libs, names, table, ix, w, want)
                print(json.dumps({"kernel": "gather_interp", "n": n,
                                  "queries": kind, "route": route,
                                  "device_ms": timed(
                                      names, calls,
                                      "gather_interp_kernel")}),
                      flush=True)
    host = values[:SHARD].cpu().numpy()
    shards = {"fp32": (values[:SHARD], None)}
    for kind in cs.PAYLOADS:
        tq, ts = quant.quantize_rows_np(host, kind)
        shards[kind] = (quant.as_torch_payload(tq).to(device),
                        torch.from_numpy(ts).to(device))
    for n in (128, 32768):
        q = make_queries(n, "uniform", spec, gen, device)
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
        for kind, (shard, scale) in shards.items():
            if scale is None:
                symbol, argt, ptrs = ("sharded_gather_f32",
                                      sharded_gather._ARGS,
                                      [shard.data_ptr()])
                want = sharded_gather.sharded_gather_plain(shard, idx, w, 0)
                tol = (1e-5, 1e-5)
            else:
                symbol = ("sharded_gather_quant_i8" if kind == "int8"
                          else "sharded_gather_quant_e4m3")
                argt, ptrs = (sharded_gather._QUANT_ARGS,
                              [shard.data_ptr(), scale.data_ptr()])
                want = sharded_gather.sharded_gather_quant_plain(
                    shard, scale, idx, w, 0)
                tol = (2e-5, 1e-6)
            calls = {}
            for name in names:
                fn = getattr(libs[(name, "sharded_gather")], symbol)
                fn.argtypes, fn.restype = argt, ctypes.c_int
                out = torch.empty_like(want)

                def call(fn=fn, out=out):
                    _build.check(fn(*ptrs, idx.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), n, TOP_K, M, 0, SHARD,
                                    device.index, stream()), "range gather")
                    return out
                got = call()
                torch.cuda.synchronize()
                cs.check(torch.allclose(got, want, rtol=tol[0],
                                        atol=tol[1]),
                         f"range gather {name} ({kind}) differs from its "
                         f"plain version")
                calls[name] = call
            print(json.dumps({"kernel": "sharded_gather", "n": n,
                              "payload": kind, "device_ms": timed(
                                  names, calls, "sharded_gather_kernel")}),
                  flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
