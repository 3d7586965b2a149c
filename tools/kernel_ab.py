"""Old against new on one card: kernels of a parent checkout timed in turns
with this checkout's on the same inputs.

    mkdir -p build/parent && git archive <parent> src | tar -x -C build/parent
    python3 tools/kernel_ab.py --old build/parent [--sass] [--phases ...]

Builds the parent's `csrc/e8_lookup.cu`, `lookup_bwd.cu`,
`gather_interp.cu`, `gather_interp_quant.cu`, `sharded_gather.cu` and
`tiered_gather.cu` (each against the parent's own headers) with the flags of
`repro_torch.kernels._build` into
`build/kernels_ab/`, beside this checkout's (built as the port builds
them), and calls both through their C entry points (the same names and
arguments in both).  Each phase holds old and new against the plain
version first, then times old, new, new, old: each turn the mean device
time of 20 launches under torch.profiler.  Prints each kernel's registers
and spills, old and new, from nvcc's `ptxas` lines.  Phases (`--phases`,
all by default):

  k2     K2 at the serving and training shapes, weights and indices
         bit-equal on uniform queries and on `lattice.tie_queries`;
  bwd    the backward's dense scatter instances (dvalues atol 1e-5, dq /
         dw rtol 1e-4 / atol 1e-5) at n = 128, 2,048 and 65,536, and on
         clustered queries at 65,536 (64 queries near each point, as
         training's queries crowd rows), with the instance without
         scatter on the same inputs (the scatter's share);
  range  the range backward with dq on both halves of the table;
  k1     K1 (1e-5) on the dense table and on the tiered flat route at
         n = 128, 2,048, 16,384 and 65,536, uniform and clustered
         queries; the new kernel with one warp a query bit-equal to the
         old one; at the decode sizes every split of a query over warps;
  row9   the range gather at n = 128 and 32,768 on both 2^19-row shard
         halves, fp32 (1e-5), int8 and e4m3 (rtol 2e-5 / atol 1e-6);
  order  the query order K1 was tried with (tools/csrc/query_order.cu):
         the sort's kernels, and the new K1 on inputs permuted into its
         order against the given order, at 16,384 and 65,536;
  b4     B4 on int8 and e4m3 tables (rtol 2e-5 / atol 1e-6) at n = 128,
         2,048 and 65,536 on the dense table and at 16,384 and 65,536 on
         the tiered flat route, uniform and clustered queries; the new
         kernel with one warp a query on byte pairs bit-equal to the old
         one; the wide loads against byte pairs, each at the entry's split
         for it, in turns; at the decode sizes every split with each;
  bwdq   the backward's instances without scatter (rtol 1e-4 / atol
         1e-5): rows fp32 / int8 / e4m3, dq and dw, on the flat route at
         16,384 and 65,536, uniform and clustered; range int8 / e4m3, dq
         and dw, at 32,768 on both 2^19-row shard halves;
  b5     B5 (rtol 2e-5 / atol 1e-6) at n = 128, 2,048 and 65,536, uniform
         and clustered queries, on two caches: chip_smoke's 32-slot cache
         (32 of the 128 shards in shuffled slots, random rows) and a
         128-slot cache holding the whole table, shard s in slot s, as
         serve path (c) holds it after warm(); the new kernel with one
         warp a query bit-equal to the old one; on the 128-slot cache K1
         on the same rows in turns with B5; at the decode sizes every
         split;
  b6     B6 on int8 and e4m3 caches, the same cells as b5 (the 128-slot
         cache against B4 on the same rows, as serve path (d)); one warp a
         query bit-equal to the old kernel on byte pairs and with the wide
         loads (which add in candidate order); the wide loads against byte
         pairs, each at the entry's split for it; at the decode sizes every
         split with each.

With `--sass` it prints each kernel's static SASS instruction count and
the size and mix of each loop (a backward branch) from `cuobjdump -sass`.
Prints the card (nvidia-smi) and one JSON line per measurement; exits
non-zero on a failed check.  Needs one card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.core import indexing, lattice  # noqa: E402
from repro_torch.kernels import (_build, e8_lookup, gather_interp,  # noqa: E402
                                 ops, sharded_gather, tiered_gather)

SOURCES = ("e8_lookup", "lookup_bwd", "gather_interp",
           "gather_interp_quant", "sharded_gather", "tiered_gather")
# each source's kernels for --sass
SASS_KERNELS = {"e8_lookup": ("lram_query_kernel",),
                "lookup_bwd": ("lookup_bwd_kernel",),
                "gather_interp": ("gather_interp_kernel",),
                "gather_interp_quant": ("gather_interp_quant_kernel",),
                "sharded_gather": ("sharded_gather_kernel",),
                "tiered_gather": ("tiered_gather_kernel",
                                  "tiered_gather_quant_kernel")}
PHASES = ("k2", "bwd", "range", "k1", "row9", "order", "b4", "bwdq", "b5",
          "b6")
AB_DIR = ROOT / "build" / "kernels_ab"
K2_SHAPES = (128, 2048, 16384, 32768, 65536)
BWD_SHAPES = (128, 2048, 65536)
RANGE_N, RANGE_ROWS = 32768, 2**19
K1_SHAPES = (128, 2048, 16384, 65536)
ROW9_SHAPES = (128, 32768)
B4_SHAPES = (128, 2048, 65536)
TIERED_SHAPES = (128, 2048, 65536)
FLAT_SHAPES = (16384, 65536)  # the tiered train step's n, and a larger one
TOP_K, M = 32, 64
QUANT_SYMBOL = {"int8": "i8", "fp8": "e4m3"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_old(old_root: Path) -> dict:
    """{source: (CDLL, nvcc log)} for the parent's sources, one nvcc each,
    all started together."""
    csrc = old_root / "src" / "repro_torch" / "kernels" / "csrc"
    AB_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = AB_DIR / f"lib{name}_old.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
               str(csrc / f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for the old {name}.cu:"
                                       f"\n{log}")
        libs[name] = (ctypes.CDLL(str(out)), log)
    return libs


def sass_report(lib_path: str, kernel: str) -> list[dict]:
    """Static SASS of each instance of `kernel` in a library: instruction
    count, the opcode mix, and each loop (a branch to a lower address):
    its size and the opcodes inside it that cost the most."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return [{"kernel": kernel, "error": f"no {cuobjdump}"}]
    text = subprocess.run([str(cuobjdump), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    out = []
    for part in text.split("Function : ")[1:]:
        symbol = part.split()[0]
        name, instance = cs._kernel_of(symbol)
        if name != kernel:
            continue
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part):
            words = m.group(2).split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                ins.append((int(m.group(1), 16), words[0],
                            words[1] if len(words) > 1 else ""))
        ops_ = collections.Counter(op.split(".")[0] for _, op, _ in ins)
        loops = []
        for addr, op, arg in ins:
            if op.startswith("BRA") and arg.startswith("0x") \
                    and int(arg, 16) < addr:
                body = [o.split(".")[0] for a, o, _ in ins
                        if int(arg, 16) <= a <= addr]
                mix = collections.Counter(body)
                loops.append({"from": arg, "to": hex(addr),
                              "instructions": len(body),
                              "mix": dict(mix.most_common(8))})
        out.append({"kernel": name, "instance": instance,
                    "instructions": len(ins),
                    "mix": dict(ops_.most_common(12)), "loops": loops})
    return out


def turns(fn_old, fn_new, kernel, names=("old", "new")) -> dict:
    """Device ms of one call, old, new, new, old: of the kernels whose
    names hold `kernel` (or, for two different kernels, the pair's first
    in old's call and second in new's), and of all the call's device work
    (fills too).  `names` labels the two (a variant against another:
    "pair", "wide")."""
    a, b = names
    kernels = {a: kernel, b: kernel} if isinstance(kernel, str) \
        else dict(zip(names, kernel))
    got = {a: [], b: []}
    for which in (a, b, b, a):
        ours, rest, _ = cs.device_split(fn_old if which == a else fn_new,
                                        kernels[which])
        got[which].append((ours, ours + (rest or 0.0)))
    out = {}
    for which, pairs in got.items():
        out[f"{which}_ms"] = float(np.mean([p[0] for p in pairs]))
        out[f"{which}_call_device_ms"] = float(np.mean([p[1] for p in pairs]))
        out[f"{which}_turns"] = [p[0] for p in pairs]
    _, per_kernel, counts = cs.profile(lambda: [fn_new() for _ in range(20)])
    out[f"{b}_by_kernel_ms"] = {
        k[:48]: per_kernel[k] / counts[k] / 1e3 for k in per_kernel}
    out[f"{a}_over_{b}"] = out[f"{a}_ms"] / out[f"{b}_ms"]
    out[f"call_{a}_over_{b}"] = (out[f"{a}_call_device_ms"]
                                 / out[f"{b}_call_device_ms"])
    return out


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def make_queries(n, kind, spec, gen, device):
    """Torus queries: uniform, or clustered (64 near each of n / 64
    points, as training's queries crowd rows)."""
    K = torch.tensor(spec.K, dtype=torch.float32, device=device)
    q = torch.rand(n, 8, generator=gen, device=device) * K
    if kind == "clustered" and n >= 64:
        q = (q[:n // 64].repeat(64, 1) + 1e-3 * torch.rand(
            n, 8, generator=gen, device=device)).contiguous()
    return q


def k2_call(fn, cand, nsq, q, top_k, wrap):
    """A raw K2 launch into fresh outputs; returns (call, idx, w)."""
    n = q.shape[0]
    idx = torch.empty((n, top_k), dtype=torch.int32, device=q.device)
    w = torch.empty((n, top_k), dtype=torch.float32, device=q.device)

    def call():
        _build.check(fn(q.data_ptr(), cand.data_ptr(), nsq.data_ptr(),
                        idx.data_ptr(), w.data_ptr(), n, top_k, wrap,
                        q.device.index, stream()), "lram_query")
    return call, idx, w


def k2_phase(new_fn, old_fn, spec, device) -> None:
    """K2 old and new on the candidate layout of `e8_lookup` (the
    parent's kernel takes the same one), each held to its plain version
    bit for bit."""
    cand, nsq = e8_lookup._padded_candidates(device)
    wrap = (ctypes.c_int * 8)(*spec.K)
    gen = torch.Generator(device=device).manual_seed(0)
    K = torch.tensor(spec.K, dtype=torch.float32, device=device)
    for n in K2_SHAPES:
        sets = {"uniform": torch.rand(n, 8, generator=gen, device=device) * K,
                "ties": torch.from_numpy(lattice.tie_queries(
                    n, spec.K, seed=n)).to(device)}
        for name, q in sets.items():
            for top_k in ((1, 8, TOP_K, 33, 232) if n == 2048 else (TOP_K,)):
                idx_p, w_p = e8_lookup.lram_query_plain(q, spec, top_k)
                row = {"kernel": "lram_query", "n": n, "queries": name,
                       "top_k": top_k}
                calls = {}
                for which, fn in (("old", old_fn), ("new", new_fn)):
                    call, idx, w = k2_call(fn, cand, nsq, q, top_k, wrap)
                    call()
                    torch.cuda.synchronize()
                    row[f"{which}_same_idx_frac"] = \
                        (idx == idx_p).float().mean().item()
                    row[f"{which}_w_bit_equal"] = bool(torch.equal(w, w_p))
                    calls[which] = call
                    cs.check(row[f"{which}_same_idx_frac"] == 1.0
                             and row[f"{which}_w_bit_equal"],
                             f"{which} K2 differs from its plain version: "
                             f"{row}")
                if top_k == TOP_K:
                    row.update(turns(calls["old"], calls["new"],
                                     "lram_query_kernel"))
                    row["bound_ms"] = cs.bound_ms(
                        n * 8 * 4 + n * top_k * 8,
                        n * 232 * (23 + np.log2(top_k)))[0]
                emit(row)


def old_function(lib_old, symbol: str, argtypes):
    """The parent's C entry `symbol` (the same arguments as this
    checkout's)."""
    fn = getattr(lib_old, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def bwd_phase(lib_old, spec, values, device) -> None:
    """The dense scatter instances (B3's backward with dq, B1's VJP with
    dw): the parent's kernel against this checkout's wrapper, and this
    checkout's instance without scatter on the same inputs."""
    wrap = (ctypes.c_int * 8)(*spec.K)
    gen = torch.Generator(device=device).manual_seed(1)
    dvalues = torch.zeros_like(values)
    old_dq = old_function(lib_old, "lookup_bwd_dq_f32", ops._DQ_ARGS)
    old_dw = old_function(lib_old, "lookup_bwd_dw_f32", ops._DW_ARGS)
    rows = values.shape[0]
    cases = [(n, "uniform") for n in BWD_SHAPES] + [(BWD_SHAPES[-1],
                                                      "clustered")]
    for n, queries in cases:
        q = make_queries(n, queries, spec, gen, device)
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
        g = torch.randn(n, M, generator=gen, device=device)
        out = torch.empty((n, 8), device=device)
        out_w = torch.empty((n, TOP_K), device=device)
        scratch = ops._scatter_scratch(n, TOP_K, rows, device)

        def old_dq_call():
            _build.check(old_dq(values.data_ptr(), idx.data_ptr(),
                                w.data_ptr(), g.data_ptr(), q.data_ptr(),
                                dvalues.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), n, TOP_K, M, rows, wrap,
                                device.index, stream()), "old dq")

        def old_dw_call():
            _build.check(old_dw(values.data_ptr(), idx.data_ptr(),
                                w.data_ptr(), g.data_ptr(),
                                dvalues.data_ptr(), out_w.data_ptr(),
                                scratch.data_ptr(), n, TOP_K, M, rows,
                                device.index, stream()), "old dw")
        stages = {"dq": (old_dq_call, out, {"q": q, "spec": spec}),
                  "dw": (old_dw_call, out_w, {})}
        for stage, (old_call, old_out, extra) in stages.items():
            dv_p, want = ops.lookup_bwd_plain(values, idx, w, g, **extra)
            old_call()
            dv_new, small_new = ops.lookup_bwd(values, idx, w, g, **extra)
            torch.cuda.synchronize()
            errs = {}
            for which, dv, small in (("old", dvalues, old_out),
                                     ("new", dv_new, small_new)):
                errs[which] = ((dv - dv_p).abs().max().item(),
                               (small - want).abs().max().item())
                cs.check(torch.allclose(dv, dv_p, rtol=0, atol=1e-5)
                         and torch.allclose(small, want, rtol=1e-4,
                                            atol=1e-5),
                         f"{which} lookup_bwd ({stage}) differs at n={n}: "
                         f"dvalues, {stage} {errs[which]}")
            del dv_p, dv_new
            row = {"kernel": "lookup_bwd", "stage": stage, "n": n,
                   "queries": queries,
                   "distinct_rows": torch.unique(idx).numel(),
                   "max_pairs_a_row": int(torch.unique(
                       idx, return_counts=True)[1].max()),
                   "new_dvalues_err": errs["new"][0],
                   f"new_{stage}_err": errs["new"][1]}
            row.update(turns(old_call, lambda: ops.lookup_bwd(
                values, idx, w, g, **extra), "lookup_bwd"))
            if stage == "dq":
                row["no_scatter_ms"] = cs.device_ms(
                    lambda: ops.lookup_bwd_rows(values, idx, w, g, idx=idx,
                                                q=q, spec=spec),
                    "lookup_bwd")
                for which in ("old", "new"):
                    row[f"{which}_scatter_share_ms"] = \
                        row[f"{which}_ms"] - row["no_scatter_ms"]
            emit(row)


def range_phase(lib_old, spec, values, device) -> None:
    """The range instance with dq on both halves of the table (2^19-row
    shards), at one data rank's n on the mesh step."""
    wrap = (ctypes.c_int * 8)(*spec.K)
    gen = torch.Generator(device=device).manual_seed(2)
    K = torch.tensor(spec.K, dtype=torch.float32, device=device)
    old_fn = old_function(lib_old, "lookup_bwd_range_dq_f32",
                          ops._RANGE_DQ_ARGS[True])
    n = RANGE_N
    q = torch.rand(n, 8, generator=gen, device=device) * K
    idx, w = e8_lookup.lram_query(q, spec, TOP_K)
    g = torch.randn(n, M, generator=gen, device=device)
    for base in (0, RANGE_ROWS):
        shard = values[base:base + RANGE_ROWS]
        dv_p, dq_p = ops.lookup_bwd_plain(shard, idx, w, g, q, spec,
                                          base=base)
        dvalues = torch.zeros_like(shard)
        out = torch.empty((n, 8), device=device)
        scratch = ops._scatter_scratch(n, TOP_K, RANGE_ROWS, device)

        def old_call():
            _build.check(old_fn(shard.data_ptr(), idx.data_ptr(),
                                w.data_ptr(), g.data_ptr(), q.data_ptr(),
                                dvalues.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), n, TOP_K, M, base,
                                RANGE_ROWS, wrap, device.index, stream()),
                         "old range dq")

        def new_call():
            return ops.lookup_bwd_range(shard, idx, w, g, base, q=q,
                                        spec=spec)
        old_call()
        dv_new, dq_new = new_call()
        torch.cuda.synchronize()
        for which, dv, dq in (("old", dvalues, out),
                              ("new", dv_new, dq_new)):
            cs.check(torch.allclose(dv, dv_p, rtol=0, atol=1e-5)
                     and torch.allclose(dq, dq_p, rtol=1e-4, atol=1e-5),
                     f"{which} lookup_bwd_range differs at base {base}")
        row = {"kernel": "lookup_bwd_range", "stage": "dq", "n": n,
               "base": base}
        row.update(turns(old_call, new_call, "lookup_bwd"))
        emit(row)


def old_split_function(lib_old, symbol: str, argtypes):
    """The parent's entry with an explicit split, or None where it has
    none (its kernel then runs one warp a query at every n)."""
    if not hasattr(lib_old, symbol):
        return None
    return old_function(lib_old, symbol, argtypes)


K1_SPLIT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
B4_SPLIT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def k1_phase(lib_old, spec, values, device) -> None:
    """K1 on the dense table and on the tiered flat route (32 of 128
    shards cached, the other rows appended), uniform and clustered
    queries: old and new held to the plain version (1e-5), the new kernel
    with one warp a query bit-equal to the old one with one warp a query
    (the parent's split entry, or its kernel where it has none), timed in
    turns; at the decode sizes every split (warps a query) too."""
    old_fn = old_function(lib_old, "gather_interp_f32", gather_interp._ARGS)
    old_split = old_split_function(lib_old, "gather_interp_f32_split",
                                   K1_SPLIT_ARGS)
    gen = torch.Generator(device=device).manual_seed(3)
    for n in K1_SHAPES:
        for kind in ("uniform", "clustered"):
            q = make_queries(n, kind, spec, gen, device)
            idx, w = e8_lookup.lram_query(q, spec, TOP_K)
            resident = torch.randperm(values.shape[0] // cs.SHARD_ROWS,
                                      generator=gen, device=device)[
                                          :cs.CACHE_SLOTS]
            flat, rws = cs.flat_route(values, idx, resident)
            for route, table, ix in (("dense", values, idx),
                                     ("flat", values[flat].contiguous(),
                                      rws)):
                want = gather_interp.gather_interp_plain(table, ix, w)
                out_old = torch.empty_like(want)

                def old_call():
                    _build.check(old_fn(table.data_ptr(), ix.data_ptr(),
                                        w.data_ptr(), out_old.data_ptr(), n,
                                        TOP_K, M, device.index, stream()),
                                 "old K1")

                def new_call():
                    return gather_interp.gather_interp(table, ix, w)
                old_call()
                new = new_call()
                torch.cuda.synchronize()
                row = {"kernel": "gather_interp", "n": n, "queries": kind,
                       "route": route,
                       "distinct_rows": torch.unique(ix).numel()}
                for which, out in (("old", out_old), ("new", new)):
                    row[f"{which}_err"] = (out - want).abs().max().item()
                    cs.check(torch.allclose(out, want, rtol=1e-5,
                                            atol=1e-5),
                             f"{which} K1 differs from its plain version: "
                             f"{row}")
                ref = out_old
                if old_split is not None:
                    ref = torch.empty_like(want)
                    _build.check(old_split(
                        table.data_ptr(), ix.data_ptr(), w.data_ptr(),
                        ref.data_ptr(), n, TOP_K, M, 1, device.index,
                        stream()), "old K1 split")
                row["split1_bit_equal_old"] = bool(torch.equal(
                    k1_split(table, ix, w, 1), ref))
                cs.check(row["split1_bit_equal_old"],
                         f"K1 with one warp a query is not bit-equal to "
                         f"the old kernel: {row}")
                row.update(turns(old_call, new_call, "gather_interp_kernel"))
                if n <= 2048:
                    row["split_ms"] = {}
                    for split in (1, 2, 4, 8):
                        got = k1_split(table, ix, w, split)
                        cs.check(torch.allclose(got, want, rtol=1e-5,
                                                atol=1e-5),
                                 f"K1 split {split} differs at n={n}")
                        row["split_ms"][split] = cs.device_ms(
                            lambda: k1_split(table, ix, w, split),
                            "gather_interp_kernel")
                row["bound_ms"] = cs.gather_bound(row["distinct_rows"],
                                                  4 * M, n)[0]
                emit(row)


def k1_split(table, ix, w, split: int) -> torch.Tensor:
    """The new K1 through its C entry with an explicit split."""
    fn = _build.function("gather_interp", "gather_interp_f32_split",
                         K1_SPLIT_ARGS)
    out = torch.empty(ix.shape[0], table.shape[1], device=table.device)
    _build.check(fn(table.data_ptr(), ix.data_ptr(), w.data_ptr(),
                    out.data_ptr(), ix.shape[0], ix.shape[1], table.shape[1],
                    split, table.device.index, stream()), "K1 split")
    return out


def order_phase(spec, values, device) -> None:
    """The query order K1 was tried with (tools/csrc/query_order.cu): the
    sort's kernels, and the new K1 on the indices and weights permuted
    into its order (the permutation by torch, outside the timing; a kernel
    that read order[i] itself would add one index load a query), against
    the new K1 in the given order, on the dense table at n = 16,384 and
    65,536, uniform and clustered queries.  The ordered output, permuted
    back, is bit-equal to the unordered one; the order is a permutation
    grouped by bucket."""
    src = ROOT / "tools" / "csrc" / "query_order.cu"
    lib_path = AB_DIR / "libquery_order.so"
    AB_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True)
    cs.check(proc.returncode == 0, f"nvcc failed for {src}:\n{proc.stdout}"
                                   f"{proc.stderr}")
    for r in cs.ptxas_report(proc.stdout + proc.stderr):
        emit({"ptxas": "order", **r})
    lib = ctypes.CDLL(str(lib_path))
    lib.query_order_scratch.argtypes = [ctypes.c_int]
    lib.query_order_scratch.restype = ctypes.c_longlong
    lib.query_order.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.query_order.restype = ctypes.c_int
    gen = torch.Generator(device=device).manual_seed(5)
    rows = values.shape[0]
    for n in (16384, 65536):
        for kind in ("uniform", "clustered"):
            q = make_queries(n, kind, spec, gen, device)
            idx, w = e8_lookup.lram_query(q, spec, TOP_K)
            scratch = torch.empty(lib.query_order_scratch(n),
                                  dtype=torch.int32, device=device)

            def sort():
                _build.check(lib.query_order(idx.data_ptr(),
                                             scratch.data_ptr(), n, TOP_K,
                                             rows, device.index, stream()),
                             "query order")
            sort()
            order = scratch[-n:].long()
            key = idx[:, 0].long() * 16384 // rows
            cs.check(torch.equal(torch.sort(order).values,
                                 torch.arange(n, device=device))
                     and bool((key[order][1:] >= key[order][:-1]).all()),
                     "the query order is not a permutation by bucket")
            ix_o, w_o = idx[order].contiguous(), w[order].contiguous()
            out = gather_interp.gather_interp(values, idx, w)
            back = torch.empty_like(out)
            back[order] = gather_interp.gather_interp(values, ix_o, w_o)
            cs.check(torch.equal(back, out),
                     f"K1 in the query order is not bit-equal at n={n}")
            sort_ms, _, _ = cs.device_split(sort, "query_order")
            row = {"kernel": "gather_interp", "phase": "order", "n": n,
                   "queries": kind, "sort_ms": sort_ms}
            for which in ("unordered", "ordered", "ordered", "unordered"):
                a, b = (idx, w) if which == "unordered" else (ix_o, w_o)
                row.setdefault(f"{which}_ms", []).append(cs.device_ms(
                    lambda: gather_interp.gather_interp(values, a, b),
                    "gather_interp_kernel"))
            for which in ("unordered", "ordered"):
                row[f"{which}_ms"] = float(np.mean(row[f"{which}_ms"]))
            row["ordered_with_sort_ms"] = row["ordered_ms"] + sort_ms
            emit(row)


def row9_phase(lib_old, spec, values, tables, device) -> None:
    """The range gather on both halves of the table (2^19-row shards at
    base 0 and 2^19), fp32, int8 and e4m3 shards: old and new held to
    the plain version (fp32 1e-5; 1-byte rtol 2e-5 / atol 1e-6), timed in
    turns."""
    gen = torch.Generator(device=device).manual_seed(4)
    old = {"fp32": lib_old.sharded_gather_f32,
           "int8": lib_old.sharded_gather_quant_i8,
           "fp8": lib_old.sharded_gather_quant_e4m3}
    old["fp32"].argtypes = sharded_gather._ARGS
    old["int8"].argtypes = old["fp8"].argtypes = sharded_gather._QUANT_ARGS
    for fn in old.values():
        fn.restype = ctypes.c_int
    for n in ROW9_SHAPES:
        q = make_queries(n, "uniform", spec, gen, device)
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
        for base in (0, RANGE_ROWS):
            sl = slice(base, base + RANGE_ROWS)
            ok = sharded_gather.local_rows(idx, base, RANGE_ROWS)[1]
            for kind in ("fp32", "int8", "fp8"):
                if kind == "fp32":
                    shard, scale = values[sl], None
                    want = sharded_gather.sharded_gather_plain(shard, idx,
                                                               w, base)
                    tol = (1e-5, 1e-5)
                else:
                    shard, scale = tables[kind][0][sl], tables[kind][1][sl]
                    want = sharded_gather.sharded_gather_quant_plain(
                        shard, scale, idx, w, base)
                    tol = (2e-5, 1e-6)
                out_old = torch.empty_like(want)
                ptrs = [shard.data_ptr()] + ([] if scale is None
                                             else [scale.data_ptr()])

                def old_call():
                    _build.check(old[kind](*ptrs, idx.data_ptr(),
                                           w.data_ptr(), out_old.data_ptr(),
                                           n, TOP_K, M, base, RANGE_ROWS,
                                           device.index, stream()),
                                 "old range gather")

                def new_call():
                    if scale is None:
                        return sharded_gather.sharded_gather(shard, idx, w,
                                                             base)
                    return sharded_gather.sharded_gather_quant(
                        shard, scale, idx, w, base)
                old_call()
                new = new_call()
                torch.cuda.synchronize()
                row = {"kernel": "sharded_gather", "payload": kind, "n": n,
                       "base": base,
                       "in_range_share": float(ok.float().mean()),
                       "distinct_rows": torch.unique(idx[ok]).numel(),
                       "bit_equal_old": bool(torch.equal(new, out_old))}
                for which, out in (("old", out_old), ("new", new)):
                    row[f"{which}_err"] = (out - want).abs().max().item()
                    cs.check(torch.allclose(out, want, rtol=tol[0],
                                            atol=tol[1]),
                             f"{which} range gather differs from its plain "
                             f"version: {row}")
                row.update(turns(old_call, new_call,
                                 "sharded_gather_kernel"))
                row["bound_ms"] = cs.gather_bound(
                    row["distinct_rows"], 4 * M if scale is None else M + 4,
                    n)[0]
                emit(row)


def entry_split(n: int, per_warp: int = 4) -> int:
    """The split (warps a query) gather_batched::split_for gives n, each
    warp keeping at least `per_warp` candidates (B4's wide loads 32)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = 1
    while split < 8 and n * split < 4 * sms \
            and 2 * per_warp * split <= TOP_K:
        split *= 2
    return split


def flat_cell(values, tables, idx, gen):
    """The tiered flat route of idx (32 of 128 shards cached, the other
    rows appended): (rows, {payload: (table, scale)}) over the fp32 table
    and each 1-byte one."""
    resident = torch.randperm(values.shape[0] // cs.SHARD_ROWS,
                              generator=gen, device=values.device)[
                                  :cs.CACHE_SLOTS]
    flat, rws = cs.flat_route(values, idx, resident)
    out = {"fp32": (values[flat].contiguous(), None)}
    for kind, (tq, ts) in tables.items():
        # rows taken through the payload's bytes (indexing takes no fp8)
        out[kind] = (tq.view(torch.uint8)[flat].view(tq.dtype),
                     ts[flat].contiguous())
    return rws, out


def b4_phase(lib_old, spec, values, tables, device) -> None:
    """B4 on the dense int8 / e4m3 tables at n = 128, 2,048 and 65,536 and
    on the flat route at 16,384 and 65,536, uniform and clustered queries:
    old and new held to the plain version (rtol 2e-5 / atol 1e-6), the new
    kernel with one warp a query on byte pairs bit-equal to the old one,
    old and new timed in turns, then byte pairs against the wide loads,
    each at the split the entry gives it; at the decode sizes every split
    with each."""
    gen = torch.Generator(device=device).manual_seed(6)
    old = {kind: old_function(lib_old, f"gather_interp_quant_{sym}",
                              gather_interp._QUANT_ARGS)
           for kind, sym in QUANT_SYMBOL.items()}
    old_split = {kind: old_split_function(
        lib_old, f"gather_interp_quant_{sym}_split", B4_SPLIT_ARGS)
        for kind, sym in QUANT_SYMBOL.items()}
    cells = [("dense", n) for n in B4_SHAPES] \
        + [("flat", n) for n in FLAT_SHAPES]
    for route, n in cells:
        for queries in ("uniform", "clustered"):
            q = make_queries(n, queries, spec, gen, device)
            idx, w = e8_lookup.lram_query(q, spec, TOP_K)
            ix, by_kind = idx, tables
            if route == "flat":
                ix, by_kind = flat_cell(values, tables, idx, gen)
            distinct = torch.unique(ix).numel()
            split, split_wide = entry_split(n), entry_split(n, 32)
            for kind in cs.PAYLOADS:
                tq, ts = by_kind[kind]
                want = gather_interp.gather_interp_quant_plain(tq, ts, ix, w)
                out_old = torch.empty_like(want)

                def old_call():
                    _build.check(old[kind](tq.data_ptr(), ts.data_ptr(),
                                           ix.data_ptr(), w.data_ptr(),
                                           out_old.data_ptr(), n, TOP_K, M,
                                           device.index, stream()),
                                 "old B4")

                def new_call():
                    return gather_interp.gather_interp_quant(tq, ts, ix, w)
                old_call()
                new = new_call()
                torch.cuda.synchronize()
                row = {"kernel": "gather_interp_quant", "payload": kind,
                       "n": n, "queries": queries, "route": route,
                       "distinct_rows": distinct, "split_pair": split,
                       "split_wide": split_wide}
                for which, out in (("old", out_old), ("new", new)):
                    row[f"{which}_err"] = (out - want).abs().max().item()
                    cs.check(torch.allclose(out, want, rtol=2e-5,
                                            atol=1e-6),
                             f"{which} B4 differs from its plain version: "
                             f"{row}")
                ref = out_old
                if old_split[kind] is not None:  # one warp, byte pairs
                    ref = torch.empty_like(want)
                    _build.check(old_split[kind](
                        tq.data_ptr(), ts.data_ptr(), ix.data_ptr(),
                        w.data_ptr(), ref.data_ptr(), n, TOP_K, M, 1, 0,
                        device.index, stream()), "old B4 split")
                row["split1_pairs_bit_equal_old"] = bool(torch.equal(
                    cs.b4_split(tq, ts, ix, w, 1, 0), ref))
                cs.check(row["split1_pairs_bit_equal_old"],
                         f"B4 with one warp a query on byte pairs is not "
                         f"bit-equal to the old kernel: {row}")
                row.update(turns(old_call, new_call,
                                 "gather_interp_quant_kernel"))
                row.update(turns(
                    lambda: cs.b4_split(tq, ts, ix, w, split, 0),
                    lambda: cs.b4_split(tq, ts, ix, w, split_wide, 1),
                    "gather_interp_quant_kernel", ("pair", "wide")))
                if n <= 2048:
                    row["split_ms"] = {}
                    for sp in (1, 2, 4, 8):
                        for wide in (0, 1):
                            cs.check(torch.allclose(
                                cs.b4_split(tq, ts, ix, w, sp, wide), want,
                                rtol=2e-5, atol=1e-6),
                                f"B4 split {sp} wide {wide} differs at "
                                f"n={n}")
                            row["split_ms"][f"{sp}{'w' if wide else 'p'}"] = \
                                cs.device_ms(lambda: cs.b4_split(
                                    tq, ts, ix, w, sp, wide),
                                    "gather_interp_quant_kernel")
                row["bound_ms"] = cs.gather_bound(distinct, M + 4, n)[0]
                emit(row)


def tiered_caches(values, tables, device) -> dict:
    """{slots: (fp32 cache, {payload: (q, scale)}, slot table, resident
    shards)}: chip_smoke's 32-slot cache (random rows; 32 of the 128
    shards, in shuffled slots) and the 128-slot cache that holds the whole
    table (`values`, `tables`), shard s in slot s."""
    gen = torch.Generator(device=device).manual_seed(8)
    shards = values.shape[0] // cs.SHARD_ROWS
    cache = torch.randn(cs.CACHE_SLOTS * cs.SHARD_ROWS, M, generator=gen,
                        device=device)
    quantized = {}
    for kind in cs.PAYLOADS:
        tq, ts = quant.quantize_rows_np(cache.cpu().numpy(), kind)
        quantized[kind] = (quant.as_torch_payload(tq).to(device),
                           torch.from_numpy(ts).to(device))
    host_gen = torch.Generator().manual_seed(8)
    resident = torch.randperm(shards, generator=host_gen)[:cs.CACHE_SLOTS]
    slot_table = torch.full((shards,), -1, dtype=torch.int32)
    slot_table[resident] = torch.randperm(cs.CACHE_SLOTS,
                                          generator=host_gen).int()
    identity = torch.arange(shards, dtype=torch.int32, device=device)
    return {cs.CACHE_SLOTS: (cache, quantized, slot_table.to(device),
                             resident.to(device)),
            shards: (values, tables, identity, identity)}


def tiered_cells(spec, caches, gen, device):
    """(n, queries, slots, cache, 1-byte caches, slot table, gid, idx, w)
    of every b5 / b6 cell: K2's indices of uniform or clustered queries,
    moved into the cache's resident shards (`gid`; the 128-slot cache's
    are K2's own)."""
    log2r = tiered_gather._log2(cs.SHARD_ROWS)
    for n in TIERED_SHAPES:
        for queries in ("uniform", "clustered"):
            q = make_queries(n, queries, spec, gen, device)
            idx, w = e8_lookup.lram_query(q, spec, TOP_K)
            for slots, (cache, quantized, slot_table, resident) \
                    in caches.items():
                gid = ((resident[(idx >> log2r) % slots] << log2r)
                       | (idx & (cs.SHARD_ROWS - 1))).int()
                yield (n, queries, slots, cache, quantized, slot_table, gid,
                       idx, w)


def b5_phase(lib_old, spec, values, caches, device) -> None:
    """B5 on both caches: old and new held to the plain version (rtol
    2e-5 / atol 1e-6), the new kernel with one warp a query bit-equal to
    the old one (which runs one warp a query at every n), timed in turns;
    on the 128-slot cache K1 on the same rows in turns with the new B5; at
    the decode sizes every split."""
    gen = torch.Generator(device=device).manual_seed(9)
    old = old_function(lib_old, "tiered_gather_f32", tiered_gather._ARGS)
    log2r = tiered_gather._log2(cs.SHARD_ROWS)
    full = max(caches)
    for n, queries, slots, cache, _, slot_table, gid, idx, w in \
            tiered_cells(spec, caches, gen, device):
        want = tiered_gather.tiered_gather_plain(cache, gid, slot_table, w,
                                                 shard_rows=cs.SHARD_ROWS)
        out_old = torch.empty_like(want)

        def old_call():
            _build.check(old(cache.data_ptr(), gid.data_ptr(),
                             slot_table.data_ptr(), w.data_ptr(),
                             out_old.data_ptr(), n, TOP_K, M, log2r,
                             device.index, stream()), "old B5")

        def new_call():
            return tiered_gather.tiered_gather(cache, gid, slot_table, w,
                                               shard_rows=cs.SHARD_ROWS,
                                               resident=True)
        old_call()
        new = new_call()
        torch.cuda.synchronize()
        distinct = torch.unique(gid).numel()
        row = {"kernel": "tiered_gather", "n": n, "queries": queries,
               "cache_slots": slots, "distinct_rows": distinct,
               "split": entry_split(n)}
        for which, out in (("old", out_old), ("new", new)):
            row[f"{which}_err"] = (out - want).abs().max().item()
            cs.check(torch.allclose(out, want, rtol=2e-5, atol=1e-6),
                     f"{which} B5 differs from its plain version: {row}")
        row["split1_bit_equal_old"] = bool(torch.equal(
            cs.b5_split(cache, gid, slot_table, w, 1), out_old))
        cs.check(row["split1_bit_equal_old"],
                 f"B5 with one warp a query is not bit-equal to the old "
                 f"kernel: {row}")
        row.update(turns(old_call, new_call, "tiered_gather_kernel"))
        if slots == full:  # K1's rows
            row.update(turns(
                lambda: gather_interp.gather_interp(values, idx, w),
                new_call, ("gather_interp_kernel", "tiered_gather_kernel"),
                ("k1", "b5")))
        if n <= 2048:
            row["split_ms"] = cs.split_ms(
                "B5", lambda sp, _: cs.b5_split(cache, gid, slot_table, w,
                                                sp),
                want, "tiered_gather_kernel", wides=(0,))
        row["bound_ms"] = cs.gather_bound(distinct, 4 * M, n)[0]
        emit(row)


def b6_phase(lib_old, spec, tables, caches, device) -> None:
    """B6 on both caches, int8 and e4m3: old and new held to the plain
    version (rtol 2e-5 / atol 1e-6), the new kernel with one warp a query
    bit-equal to the old one on byte pairs and with the wide loads, timed
    in turns; on the
    128-slot cache B4 on the same rows in turns with the new B6; byte
    pairs against the wide loads, each at the split the entry gives it;
    at the decode sizes every split with each."""
    gen = torch.Generator(device=device).manual_seed(10)
    old = {kind: old_function(lib_old, f"tiered_gather_quant_{sym}",
                              tiered_gather._QUANT_ARGS)
           for kind, sym in QUANT_SYMBOL.items()}
    log2r = tiered_gather._log2(cs.SHARD_ROWS)
    full = max(caches)
    for n, queries, slots, _, quantized, slot_table, gid, idx, w in \
            tiered_cells(spec, caches, gen, device):
        distinct = torch.unique(gid).numel()
        split, split_wide = entry_split(n), entry_split(n, 32)
        for kind in cs.PAYLOADS:
            tq, ts = quantized[kind]
            want = tiered_gather.tiered_gather_quant_plain(
                tq, ts, gid, slot_table, w, shard_rows=cs.SHARD_ROWS)
            out_old = torch.empty_like(want)

            def old_call():
                _build.check(old[kind](tq.data_ptr(), ts.data_ptr(),
                                       gid.data_ptr(), slot_table.data_ptr(),
                                       w.data_ptr(), out_old.data_ptr(), n,
                                       TOP_K, M, log2r, device.index,
                                       stream()), "old B6")

            def new_call():
                return tiered_gather.tiered_gather_quant(
                    tq, ts, gid, slot_table, w, shard_rows=cs.SHARD_ROWS,
                    resident=True)
            old_call()
            new = new_call()
            torch.cuda.synchronize()
            row = {"kernel": "tiered_gather_quant", "payload": kind, "n": n,
                   "queries": queries, "cache_slots": slots,
                   "distinct_rows": distinct, "split_pair": split,
                   "split_wide": split_wide}
            for which, out in (("old", out_old), ("new", new)):
                row[f"{which}_err"] = (out - want).abs().max().item()
                cs.check(torch.allclose(out, want, rtol=2e-5, atol=1e-6),
                         f"{which} B6 differs from its plain version: {row}")
            for wide, layout in ((0, "pairs"), (1, "wide")):
                key = f"split1_{layout}_bit_equal_old"
                row[key] = bool(torch.equal(
                    cs.b6_split(tq, ts, gid, slot_table, w, 1, wide),
                    out_old))
                cs.check(row[key], f"B6 with one warp a query ({layout}) is "
                                   f"not bit-equal to the old kernel: {row}")
            row.update(turns(old_call, new_call,
                             "tiered_gather_quant_kernel"))
            if slots == full:  # B4's rows
                bq, bs = tables[kind]
                row.update(turns(
                    lambda: gather_interp.gather_interp_quant(bq, bs, idx,
                                                              w),
                    new_call, ("gather_interp_quant_kernel",
                               "tiered_gather_quant_kernel"), ("b4", "b6")))
            row.update(turns(
                lambda: cs.b6_split(tq, ts, gid, slot_table, w, split, 0),
                lambda: cs.b6_split(tq, ts, gid, slot_table, w, split_wide,
                                    1),
                "tiered_gather_quant_kernel", ("pair", "wide")))
            if n <= 2048:
                row["split_ms"] = cs.split_ms(
                    f"B6 ({kind})",
                    lambda sp, wd: cs.b6_split(tq, ts, gid, slot_table, w,
                                               sp, wd),
                    want, "tiered_gather_quant_kernel")
            row["bound_ms"] = cs.gather_bound(distinct, M + 4, n)[0]
            emit(row)


def bwdq_cell(row, old_call, out_old, new_call, want, bound) -> dict:
    """Hold old and new against the plain version (rtol 1e-4 / atol 1e-5)
    and time them in turns: one row of the bwdq phase."""
    old_call()
    new = new_call()
    torch.cuda.synchronize()
    for which, out in (("old", out_old), ("new", new)):
        row[f"{which}_err"] = (out - want).abs().max().item()
        cs.check(torch.allclose(out, want, rtol=1e-4, atol=1e-5),
                 f"{which} backward without scatter differs from its plain "
                 f"version: {row}")
    row.update(turns(old_call, new_call, "lookup_bwd_kernel"))
    row["bound_ms"], row["bound_by"] = bound
    return row


def bwdq_phase(lib_old, spec, values, tables, device) -> None:
    """The backward's instances without scatter: rows fp32 / int8 / e4m3
    (`lookup_bwd_rows`, `lookup_bwd_quant`), dq and dw, on the flat route
    at 16,384 and 65,536, uniform and clustered queries; range int8 / e4m3
    (`lookup_bwd_range`), dq and dw, at 32,768 on both 2^19-row shard
    halves (a foreign candidate's dw exactly 0)."""
    gen = torch.Generator(device=device).manual_seed(7)
    wrap = (ctypes.c_int * 8)(*spec.K)
    name = {"fp32": "f32", **QUANT_SYMBOL}
    for n in FLAT_SHAPES:
        for queries in ("uniform", "clustered"):
            q = make_queries(n, queries, spec, gen, device)
            idx, w = e8_lookup.lram_query(q, spec, TOP_K)
            g = torch.randn(n, M, generator=gen, device=device)
            rws, by_kind = flat_cell(values, tables, idx, gen)
            distinct = torch.unique(rws).numel()
            for payload, (table, scale) in by_kind.items():
                fn = ops.lookup_bwd_rows if scale is None \
                    else ops.lookup_bwd_quant
                args = (table, rws) if scale is None else (table, scale, rws)
                ptrs = (table.data_ptr(),
                        None if scale is None else scale.data_ptr(),
                        rws.data_ptr())
                for stage in ("dq", "dw"):
                    dq = stage == "dq"
                    extra = {"idx": idx, "q": q, "spec": spec} if dq else {}
                    want = ops.lookup_bwd_plain(
                        table, idx, w, g, extra.get("q"), spec, scale=scale,
                        rows=rws, scatter=False)[1]
                    out_old = torch.empty_like(want)
                    old_fn = old_function(
                        lib_old, f"lookup_bwd_rows_{stage}_{name[payload]}",
                        ops._ROWS_DQ_ARGS if dq else ops._ROWS_DW_ARGS)
                    head = (idx.data_ptr(), w.data_ptr(), g.data_ptr(),
                            q.data_ptr()) if dq else (w.data_ptr(),
                                                      g.data_ptr())
                    tail = (n, TOP_K, M) + ((wrap,) if dq else ())

                    def old_call():
                        _build.check(old_fn(*ptrs, *head, out_old.data_ptr(),
                                            *tail, device.index, stream()),
                                     "old backward without scatter")
                    row = {"kernel": fn.__name__, "payload": payload,
                           "stage": stage, "n": n, "queries": queries,
                           "route": "flat", "distinct_rows": distinct}
                    emit(bwdq_cell(
                        row, old_call, out_old,
                        lambda: fn(*args, w, g, **extra), want,
                        cs.no_scatter_bound(
                            n, distinct, 4 * M if scale is None else M + 4,
                            stage, n * TOP_K, rows_apart=True)))
    n = RANGE_N
    q = make_queries(n, "uniform", spec, gen, device)
    idx, w = e8_lookup.lram_query(q, spec, TOP_K)
    g = torch.randn(n, M, generator=gen, device=device)
    for base in (0, RANGE_ROWS):
        ok = sharded_gather.local_rows(idx, base, RANGE_ROWS)[1]
        distinct = torch.unique(idx[ok]).numel()
        for kind in cs.PAYLOADS:
            shard = tables[kind][0][base:base + RANGE_ROWS]
            scale = tables[kind][1][base:base + RANGE_ROWS]
            for stage in ("dq", "dw"):
                dq = stage == "dq"
                extra = {"q": q, "spec": spec} if dq else {}
                want = ops.lookup_bwd_plain(shard, idx, w, g, extra.get("q"),
                                            spec, scale=scale, scatter=False,
                                            base=base)[1]
                out_old = torch.empty_like(want)
                old_fn = old_function(
                    lib_old, f"lookup_bwd_range_{stage}_{name[kind]}",
                    (ops._RANGE_DQ_ARGS if dq else ops._RANGE_DW_ARGS)[False])
                mid = (q.data_ptr(),) if dq else ()
                tail = (wrap,) if dq else ()

                def old_call():
                    _build.check(old_fn(shard.data_ptr(), scale.data_ptr(),
                                        idx.data_ptr(), w.data_ptr(),
                                        g.data_ptr(), *mid,
                                        out_old.data_ptr(), n, TOP_K, M,
                                        base, RANGE_ROWS, *tail,
                                        device.index, stream()),
                                 "old range backward")

                def new_call():
                    return ops.lookup_bwd_range(shard, idx, w, g, base,
                                                scale=scale, **extra)[1]
                row = {"kernel": "lookup_bwd_range", "payload": kind,
                       "stage": stage, "n": n, "base": base,
                       "in_range_share": float(ok.float().mean()),
                       "distinct_rows": distinct}
                emit(bwdq_cell(row, old_call, out_old, new_call, want,
                               cs.no_scatter_bound(
                                   n, distinct, M + 4, stage,
                                   int(ok.sum()), rows_apart=False)))
                if not dq:
                    cs.check(not new_call()[~ok].any(),
                             "a foreign candidate's dw is not 0")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--old", required=True, type=Path,
                   help="root of the parent checkout (its src/ at least)")
    p.add_argument("--sass", action="store_true")
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma-separated, of {PHASES}")
    args = p.parse_args()
    phases = args.phases.split(",")
    cs.check(set(phases) <= set(PHASES), f"--phases: one of {PHASES}")
    cs.check(torch.cuda.is_available(), "needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    logs = _build.build_all(SOURCES)
    old = build_old(args.old)
    for name in SOURCES:
        for which, log in (("old", old[name][1]), ("new", logs[name])):
            for r in cs.ptxas_report(log):
                emit({"ptxas": which, **r})
    if args.sass:
        for name, kernels in SASS_KERNELS.items():
            for which, path in (("old", AB_DIR / f"lib{name}_old.so"),
                                ("new", _build._target(name))):
                for kernel in kernels:
                    for r in sass_report(str(path), kernel):
                        emit({"sass": which, **r})
    spec = indexing.choose_torus(20)
    gen = torch.Generator(device=device).manual_seed(0)
    values = torch.randn(spec.num_locations, M, generator=gen, device=device)
    k2_new = _build.function("e8_lookup", "lram_query_f32", e8_lookup._ARGS)
    k2_old = old["e8_lookup"][0].lram_query_f32
    k2_old.argtypes, k2_old.restype = e8_lookup._ARGS, ctypes.c_int
    if "k2" in phases:
        k2_phase(k2_new, k2_old, spec, device)
    if "bwd" in phases:
        bwd_phase(old["lookup_bwd"][0], spec, values, device)
    if "range" in phases:
        range_phase(old["lookup_bwd"][0], spec, values, device)
    if "k1" in phases:
        k1_phase(old["gather_interp"][0], spec, values, device)
    tables = {}  # payload -> (q, scale) of the whole table
    if {"row9", "b4", "bwdq", "b5", "b6"} & set(phases):
        host = values.cpu().numpy()
        for kind in cs.PAYLOADS:
            tq, ts = quant.quantize_rows_np(host, kind)
            tables[kind] = (quant.as_torch_payload(tq).to(device),
                            torch.from_numpy(ts).to(device))
        del host
    if "row9" in phases:
        row9_phase(old["sharded_gather"][0], spec, values, tables, device)
    if "order" in phases:
        order_phase(spec, values, device)
    if "b4" in phases:
        b4_phase(old["gather_interp_quant"][0], spec, values, tables, device)
    if "bwdq" in phases:
        bwdq_phase(old["lookup_bwd"][0], spec, values, tables, device)
    if {"b5", "b6"} & set(phases):
        caches = tiered_caches(values, tables, device)
        if "b5" in phases:
            b5_phase(old["tiered_gather"][0], spec, values, caches, device)
        if "b6" in phases:
            b6_phase(old["tiered_gather"][0], spec, tables, caches, device)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True})


if __name__ == "__main__":
    main()
