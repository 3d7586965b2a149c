"""Old against new on one card: K2 and the backward's scatter instances of
a parent checkout, timed in turns with this checkout's on the same inputs.

    mkdir -p build/parent && git archive <parent> src | tar -x -C build/parent
    python3 tools/kernel_ab.py --old build/parent [--sass]

Builds the parent's `csrc/e8_lookup.cu` and `csrc/lookup_bwd.cu` with the
flags of `repro_torch.kernels._build` into `build/kernels_ab/`, beside
this checkout's (built as the port builds them), and calls both through
their C entry points (the same names and arguments in both).  At the
serving and training shapes it holds each against its plain version
(K2's weights and indices bit-equal, on uniform queries and on
`lattice.tie_queries`; the backward's dvalues to atol 1e-5, dq / dw to
rtol 1e-4 / atol 1e-5, on uniform queries and, at n = 65,536, on
clustered ones: 64 queries near each point, as training's queries crowd
rows), then times old, new, new, old: each turn the mean
device time of 20 launches under torch.profiler.  It also times the
backward's instance without scatter on the same inputs: the scatter's
share of an instance is its time less that one's.  With `--sass` it
prints each kernel's static SASS instruction count and the size and mix
of each loop (a backward branch) from `cuobjdump -sass`.  Prints the
card (nvidia-smi) and one JSON line per measurement; exits non-zero on a
failed check.  Needs one card.
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
from repro_torch.core import indexing, lattice  # noqa: E402
from repro_torch.kernels import _build, e8_lookup, ops  # noqa: E402

SOURCES = ("e8_lookup", "lookup_bwd")
AB_DIR = ROOT / "build" / "kernels_ab"
K2_SHAPES = (128, 2048, 16384, 32768, 65536)
BWD_SHAPES = (128, 2048, 65536)
RANGE_N, RANGE_ROWS = 32768, 2**19
TOP_K, M = 32, 64


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


def turns(fn_old, fn_new, kernel: str) -> dict:
    """Device ms of one call, old, new, new, old: of the kernels whose
    names hold `kernel`, and of all the call's device work (fills too)."""
    got = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        ours, rest, _ = cs.device_split(fn_old if which == "old" else fn_new,
                                        kernel)
        got[which].append((ours, ours + (rest or 0.0)))
    out = {}
    for which, pairs in got.items():
        out[f"{which}_ms"] = float(np.mean([p[0] for p in pairs]))
        out[f"{which}_call_device_ms"] = float(np.mean([p[1] for p in pairs]))
        out[f"{which}_turns"] = [p[0] for p in pairs]
    _, per_kernel, counts = cs.profile(lambda: [fn_new() for _ in range(20)])
    out["new_by_kernel_ms"] = {
        k[:48]: per_kernel[k] / counts[k] / 1e3 for k in per_kernel}
    out["old_over_new"] = out["old_ms"] / out["new_ms"]
    out["call_old_over_new"] = (out["old_call_device_ms"]
                                / out["new_call_device_ms"])
    return out


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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
    cand_new, nsq = e8_lookup._padded_candidates(device)
    cand, _ = lattice.candidate_arrays()
    cand_old = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [cand, np.zeros((256 - len(cand), 8), np.float32)]).T)).to(device)
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
                for which, fn, cnd in (("old", old_fn, cand_old),
                                       ("new", new_fn, cand_new)):
                    call, idx, w = k2_call(fn, cnd, nsq, q, top_k, wrap)
                    call()
                    torch.cuda.synchronize()
                    row[f"{which}_same_idx_frac"] = \
                        (idx == idx_p).float().mean().item()
                    row[f"{which}_w_bit_equal"] = bool(torch.equal(w, w_p))
                    calls[which] = call
                cs.check(row["new_same_idx_frac"] == 1.0
                         and row["new_w_bit_equal"],
                         f"K2 differs from its plain version: {row}")
                if top_k == TOP_K:
                    row.update(turns(calls["old"], calls["new"],
                                     "lram_query_kernel"))
                    row["bound_ms"] = cs.bound_ms(
                        n * 8 * 4 + n * top_k * 8,
                        n * 232 * (23 + np.log2(top_k)))[0]
                emit(row)


def bwd_phase(lib_old, spec, values, device) -> None:
    """The dense scatter instances (B3's backward with dq, B1's VJP with
    dw): the parent's kernel (its call zero-fills dvalues first, as its
    wrapper did) against this checkout's wrapper, and this checkout's
    instance without scatter on the same inputs."""
    wrap = (ctypes.c_int * 8)(*spec.K)
    gen = torch.Generator(device=device).manual_seed(1)
    K = torch.tensor(spec.K, dtype=torch.float32, device=device)
    dvalues = torch.zeros_like(values)
    old_dq, old_dw = lib_old.lookup_bwd_dq_f32, lib_old.lookup_bwd_dw_f32
    old_dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    old_dw.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    old_dq.restype = old_dw.restype = ctypes.c_int
    cases = [(n, "uniform") for n in BWD_SHAPES] + [(BWD_SHAPES[-1],
                                                      "clustered")]
    for n, queries in cases:
        q = torch.rand(n, 8, generator=gen, device=device) * K
        if queries == "clustered":  # 64 queries near each of n / 64 points
            q = (q[:n // 64].repeat(64, 1) + 1e-3 * torch.rand(
                n, 8, generator=gen, device=device)).contiguous()
        idx, w = e8_lookup.lram_query(q, spec, TOP_K)
        g = torch.randn(n, M, generator=gen, device=device)
        out = torch.empty((n, 8), device=device)
        out_w = torch.empty((n, TOP_K), device=device)

        def old_dq_call():
            dvalues.zero_()
            _build.check(old_dq(values.data_ptr(), idx.data_ptr(),
                                w.data_ptr(), g.data_ptr(), q.data_ptr(),
                                dvalues.data_ptr(), out.data_ptr(), n, TOP_K,
                                M, wrap, device.index, stream()), "old dq")

        def old_dw_call():
            dvalues.zero_()
            _build.check(old_dw(values.data_ptr(), idx.data_ptr(),
                                w.data_ptr(), g.data_ptr(),
                                dvalues.data_ptr(), out_w.data_ptr(), n,
                                TOP_K, M, device.index, stream()), "old dw")
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
    old_fn = lib_old.lookup_bwd_range_dq_f32
    old_fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    old_fn.restype = ctypes.c_int
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

        def old_call():
            dvalues.zero_()
            _build.check(old_fn(shard.data_ptr(), idx.data_ptr(),
                                w.data_ptr(), g.data_ptr(), q.data_ptr(),
                                dvalues.data_ptr(), out.data_ptr(), n, TOP_K,
                                M, base, RANGE_ROWS, wrap, device.index,
                                stream()), "old range dq")

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


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--old", required=True, type=Path,
                   help="root of the parent checkout (its src/ at least)")
    p.add_argument("--sass", action="store_true")
    args = p.parse_args()
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
        for name, kernel in zip(SOURCES, ("lram_query_kernel",
                                          "lookup_bwd_kernel")):
            for which, path in (("old", AB_DIR / f"lib{name}_old.so"),
                                ("new", _build._target(name))):
                for r in sass_report(str(path), kernel):
                    emit({"sass": which, **r})
    spec = indexing.choose_torus(20)
    gen = torch.Generator(device=device).manual_seed(0)
    values = torch.randn(spec.num_locations, M, generator=gen, device=device)
    k2_new = _build.function("e8_lookup", "lram_query_f32", e8_lookup._ARGS)
    k2_old = old["e8_lookup"][0].lram_query_f32
    k2_old.argtypes, k2_old.restype = e8_lookup._ARGS, ctypes.c_int
    k2_phase(k2_new, k2_old, spec, device)
    bwd_phase(old["lookup_bwd"][0], spec, values, device)
    range_phase(old["lookup_bwd"][0], spec, values, device)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True})


if __name__ == "__main__":
    main()
