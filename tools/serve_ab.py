"""Serve paths of two checkouts in turns on one card: old, new, new, old.

    mkdir -p build/old && git archive <old tree> | tar -x -C build/old
    python3 tools/serve_ab.py --old build/old [--paths e f c] [--rounds 2]

Each turn is a fresh process that serves one of `chip_smoke.py`'s serve
paths through one checkout's `repro_torch.launch.serve.main` with
`chip_smoke.py`'s serve arguments (8 requests, 4 slots, prompts <= 64,
generation <= 32, `--warmup`), the kernels built before the serve
(`_build.build_all`).  A path whose code both checkouts share measures
the host's drift between turns.  Prints a JSON line a turn (tokens/s,
decode p50 / p99 ms, prefill median ms) and one a path with each side's
medians and whether each side's first logits were bit-equal over its
turns.  Fails unless every turn's first logits are within 1e-5 of the
new checkout's first turn's."""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_ARGS = ["--batch", "4", "--prompt-len", "64", "--gen", "32",
              "--requests", "8", "--seed", "0", "--warmup"]
PATHS = {
    "a": ["--arch", "lram-tiered"],
    "c": ["--arch", "lram-tiered", "--cache-slots", "128"],
    "e": ["--arch", "lram-sharded-tiered"],
    "f": ["--arch", "lram-sharded-tiered", "--cache-slots", "32"],
}
TURN = """
import json, sys
import numpy as np, torch
from repro_torch.kernels import _build
_build.build_all()
from repro_torch.launch import serve
report = serve.main(json.loads(sys.argv[1]))
torch.cuda.synchronize()
np.save(sys.argv[2], np.stack([r.first_logits for r in report.requests]))
print("TURN " + json.dumps({
    "tokens_per_sec": report.tokens_per_sec,
    "decode_p50_ms": report.p50_ms(), "decode_p99_ms": report.p99_ms(),
    "prefill_median_ms": 1e3 * float(np.median(report.prefill_s)),
    "requests": len(report.requests)}), flush=True)
"""


def turn(checkout: str, argv: list[str], logits: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(checkout, "src"))
    done = subprocess.run(
        [sys.executable, "-c", TURN, json.dumps(argv), logits],
        cwd=checkout, env=env, capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise SystemExit(f"serve_ab: a turn failed in {checkout}:\n"
                         f"{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    line = next(x for x in done.stdout.splitlines()
                if x.startswith("TURN "))
    out = json.loads(line[5:])
    if out["requests"] != 8:
        raise SystemExit(f"serve_ab: {out['requests']} of 8 requests")
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--old", required=True, help="the old checkout's root")
    p.add_argument("--paths", nargs="+", default=["e", "f", "c"],
                   choices=sorted(PATHS))
    p.add_argument("--rounds", type=int, default=2,
                   help="old, new, new, old this many times a path")
    args = p.parse_args()
    sides = {"old": os.path.abspath(args.old), "new": REPO}
    with tempfile.TemporaryDirectory() as tmp:
        for path in args.paths:
            argv = PATHS[path] + SERVE_ARGS
            runs = {"old": [], "new": []}
            first = {"old": [], "new": []}
            for i, side in enumerate(["old", "new", "new", "old"]
                                     * args.rounds):
                f = os.path.join(tmp, f"{path}-{i}.npy")
                r = turn(sides[side], argv, f)
                runs[side].append(r)
                first[side].append(np.load(f))
                print(json.dumps({"path": path, "turn": i, "side": side,
                                  **r}), flush=True)
            want = first["new"][0]
            err = max(float(np.abs(x - want).max())
                      for side in first for x in first[side])
            print(json.dumps({
                "path": path, "argv": PATHS[path],
                **{f"{side}_{k}": float(np.median([r[k] for r in rs]))
                   for side, rs in runs.items()
                   for k in ("tokens_per_sec", "decode_p50_ms",
                             "prefill_median_ms")},
                "first_logits_max_err": err,
                **{f"{side}_bit_equal_over_turns": all(
                    np.array_equal(x, xs[0]) for x in xs)
                   for side, xs in first.items()},
            }), flush=True)
            if err > 1e-5:
                raise SystemExit(f"serve_ab: path {path}: first logits "
                                 f"differ by {err}")


if __name__ == "__main__":
    main()
