"""The mesh training of two checkouts in turns on one card: old, new, new,
old.

    mkdir -p build/old && git archive <old tree> src | tar -x -C build/old
    python3 tools/mesh_ab.py --old build/old [--rounds 1]

Each turn launches 4 ranks (`torch.distributed.run`, gloo: they share
the card) that train `lram-bert-medium` at full width through one
checkout's `repro_torch.launch.train.main` with `chip_smoke.py`'s mesh
arguments (`--placement sharded --use-mesh --batch 8 --seq 256 --steps
20`, data 2 x model 2), the kernels built first.  Prints a JSON line a
turn (rank 0's step-time median over steps 6-20, tokens/s, every rank's
peak device memory) and one with each side's medians.  Fails unless
every turn's losses are within rtol 1e-5 of the new checkout's first
turn's."""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "lram-bert-medium", "--placement", "sharded",
        "--use-mesh", "--batch", "8", "--seq", "256", "--steps", "20"]
TURN = """
import json, os, sys
import torch
import torch.distributed as dist
from repro_torch.launch import train
torch.backends.cuda.matmul.allow_tf32 = False
run = train.main(json.loads(sys.argv[1]))
torch.cuda.synchronize()
with open(os.path.join(sys.argv[2], f"rank{dist.get_rank()}.json"),
          "w") as f:
    json.dump({"peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "step_ms": [r["step_ms"] for r in run.records],
               "losses": [r["loss"] for r in run.records]}, f)
dist.destroy_process_group()
"""
BUILD = "from repro_torch.kernels import _build; _build.build_all()"


def _env(checkout: str) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(checkout, "src"))


def turn(checkout: str, script: str, out: str) -> dict:
    os.makedirs(out)
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", script, json.dumps(ARGS), out], cwd=checkout,
        env=_env(checkout), capture_output=True, text=True, timeout=900)
    if done.returncode:
        raise SystemExit(f"mesh_ab: a turn failed in {checkout}:\n"
                         f"{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    ranks = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    median = float(np.median(ranks[0]["step_ms"][5:]))
    return {"step_ms_median_steps_6_20": median,
            "tokens_per_sec": 8 * 256 / (median / 1e3),
            "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                          for r in ranks],
            "losses": ranks[0]["losses"]}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--old", required=True, help="the old checkout's root")
    p.add_argument("--rounds", type=int, default=1,
                   help="old, new, new, old this many times")
    args = p.parse_args()
    sides = {"old": os.path.abspath(args.old), "new": REPO}
    for side in sides.values():
        subprocess.run([sys.executable, "-c", BUILD], cwd=side,
                       env=_env(side), check=True, timeout=900)
    runs = {"old": [], "new": []}
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "turn.py")
        with open(script, "w") as f:
            f.write(TURN)
        for i, side in enumerate(["old", "new", "new", "old"]
                                 * args.rounds):
            r = turn(sides[side], script, os.path.join(tmp, str(i)))
            runs[side].append(r)
            print(json.dumps({"turn": i, "side": side,
                              **{k: v for k, v in r.items()
                                 if k != "losses"}}), flush=True)
    want = np.array(runs["new"][0]["losses"])
    err = max(float(np.max(np.abs(np.array(r["losses"]) / want - 1)))
              for rs in runs.values() for r in rs)
    print(json.dumps({
        "argv": ARGS,
        **{f"{side}_{k}": float(np.median([r[k] for r in rs]))
           for side, rs in runs.items()
           for k in ("step_ms_median_steps_6_20", "tokens_per_sec")},
        **{f"{side}_peak_memory_bytes": max(
            max(r["peak_memory_bytes_by_rank"]) for r in rs)
           for side, rs in runs.items()},
        "losses_max_rel_err": err}), flush=True)
    if err > 1e-5:
        raise SystemExit(f"mesh_ab: losses differ by {err} (relative)")


if __name__ == "__main__":
    main()
