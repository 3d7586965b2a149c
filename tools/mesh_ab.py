"""The mesh training of two checkouts in turns on one card: old, new, new,
old.

    mkdir -p build/old && git archive <old tree> src | tar -x -C build/old
    python3 tools/mesh_ab.py --old build/old [--rounds 1]
    python3 tools/mesh_ab.py --old build/old --arch qwen2-1.5b \\
        --with-lram 20 --mesh-shape 4x1 --placement pallas --steps 3

Each turn launches 4 ranks (`torch.distributed.run`, gloo: they share
the card) that train through one checkout's
`repro_torch.launch.train.main` (`--use-mesh --batch 8 --seq 256` with
`--arch`, `--placement`, `--mesh-shape` and `--steps`; by default
`lram-bert-medium --placement sharded` on the default data 2 x model 2,
20 steps), the kernels built first.  `--with-lram N` trains
`configs.with_lram(get_config(arch), N)` on the dense `pallas` table
(the CLI has no flag for it: `configs.get_config` is replaced in each
rank, as `chip_smoke.py`'s path (p) does), its weights drawn on the card
(`transformer.init(device=)`).  Prints a JSON line a turn (rank 0's
step-time median over the steps from the sixth, or from the second in
a run of 5 or fewer, tokens/s, every rank's peak device memory, the
run's and the steps' (read as the final evaluation starts)) and one
with each side's medians.  Fails unless every turn's losses are within
`--loss-rtol` (default 1e-5) of the new checkout's first turn's."""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN = """
import json, os, sys
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import transformer
torch.backends.cuda.matmul.allow_tf32 = False
argv, out, arch, with_lram = json.loads(sys.argv[1]), sys.argv[2], \\
    sys.argv[3], int(sys.argv[4])
if with_lram:
    import dataclasses
    get, init = configs.get_config, transformer.init
    cfg = configs.with_lram(get(arch), with_lram)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    configs.get_config = lambda name, **kw: (
        cfg if name == arch and not kw else get(name, **kw))
    transformer.init = lambda *a, **kw: init(  # the rank's card, once set
        *a, **kw, device=torch.device("cuda", torch.cuda.current_device()))
steps_peak = []
evaluate = train.evaluate


def peak_then_evaluate(*args, **kw):
    steps_peak.append(torch.cuda.max_memory_allocated())
    return evaluate(*args, **kw)


train.evaluate = peak_then_evaluate
run = train.main(argv)
torch.cuda.synchronize()
with open(os.path.join(out, f"rank{dist.get_rank()}.json"), "w") as f:
    json.dump({"peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "steps_peak_memory_bytes": steps_peak[0],
               "step_ms": [r["step_ms"] for r in run.records],
               "losses": [r["loss"] for r in run.records]}, f)
dist.destroy_process_group()
"""
BUILD = "from repro_torch.kernels import _build; _build.build_all()"


def _env(checkout: str) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(checkout, "src"))


def turn(checkout: str, script: str, out: str, args) -> dict:
    os.makedirs(out)
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", script, json.dumps(args.argv), out, args.arch,
         str(args.with_lram)], cwd=checkout, env=_env(checkout),
        capture_output=True, text=True, timeout=1800)
    if done.returncode:
        raise SystemExit(f"mesh_ab: a turn failed in {checkout}:\n"
                         f"{done.stdout[-4000:]}\n{done.stderr[-4000:]}")
    ranks = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    first = 5 if args.steps > 5 else 1
    median = float(np.median(ranks[0]["step_ms"][first:]))
    return {"step_ms_median": median, "median_from_step": first + 1,
            "tokens_per_sec": 8 * 256 / (median / 1e3),
            "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                          for r in ranks],
            "steps_peak_memory_bytes_by_rank": [
                r["steps_peak_memory_bytes"] for r in ranks],
            "losses": ranks[0]["losses"]}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--old", required=True, help="the old checkout's root")
    p.add_argument("--rounds", type=int, default=1,
                   help="old, new, new, old this many times")
    p.add_argument("--arch", default="lram-bert-medium")
    p.add_argument("--with-lram", type=int, default=0,
                   help="add the memory FFN at this layer (with_lram)")
    p.add_argument("--placement", default="sharded")
    p.add_argument("--mesh-shape", default="",
                   help="DxM or PxDxM (default: the CLI's rule)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--loss-rtol", type=float, default=1e-5,
                   help="the turns' losses against the new checkout's "
                        "first turn's")
    args = p.parse_args()
    args.argv = (["--arch", args.arch, "--use-mesh", "--batch", "8",
                  "--seq", "256", "--steps", str(args.steps)]
                 + (["--placement", args.placement] if args.placement
                    else [])
                 + (["--mesh-shape", args.mesh_shape] if args.mesh_shape
                    else []))
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
            r = turn(sides[side], script, os.path.join(tmp, str(i)), args)
            runs[side].append(r)
            print(json.dumps({"turn": i, "side": side,
                              **{k: v for k, v in r.items()
                                 if k != "losses"}}), flush=True)
    want = np.array(runs["new"][0]["losses"])
    err = max(float(np.max(np.abs(np.array(r["losses"]) / want - 1)))
              for rs in runs.values() for r in rs)
    print(json.dumps({
        "argv": args.argv, "with_lram": args.with_lram,
        **{f"{side}_{k}": float(np.median([r[k] for r in rs]))
           for side, rs in runs.items()
           for k in ("step_ms_median", "tokens_per_sec")},
        **{f"{side}_{k}": max(max(r[k + "_by_rank"]) for r in rs)
           for side, rs in runs.items()
           for k in ("peak_memory_bytes", "steps_peak_memory_bytes")},
        "losses_max_rel_err": err}), flush=True)
    if err > args.loss_rtol:
        raise SystemExit(f"mesh_ab: losses differ by {err} (relative)")


if __name__ == "__main__":
    main()
