"""(p4a)'s router term in float32: phi3.5-moe-42b-a6.6b cut to `--layers`
layers at its published widths with the memory FFN (`chip_smoke.py`'s
path (p) config, `with_lram(20)` on the layer num_layers // 2), in
float32, trained `--steps` steps through `train.main` (`--batch 8 --seq
256`, drawn on the card from seed 0, no final evaluation) on one process
(`--placement pallas`, as (p3)) and then on 4 spawned gloo ranks of the
one card (data 2 x model 2, `--placement sharded`, as (p4a)).

    python3 tools/router_fp32.py [--layers 2] [--steps 5]

Prints a JSON line for each run (losses, router terms, a rank's peak
memory) and one with the router term's and the loss's relative
differences by step, mesh against one process.  In bfloat16 (path
(p4a)) the two parted by up to 3.9% at step 5 before; in
float32 the rounding that parts them is 2^16 times finer.  Needs one
card."""

import argparse
import functools
import gc
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.launch import mesh as mesh_lib  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
# every call of `chip_smoke.h_config` (here and in the spawned ranks,
# which import this module again) builds the float32 config
cs.h_config = functools.partial(cs.h_config, dtype="float32")
# no final evaluation: its 64-sequence probe through the MoE layer (~1 GB
# a buffer in float32) does not fit four float32 ranks on one card, and
# the question is the training steps' router term
cs.train.evaluate = lambda model, dcfg, steps=4: (math.nan, math.nan)


def summary(records) -> dict:
    return {"losses": [r["loss"] for r in records],
            "aux": [r["aux"] for r in records],
            "grad_norms": [r["grad_norm"] for r in records]}


def rank_main(rank: int, port: int, results, layers: int,
              steps: int) -> None:
    """One rank: (p4a)'s run in float32."""
    cs._rank_env(rank, port)
    mesh, _ = mesh_lib.init_mesh("cuda")
    out = cs.p_train(ARCH, layers, cs.p_argv(ARCH, steps, "sharded", True),
                     None)
    results.put({"rank": rank, "coords": mesh.coords,
                 "peak_memory_bytes": out["peak"],
                 "dtype": out["cfg"].dtype, **summary(out["run"].records)})
    dist.destroy_process_group()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    cs._build.build_all()
    t0 = time.perf_counter()
    one = cs.p_train(ARCH, args.layers, cs.p_argv(ARCH, args.steps), None)
    cfg = one["cfg"]
    want = summary(one["run"].records)
    print(json.dumps({"run": "one process", "config": cfg.name,
                      "dtype": cfg.dtype, "layers": cfg.num_layers,
                      "peak_memory_bytes": one["peak"],
                      "wall_s": time.perf_counter() - t0, **want}),
          flush=True)
    del one
    gc.collect()  # the run's step closure holds the model in a cycle
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks, wall_s = cs._spawn_ranks(rank_main, (args.layers, args.steps),
                                    "router fp32 mesh")
    for r in ranks:
        print(json.dumps({"run": "mesh", "wall_s_incl_spawn": wall_s, **r}),
              flush=True)
    rel = {k: [max(abs(r[k][s] / want[k][s] - 1) for r in ranks)
               for s in range(args.steps)]
           for k in ("aux", "losses", "grad_norms")}
    print(json.dumps({"router_fp32": {
        "card": card, "layers": args.layers, "steps": args.steps,
        "mesh": {"data": 2, "model": 2},
        "max_rel_err_by_step": rel,
        "mesh_peak_memory_bytes": max(r["peak_memory_bytes"]
                                      for r in ranks)}}), flush=True)


if __name__ == "__main__":
    main()
