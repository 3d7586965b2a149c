"""Roofline analysis over the dry-run's artifacts (torch counterpart of
`repro.analysis.roofline`), at one NVIDIA H100's data-sheet peaks.

    PYTHONPATH=src python -m repro_torch.analysis.roofline \\
        [--dir artifacts/torch_dryrun] [--mesh single]

Per (arch x shape) cell, the three roofline terms of a device's step,
from the artifact's counts (`launch.dryrun`: the port's own step run on
`meta` tensors at full depth, so the counts are exact, `"source":
"full_depth"`; the reference's artifacts read as the reference reads
them):

    compute    = FLOPs_per_device / 989 TFLOP/s (bf16 dense, H100 SXM)
    memory     = bytes_per_device / 3.35 TB/s HBM3
    collective = wire_bytes_per_device / 450 GB/s (NVLink, each way;
                 ring-model accounting, see analysis/collectives.py)

plus MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference) and
the usefulness ratio MODEL_FLOPS / FLOPs (replication and recompute
waste), the dominant term, and the roofline fraction
    model_compute_time / max(term)  ("how close to the compute roofline a
perfectly-overlapped execution of this artifact could get").

The port's `bytes_per_device` sums every aten op's inputs and outputs
unfused, an upper bound of the HBM traffic, so its memory term is an
upper bound too: the roofline fraction is then a lower bound, and a
"memory" dominant term follows from that byte count, not from a trace.

NVLink joins the 8 cards of one host; a group of more than 8 (the 16 x
16 mesh's axes are 16 ranks each) crosses hosts over a slower network,
so there the collective term at the NVLink rate is only a lower bound
of its time, and the report says so.  The peaks are parameters
(`analyze_artifact`), the data sheet's by default.

Also here: the reckoning of one train step's products and memory from
a model's leaves (`whole_leaves`, `train_flops`, `train_bytes`), the
yardstick the on-card train paths print beside their measurements.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os

from repro_torch.distributed import collectives, sharding
from repro_torch.models import moe

PEAK_FLOPS = 989e12   # bf16 dense tensor-core rate, H100 SXM (data sheet)
HBM_BW = 3.35e12      # bytes/s, HBM3, H100 SXM (data sheet)
LINK_BW = 450e9       # bytes/s, NVLink each way, H100 SXM (data sheet)
NVLINK_DOMAIN = 8     # the cards one host's NVLink joins

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,
    "long_500k": 1,
}


def analyze_artifact(art: dict, *, peak_flops: float = PEAK_FLOPS,
                     hbm_bw: float = HBM_BW,
                     link_bw: float = LINK_BW) -> dict | None:
    """One cell's roofline row (the reference's keys), None for a cell
    that did not run.  The counts are read from `art[art["source"]]`
    (the port's "full_depth"), or as the reference reads its own
    artifacts ("extrapolated", else "scanned")."""
    if art.get("status") != "ok":
        return None
    src = art.get("source") or (
        "extrapolated" if "extrapolated" in art else "scanned")
    ex = art.get(src)
    flops = ex.get("flops_per_device")
    bytes_ = ex.get("bytes_per_device")
    wire = ex.get("total_wire_bytes_per_device") or 0.0
    if flops is None:
        return None
    devices = art["devices"]
    shape = art["shape"]
    tokens = SHAPE_TOKENS[shape]
    mult = 6 if shape.startswith("train") else 2
    model_flops_global = mult * art["params_active"] * tokens
    model_flops_dev = model_flops_global / devices

    t_compute = flops / peak_flops
    t_memory = (bytes_ or 0.0) / hbm_bw
    t_coll = wire / link_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = max(terms.values())
    return {
        "arch": art["arch"],
        "shape": shape,
        "source": src,
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "wire_bytes_per_device": wire,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_global": model_flops_global,
        "useful_flops_ratio": model_flops_dev / flops if flops else None,
        "roofline_fraction": (
            (model_flops_dev / peak_flops) / t_bound if t_bound else None
        ),
        "step_time_bound_s": t_bound,
    }


def _fmt_t(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{1e3 * x:.1f}ms"


def render_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute | memory | collective | dominant | "
           "useful-FLOP ratio | roofline frac |")
    sep = "|" + "---|" * 8
    lines = [hdr, sep]
    for r in sorted(rows, key=lambda r: (r["shape"], r["arch"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_t(r['t_compute_s'])} "
            f"| {_fmt_t(r['t_memory_s'])} | {_fmt_t(r['t_collective_s'])} "
            f"| **{r['dominant']}** "
            f"| {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |"
        )
    return "\n".join(lines)


def largest_group(art: dict) -> int:
    """The most ranks one of the artifact's mesh axes holds."""
    return max((art.get("mesh_shape") or {"": 1}).values())


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Roofline of the dry-run's artifacts at one H100's "
                    "data-sheet peaks (counts, not measurements).")
    p.add_argument("--dir", default="artifacts/torch_dryrun")
    p.add_argument("--mesh", default="single")
    p.add_argument("--out", default="artifacts/torch_roofline.md")
    p.add_argument("--json-out", default="artifacts/torch_roofline.json")
    args = p.parse_args(argv)

    rows, skipped, errors, group = [], [], [], 1
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            art = json.load(f)
        if art.get("mesh") != args.mesh:
            continue
        if art.get("status") == "skipped":
            skipped.append((art["arch"], art["shape"], art["reason"]))
            continue
        if art.get("status") == "error":
            errors.append((art["arch"], art["shape"],
                           art.get("error", "?")))
            continue
        row = analyze_artifact(art)
        if row:
            rows.append(row)
            group = max(group, largest_group(art))

    table = render_table(rows)
    title = {"single": "single-pod 16x16", "multi": "multi-pod 2x16x16"}
    report = [f"# Roofline ({title.get(args.mesh, args.mesh)}, "
              f"per-device terms; counts on meta, bounds at the H100 SXM "
              f"data sheet's peaks)", "",
              f"constants: {PEAK_FLOPS/1e12:.0f} TFLOP/s bf16, "
              f"{HBM_BW/1e12:.2f} TB/s HBM, {LINK_BW/1e9:.0f} GB/s NVLink "
              f"each way", ""]
    if group > NVLINK_DOMAIN:
        report += [f"A mesh axis of {group} ranks leaves one host's NVLink "
                   f"domain ({NVLINK_DOMAIN} cards): the collective term "
                   f"at the NVLink rate is only a lower bound of its "
                   f"time.", ""]
    report += [table, ""]
    if skipped:
        report.append("## Skipped cells")
        for a, s, r in skipped:
            report.append(f"* {a} x {s}: {r}")
    if errors:
        report.append("## Errored cells")
        for a, s, e in errors:
            report.append(f"* {a} x {s}: {e}")
    text = "\n".join(report)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(text)
    return 0


# ---------------------------------------------------------------------------
# a train step's products and memory, reckoned from its leaves
# ---------------------------------------------------------------------------

def whole_leaves(model) -> dict[str, tuple[tuple[int, ...], int]]:
    """{parameter key: (its whole shape, bytes an element)}: a dense
    leaf kept as this rank's block between steps by its global shape, a
    row-sharded table by the rows this rank holds."""
    blocks = sharding.dense_blocks(model)
    shapes = blocks.shapes if blocks is not None else {}
    return {k: (tuple(shapes.get(k, p.shape)), p.element_size())
            for k, p in model.named_parameters()}


def train_flops(leaves: dict, cfg, tied: bool, batch: int,
                seq: int) -> float:
    """The products one train step computes (2 flops a multiply-add
    forward, 4 backward), from `whole_leaves`: every Dense kernel once a
    token (the hybrid's shared block once a call), a tied embedding as
    the logits' product, an MoE's stacked experts on every row of its
    dispatch buffers (B x E x C, the capacity's, dropped or empty rows
    too) and the attention's two S x S products a head and layer.  Not
    counted: the memory layer's gathers (K1's bytes), norms, the SSD
    scan and convolutions."""
    tokens = batch * seq
    calls = (cfg.num_layers // cfg.hybrid_pattern
             if cfg.family == "hybrid" else 1)
    flops = 0.0
    for key, (shape, _) in leaves.items():
        size = math.prod(shape)
        if key == "embed.embedding":
            flops += 6 * tokens * size * tied
        elif ".experts." in key:
            flops += 6 * batch * moe.capacity(cfg, seq) * size
        elif key.endswith(".kernel") and len(shape) == 2:
            flops += 6 * tokens * size * (
                calls if key.startswith("shared_attn.") else 1)
    attn_layers = {"ssm": 0, "hybrid": calls}.get(cfg.family,
                                                  cfg.num_layers)
    return flops + 12.0 * batch * cfg.num_heads * seq * seq \
        * cfg.head_dim * attn_layers


def train_bytes(leaves: dict, cfg, tokens: int, model=None) -> dict:
    """The memory a train step should hold, reckoned from `whole_leaves`:
    the parameters and their gradients (the leaves' dtypes), Adam's two
    fp32 moments, and three fp32 copies of the logits (the log-softmax,
    its gradient and the logits' own; `tokens` a rank's).  On a mesh
    (`model` given, its `DenseBlocks`: a rank's view) the leaves as this
    rank holds them (blocks, replicated leaves, a table's rows), their
    gradients and moments, plus the largest unit whole with its whole
    gradient (the forward and backward gather one unit at a time; a
    shared unit is held through the backward) and the buffers of its
    sum (the blocks of every batch rank, float32 for a 2-byte leaf over
    more than 2 ranks)."""
    params = sum(math.prod(shape) for shape, _ in leaves.values())
    pbytes = sum(math.prod(shape) * size for shape, size in leaves.values())
    logits = 3 * 4 * tokens * cfg.vocab_size
    blocks = None if model is None else sharding.dense_blocks(model)
    if blocks is None:
        parts = {"params": pbytes, "grads": pbytes, "adam_moments":
                 8 * params, "logits_fp32_x3": logits}
    else:
        held = [p for p in model.parameters()]
        hbytes = sum(p.numel() * p.element_size() for p in held)

        def unit_bytes(unit, acc: bool) -> int:
            return sum(math.prod(blocks.shapes[k]) * (
                collectives.sum_dtype(blocks.params[k].dtype,
                                      blocks.batch_group).itemsize
                if acc else blocks.params[k].element_size())
                for k in unit.keys)

        largest = max(blocks.units.values(),
                      key=lambda u: unit_bytes(u, False))
        parts = {"params_held": hbytes, "grads_held": hbytes,
                 "adam_moments_held": 8 * sum(p.numel() for p in held),
                 "largest_unit_whole_and_grad": 2 * unit_bytes(largest,
                                                               False),
                 "largest_unit_sum_buffers": unit_bytes(largest, True),
                 "logits_fp32_x3": logits}
    return {**parts, "params": params,
            "reckoned_bytes": sum(parts.values())}


if __name__ == "__main__":
    raise SystemExit(main())
