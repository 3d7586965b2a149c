"""The collectives of a step, tallied (torch counterpart of
`repro.analysis.hlo`).

The reference scans the partitioned HLO for its collectives; torch has
no HLO, so the port records each collective where it issues it: every
one a step issues goes through `repro_torch.distributed.collectives`,
which, under `recording()`, appends (op, bytes, group size, site) with
the bytes of the op's result on this rank, as the HLO's per-device
shapes give them.  `stats` reads that list and applies the reference's
ring wire-cost factors:

    all-reduce       2 (g-1)/g * bytes      (reduce-scatter + all-gather)
    all-gather         (g-1)/g * bytes_out
    reduce-scatter     (g-1)   * bytes_out  (= (g-1)/g * bytes_in)
    all-to-all         (g-1)/g * bytes
    collective-permute           bytes

so the numbers are wire bytes per device per step.  Each collective is
recorded once, by the call that issues it.  Not recorded: the
checkpoint's gathers of host arrays and the trainer's agreement on a
resume step (`dist.gather`, `dist.all_gather_object`): no step issues
them.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


def wire_bytes(op: str, nbytes: float, g: int) -> float:
    """The ring model's bytes on the wire a device for one collective of
    result `nbytes` over a group of `g`."""
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * nbytes
    if op in ("all-gather", "all-to-all"):
        return (g - 1) / g * nbytes
    if op == "reduce-scatter":
        return (g - 1) * nbytes
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}; known: {OPS}")


def input_bytes(op: str, nbytes: float, g: int) -> float:
    """The bytes a device puts into one collective of result `nbytes`:
    an all-gather's block, a reduce-scatter's g chunks, else the
    tensor."""
    if op == "all-gather":
        return nbytes / g
    if op == "reduce-scatter":
        return nbytes * g
    return float(nbytes)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    raw_bytes: dict        # sum of result bytes per op kind
    wire_bytes: dict       # ring-model wire bytes per device per op kind
    # {site: {op: {"count", "raw_bytes", "input_bytes"}}}, the records'
    # site labels (None: "step")
    by_site: dict = dataclasses.field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def gathered_bytes(self, site: str) -> float:
        """The bytes the all-gathers at `site` returned (the whole leaves
        of the dense blocks' gathers)."""
        return self.by_site.get(site, {}).get("all-gather", {}).get(
            "raw_bytes", 0)

    def summed_bytes(self, site: str) -> float:
        """The bytes this device put into the sums at `site` (its reduce-
        scatters' chunks and its all-reduces' tensors)."""
        ops = self.by_site.get(site, {})
        return sum(ops.get(op, {}).get("input_bytes", 0)
                   for op in ("reduce-scatter", "all-reduce"))


def stats(records) -> CollectiveStats:
    """`CollectiveStats` of (op, bytes, group size[, site]) records."""
    counts: dict = defaultdict(int)
    raw: dict = defaultdict(float)
    wire: dict = defaultdict(float)
    by_site: dict = {}
    for rec in records:
        op, b, g = rec[:3]
        where = (rec[3] if len(rec) > 3 else None) or "step"
        counts[op] += 1
        raw[op] += b
        wire[op] += wire_bytes(op, b, g)
        entry = by_site.setdefault(where, {}).setdefault(
            op, {"count": 0, "raw_bytes": 0, "input_bytes": 0})
        entry["count"] += 1
        entry["raw_bytes"] += b
        entry["input_bytes"] += input_bytes(op, b, g)
    return CollectiveStats(dict(counts), dict(raw), dict(wire), by_site)
