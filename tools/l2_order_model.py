"""A CPU model of how much a query order saves K1 in HBM reads.

    PYTHONPATH=src python3 tools/l2_order_model.py [--n 65536]

Draws n uniform (and clustered: 64 near each of n / 64 points) torus
queries from a seed, takes their top-32 rows from K2's plain version, and
counts the row reads that miss an LRU cache of 50 MB (the H100's L2, whole
and halved) of 256-byte rows, with the queries in the given order, sorted
by the bucket of their top candidate's row (16,384 buckets, as
tools/csrc/query_order.cu sorts them) and by a Morton key of its torus
coordinates.  A model only: the
card's L2 is not one LRU, and many warps run at once.  Prints one JSON
line per query set.
"""

from __future__ import annotations

import argparse
import collections
import json

import numpy as np
import torch

from repro_torch.core import indexing
from repro_torch.kernels import e8_lookup

ROW_BYTES = 256  # an fp32 row of m = 64


def misses(order, idx, cap_rows: int) -> int:
    cache = collections.OrderedDict()
    miss = 0
    for t in order:
        for r in idx[t]:
            if r in cache:
                cache.move_to_end(r)
            else:
                miss += 1
                cache[r] = None
                if len(cache) > cap_rows:
                    cache.popitem(last=False)
    return miss


def morton(rows: np.ndarray, spec) -> np.ndarray:
    """Bits of the 8 torus coordinates interleaved, low bits first."""
    x = indexing.decode_index(rows, spec) % np.array(spec.K)
    bits = [int(k).bit_length() - 1 for k in spec.K]
    key, pos = np.zeros(len(rows), np.int64), 0
    for b in range(max(bits)):
        for d in range(8):
            if b < bits[d]:
                key |= ((x[:, d] >> b) & 1) << pos
                pos += 1
    return key


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    spec, n = indexing.choose_torus(20), args.n
    gen = torch.Generator().manual_seed(args.seed)
    K = torch.tensor(spec.K, dtype=torch.float32)
    uniform = torch.rand(n, 8, generator=gen) * K
    near = torch.arange(n) % max(n // 64, 1)
    clustered = uniform[near] + 1e-3 * torch.rand(n, 8, generator=gen)
    cap = 50 * 2**20 // ROW_BYTES
    for name, q in (("uniform", uniform), ("clustered", clustered)):
        idx = torch.cat([e8_lookup.lram_query_plain(q[i:i + 4096], spec, 32)[0]
                         for i in range(0, n, 4096)])
        rows = idx.numpy().astype(np.int64)
        orders = {
            "given": np.arange(n),
            "top_row_buckets": np.argsort(
                rows[:, 0] * 16384 // spec.num_locations, kind="stable"),
            "morton": np.argsort(morton(rows[:, 0], spec), kind="stable")}
        out = {"queries": name, "n": n, "pairs": int(rows.size),
               "distinct_rows": int(len(np.unique(rows)))}
        for key, order in orders.items():
            out[f"{key}_misses_50MB"] = misses(order, rows, cap)
            out[f"{key}_misses_25MB"] = misses(order, rows, cap // 2)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
