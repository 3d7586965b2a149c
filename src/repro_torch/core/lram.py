"""LRAM: the lattice-based differentiable random-access memory layer
(torch counterpart of `repro.core.lram`).

    x (..., 2*h*8) --per-head query norm--> torus_map --> q (..., h, 8)
      --top-k query (K2)--> (index, weight) pairs
      --weighted gather from the shared value table (N, m) (K1), scale-->
    y (..., h*m)

plus the memory-augmented FFN block dense(w -> w) . LRAM(w -> 4w) .
dense(4w -> w) that replaces a transformer FFN (paper §3.1).

The table and the two memory-read steps come from the resolved lookup
plan (`repro_torch.core.lookup`): a `Parameter`, a `QuantizedTable`, a
`TieredValueStore`, a `ShardedTieredStore` or this rank's row shard of
the table.  The table's dtype is `LRAMConfig.table_dtype` whatever the
model's: float32 (the default), bfloat16 or float16, which a dense or
row-sharded table keeps as its `Parameter`'s dtype and a tiered store as
its host tier's (its device cache stays float32, as the reference's does); a
1-byte table is quantized from that draw.  The query norm's and the two
dense layers' leaves take the model's dtype (bfloat16 in the public
archs), the query is cast to float32 before `torus_map`, every gather
sums in float32 and the read is cast back to the input's dtype, as the
reference does.
Between the gather and the scale `lram_apply` consults the per-tenant
overlay context (`repro_torch.core.overlay`), as the reference's does:
inside the serve engine's `activate` block it adds the tenant's row
deltas and records the access after the scale; outside one nothing
extra runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch import nn as tnn
from repro_torch.core import indexing, lattice, lookup, overlay, torus


# LRAMConfig.table_dtype names the port takes
TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}
# names the reference takes too but builds no table of their own from:
# without jax's x64 a "float64" table is a float32 draw (behind a
# warning), and an "int8" one rounds the 0.02-scale draw to all zeros
REFUSED_TABLE_DTYPES = {
    "float64": "the reference (x64 off) draws it as float32: ask for "
               "float32",
    "int8": "a cast of the 0.02-scale draw to int8 is all zeros (the "
            "reference's lookup returns exactly 0): use table_quant='int8' "
            "for a 1-byte table",
}


@dataclasses.dataclass(frozen=True)
class LRAMConfig:
    log2_locations: int = 18  # N = 2**18 == paper's LRAM-small
    torus: Any = None         # explicit TorusSpec; None = choose_torus
    m: int = 64               # value dim per head (paper: 64)
    heads: int = 32           # h; layer input dim = 16*h, output = m*h
    top_k: int = 32           # paper §2.6: top-32 carries >=99.5% of mass
    query_norm: str = "batch"  # batch | rms | none  (paper: batchnorm)
    value_init_scale: float = 0.02
    table_dtype: str = "float32"  # float32 | bfloat16 | float16
    # --- the lookup plan's three axes (repro_torch.core.lookup) ---
    interp_impl: str = "reference"  # placement: reference/pallas (dense) |
    #                                 tiered | sharded | sharded-tiered
    tiered: Any = None              # memstore.TieredSpec for tiered placements
    table_quant: str = "none"       # storage: none | int8 | fp8
    lookup_kernel: str = "auto"     # kernel: auto | reference | pallas
    model_shards: int = 0           # sharded-tiered row-range owners
    #                                 (0 = ambient mesh's model-axis size)

    def __post_init__(self):
        if self.table_dtype not in TABLE_DTYPES:
            why = REFUSED_TABLE_DTYPES.get(
                self.table_dtype, "the port builds no table in it")
            raise ValueError(
                f"table_dtype {self.table_dtype!r} is refused: {why}; the "
                f"port takes {sorted(TABLE_DTYPES)}")
        if self.table_quant not in ("none", "int8", "fp8"):
            raise ValueError(
                f"table_quant must be none|int8|fp8, got {self.table_quant!r}"
            )
        if self.torus is not None \
                and self.torus.num_locations != 2**self.log2_locations:
            raise ValueError(
                f"torus has {self.torus.num_locations} locations but "
                f"log2_locations={self.log2_locations}"
            )

    @property
    def torus_spec(self) -> indexing.TorusSpec:
        if self.torus is not None:
            return self.torus
        return indexing.choose_torus(self.log2_locations)

    @property
    def num_locations(self) -> int:
        return 2**self.log2_locations

    @property
    def in_dim(self) -> int:
        return 2 * lattice.DIM * self.heads

    @property
    def out_dim(self) -> int:
        return self.m * self.heads

    @property
    def num_params(self) -> int:
        return self.num_locations * self.m

    @property
    def torch_table_dtype(self) -> torch.dtype:
        return TABLE_DTYPES[self.table_dtype]

    @property
    def table_bytes_per_entry(self) -> int:
        """Storage bytes per table row: the values in `table_dtype` (4 or 2
        bytes each), or the 1-byte payload plus its per-row scale."""
        from repro_torch import quant

        if self.table_quant == "none":
            return self.m * self.torch_table_dtype.itemsize
        return quant.bytes_per_entry(self.m, self.table_quant)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

class LRAM(nn.Module):
    """The memory layer's state: the table `values` (the plan's table
    object over (N, m) rows) and the query norm (`qnorm`); `lram_apply`
    runs it."""

    def __init__(self, cfg: LRAMConfig, *,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        plan = lookup.resolve(cfg)  # unsupported cells fail at build time
        self.cfg = cfg
        # every plan starts from the same fp32 draw, rounded to the table's
        # dtype (the reference draws in it directly: the values differ,
        # the rounding of every later step does not)
        self.values = plan.build_table(tnn.truncated_normal_(
            torch.empty(cfg.num_locations, cfg.m), cfg.value_init_scale,
            generator,
        ).to(cfg.torch_table_dtype))
        if cfg.query_norm == "batch":
            self.qnorm = tnn.BatchNorm(2 * lattice.DIM, dtype=dtype)
        elif cfg.query_norm == "rms":
            self.qnorm = tnn.RMSNorm(2 * lattice.DIM, dtype=dtype)
        else:
            self.qnorm = None


def lram_init(cfg: LRAMConfig, *,
              generator: torch.Generator | None = None,
              dtype: torch.dtype = torch.float32) -> LRAM:
    """The layer with freshly drawn values (batchnorm stats in buffers);
    `dtype` is the query norm's."""
    return LRAM(cfg, generator=generator, dtype=dtype)


def lram_apply(layer: LRAM, x: torch.Tensor, *, train: bool = False,
               interp_impl: str | None = None, return_access: bool = False):
    """Apply the memory layer to x (..., 2*8*heads) -> y (..., heads*m).

    `interp_impl` overrides the config's placement for this call.  In
    train mode the batchnorm runs on batch statistics and its running
    stats update in place.  Gradients reach x, and the table as its plan's
    ``table_update`` says, through the plan's `lookup`: `ops.lram_lookup`
    in the ``pallas`` cells (the backward kernel, analytic d query; a
    dense fp32 table gets its scatter-add, a tiered store its host
    write-back, a dense 1-byte table nothing), or plain autograd in the
    dense ``reference`` cells (CPU only).  With `return_access` also
    returns (idx, w).
    """
    cfg = layer.cfg
    if x.shape[-1] != cfg.in_dim:
        raise ValueError(f"LRAM expects {cfg.in_dim} features, got "
                         f"{tuple(x.shape)}")
    plan = lookup.resolve(cfg, interp_impl)
    lead = x.shape[:-1]
    xh = x.reshape(*lead, cfg.heads, 2 * lattice.DIM)
    # the reference pins heads to the model axis here: in torch that is
    # `distributed.context.constrain`, the identity, so nothing is called
    if cfg.query_norm == "batch":
        xh = layer.qnorm(xh, train=train)
    elif cfg.query_norm == "rms":
        xh = layer.qnorm(xh)
    spec = cfg.torus_spec
    q, scale = torus.torus_map(xh.float(), spec.K)
    out, idx, w = plan.lookup(layer.values, q.contiguous(), spec,
                              cfg.top_k)
    # the serve engine's per-tenant overlay: the rows a tenant rewrote
    # corrected before the scale, the access recorded after it
    octx = overlay.current()
    if octx is not None:
        out = octx.apply(idx, w, out)
    out = out * scale  # (..., heads, m)
    if octx is not None:
        octx.record(idx, w, out)
    y = out.reshape(*lead, cfg.out_dim).to(x.dtype)
    if return_access:
        return y, (idx, w)
    return y


# ---------------------------------------------------------------------------
# Memory-augmented FFN block (paper §3.1)
# ---------------------------------------------------------------------------

def memffn_config(width: int, log2_locations: int, **kw) -> LRAMConfig:
    """The paper's block shape: (n, m, h) = (8, 64, w/16)."""
    if width % 16 != 0:
        raise ValueError("width must be divisible by 16")
    return LRAMConfig(
        log2_locations=log2_locations, m=64, heads=width // 16, **kw
    )


class MemFFN(nn.Module):
    """The memory FFN's weights; `memffn_apply` runs it."""

    def __init__(self, width: int, cfg: LRAMConfig, *,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.in_dim != width or cfg.out_dim != 4 * width:
            raise ValueError("cfg does not match the paper block shape")
        self.lram = LRAM(cfg, generator=generator, dtype=dtype)
        self.wi = tnn.Dense(width, width, generator=generator, dtype=dtype)
        self.wo = tnn.Dense(4 * width, width, generator=generator,
                            dtype=dtype)


def memffn_init(width: int, cfg: LRAMConfig, *,
                generator: torch.Generator | None = None,
                dtype: torch.dtype = torch.float32) -> MemFFN:
    """The block with `dtype` leaves (the table in `cfg.table_dtype`)."""
    return MemFFN(width, cfg, generator=generator, dtype=dtype)


def memffn_apply(block: MemFFN, x: torch.Tensor, *, train: bool = False,
                 interp_impl: str | None = None,
                 return_access: bool = False):
    """dense . LRAM . dense; with `return_access` also the LRAM's (idx,
    w)."""
    h = block.wi(x)
    h = lram_apply(block.lram, h, train=train, interp_impl=interp_impl,
                   return_access=return_access)
    if return_access:
        h, access = h
        return block.wo(h), access
    return block.wo(h)
