"""Tiered value table: host-RAM shards + a device-resident hot cache (torch
counterpart of `repro.memstore.store`).

The (N, m) table is split into shards of `shard_rows` consecutive rows:

    global row id  r  ->  shard  r >> log2(shard_rows)
                          row    r &  (shard_rows - 1)

  * **Host tier** — one `(num_shards, shard_rows, m)` numpy array: fp32,
    bf16 (a store of `dtype=torch.bfloat16`, the table's
    `LRAMConfig.table_dtype`: its raw bits as uint16, the reference's
    ml_dtypes bytes), fp16 (`dtype=torch.float16`: a numpy float16 array,
    the reference's own), or a 1-byte payload (int8, or e4m3 bytes as uint8)
    plus `(num_shards, shard_rows)` fp32 scales for a quantized store.  In host
    RAM (`backing="ram"`), or a memory-mapped ``.npy`` file on disk
    (`backing="mmap"`: ``values_{N}x{m}.npy`` and ``scales_{N}x{m}.npy``
    under `TieredSpec.backing_dir`, or a fresh ``memstore_*`` temporary
    directory) for a table larger than host memory.  Everything that
    reads or writes the host tier indexes the array, so a memmap serves
    it unchanged.
  * **Device tier** — `cache_slots` shard-sized slots on the store's device
    (`.to(device)` moves it; the host tier stays on the host), their host
    mirror `cache_np` (the slots' current contents, which the write-back
    updates), and the indirection `shard -> slot` (-1 = not resident).
    The cache is fp32 over a bf16 or fp16 host tier, as the reference's
    is: a fill widens the rows exactly, an eviction of a dirty slot rounds
    it back to the tier's dtype.
  * **Fills** are batched per lookup: the shards a batch touches are made
    resident first (LRU eviction, the batch's shards pinned; a dirty
    victim is written back to its host shard first), and every slot filled
    or written since the last lookup is copied host -> device in one
    stacked copy (`_sync_device`).  `prefetch` runs the same fill from a
    predicted index set; the serve engine feeds it the previous tick's
    accesses (`prefetch_last`).
  * **Overflow** — when a batch touches more shards than there are slots,
    the rows of the shards left out are served from the host tier (counted
    in `stats["uncached"]`): correctness never depends on the cache size.
  * **Gather** — all touched shards resident: the indirected kernels B5
    (fp32) or B6 (1-byte rows) gather straight from the cache.  Otherwise
    the overflow rows are appended to the cache and the flat gather K1 or
    B4 reads cache + overflow through precomputed rows (`lookup_rows`), as
    the reference's XLA path does.  On a CPU store the plain versions run.
  * **Training write-back** — the table's gradient arrives as sparse
    (index, w ⊗ g) pairs (`writeback`, from the differentiable lookups of
    `repro_torch.memstore.interp` and `kernels.ops`) and is applied on the
    host as a sparse SGD step (`writeback_lr`, 0 = off): to the cache
    mirror for resident rows, whose slots turn dirty (written back to the
    host shard on eviction or `flush`) and stale on the device, and to the
    host tier for the others (a bf16 or fp16 host row adds each pair's
    update, rounded to the tier's dtype, and rounds after each add: the
    reference's `np.add.at` on its 2-byte array; on an fp16 tier that is
    numpy's own `np.add.at`).  A quantized store dequantizes the touched
    rows, applies the summed update and requantizes with a fresh per-row
    scale and stochastic rounding (int8; fp8 rounds to nearest), drawing
    from its own `np.random.default_rng(0)` in the reference's order, so
    the same (index, update) sequence gives the reference's payloads bit
    for bit.

  * **Checkpoint I/O** — `shard_host` / `shard_scale_host` read a shard
    through the cache (a dirty slot wins), `load_shard` replaces one (a
    quantized payload, its scales or fp32 rows, converted to the store's
    kind) and refreshes a cached copy, `load_dense` replaces the table and
    empties the cache: what `repro_torch.checkpoint` streams.

  * **Lifecycle** (`repro_torch.memctl`) — `shard_access` counts every
    looked-up element a shard (`row_stats`, the store's telemetry);
    `_read_rows_raw` reads rows in storage form from the host tier (dirty
    slots flushed first) without touching residency or stats; `grow_rows`
    appends host shards, each row a copy of its parent (payload and
    scale bit for bit; a memmap tier moves to a fresh file of the new
    shape), and leaves the cache, its slots and LRU order as they were.

Observability (`repro_torch.obs`, the reference's points): `_map` adds
its hits, misses and uncached elements to the `memstore.*` counters,
`_ensure_resident` its fills and evictions (and the `memstore.fill_s`
histogram), `_sync_device` its bytes (`memstore.fill_bytes`, the
`memstore.device_sync_s` histogram: the host's time to issue the copy),
`apply_writeback` one `memstore.writebacks`.

Every mutation of residency, LRU order, the cache mirror and `stats`
takes the store's re-entrant lock.  Fills are issued on the current
stream; a side stream for them is a performance item (ROADMAP).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import tempfile
import threading
import time
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch import obs, quant
from repro_torch.core import lookup
from repro_torch.distributed import collectives, context
from repro_torch.kernels import tiered_gather


@dataclasses.dataclass(frozen=True)
class TieredSpec:
    """Static configuration of a tiered table (hashable: rides LRAMConfig)."""

    shard_rows: int = 2048      # rows per shard (power of two)
    cache_slots: int = 32       # device-resident shards
    backing: str = "ram"        # ram | mmap
    backing_dir: str | None = None  # mmap only; default: a temporary dir
    use_pallas: bool = False    # the CUDA kernels (plain on CPU) vs the
    #                             reference cell (plain, CPU only)
    quant: str = "none"         # none | int8 | fp8: 1-byte rows + row scales

    def __post_init__(self):
        if self.shard_rows < 1 or self.shard_rows & (self.shard_rows - 1):
            raise ValueError("shard_rows must be a power of two")
        if self.cache_slots < 1:
            raise ValueError("need at least one cache slot")
        if self.backing not in ("ram", "mmap"):
            raise ValueError(f"unknown backing {self.backing!r}")
        if self.quant != "none":
            quant.check_kind(self.quant)


class TieredValueStore(nn.Module):
    """Host-resident (N, m) value table with a device hot cache.

    An `nn.Module` with no parameters or buffers: it sits at an LRAM
    layer's `values`, `model.to(device)` moves its device tier (the next
    lookup re-uploads the resident slots there) and the state_dict skips
    it.  The table's payload enters through `from_dense` / `from_payload`.
    """

    def __init__(self, num_rows: int, m: int, spec: TieredSpec,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_rows % spec.shard_rows:
            raise ValueError(f"num_rows={num_rows} not divisible by "
                             f"shard_rows={spec.shard_rows}")
        self.spec = spec
        self.num_rows = num_rows
        self.m = m
        self.quant = spec.quant
        quantized = self.quant != "none"
        if dtype not in _HOST_DTYPE:
            raise TypeError(f"a tiered store holds float32, bfloat16 or "
                            f"float16 rows, not {dtype}")
        # the rows' logical dtype: fp32, bf16 or fp16 (the reference's
        # `dtype`);
        # a quantized store's is fp32 whatever the table's was
        self.dtype = torch.float32 if quantized else dtype
        # the host tier's numpy dtype (`_read_rows_raw`'s storage form)
        self.storage_dtype = (quant.storage_dtype(self.quant) if quantized
                              else _HOST_DTYPE[self.dtype])
        self.shard_rows = spec.shard_rows
        self.num_shards = num_rows // spec.shard_rows
        self.cache_slots = min(spec.cache_slots, self.num_shards)
        self._log2R = self.shard_rows.bit_length() - 1

        self._host, self._host_scale = self._alloc_host()
        # the cache's host mirror: what each slot holds now (fills copy the
        # host shard in, the write-back updates it, syncs upload from it)
        cshape = (self.cache_slots, self.shard_rows, m)
        self.cache_np = np.zeros(cshape, self.storage_dtype if quantized
                                 else np.float32)
        self.cache_scale_np = (np.zeros(cshape[:-1], np.float32)
                               if quantized else None)
        # device tier: (cache_slots * shard_rows, m) in the payload's raw
        # dtype (fp8 as uint8) and its scales; None until the first sync
        self.device = torch.device("cpu")
        self._cache_dev: torch.Tensor | None = None
        self._scale_dev: torch.Tensor | None = None
        self._shard_slot = np.full(self.num_shards, -1, np.int32)
        self._slot_shard = np.full(self.cache_slots, -1, np.int32)
        self._lru: collections.OrderedDict[int, int] = \
            collections.OrderedDict()
        self._free = list(range(self.cache_slots - 1, -1, -1))
        self._dirty: set[int] = set()      # slots newer than their shard
        self._dev_stale: set[int] = set()  # slots newer than the device
        self.last_access: np.ndarray | None = None
        # training write-back: sparse SGD rate (set by the trainer; 0 =
        # off) and the stochastic-rounding draws of an int8 requantization
        self.writeback_lr = 0.0
        self._wb_rng = np.random.default_rng(0)
        # looked-up elements a shard (telemetry: `row_stats`)
        self.shard_access = np.zeros(self.num_shards, np.int64)
        # guards residency, LRU order, the device tier and `stats`; reads of
        # a single stat stay lock-free
        self._lock = threading.RLock()
        self.reset_stats()

    # ------------------------------------------------------------ builders

    def _alloc_host(self):
        """(payload, scales or None) of the host tier at the current
        shape: zeros in RAM, or zero-filled memmaps of fresh ``.npy``
        files (the names encode the table's rows and width)."""
        shape = (self.num_shards, self.shard_rows, self.m)
        quantized = self.quant != "none"
        if self.spec.backing == "ram":
            return (np.zeros(shape, self.storage_dtype),
                    np.zeros(shape[:-1], np.float32) if quantized else None)
        d = self.spec.backing_dir or tempfile.mkdtemp(prefix="memstore_")
        os.makedirs(d, exist_ok=True)
        tag = f"{self.num_rows}x{self.m}"
        values = np.lib.format.open_memmap(
            os.path.join(d, f"values_{tag}.npy"), mode="w+",
            dtype=self.storage_dtype, shape=shape)
        scales = (np.lib.format.open_memmap(
            os.path.join(d, f"scales_{tag}.npy"), mode="w+",
            dtype=np.float32, shape=shape[:-1]) if quantized else None)
        return values, scales

    @classmethod
    def from_dense(cls, values, spec: TieredSpec) -> "TieredValueStore":
        """A store holding `values` (N, m): fp32, bf16 (a bfloat16
        tensor, or its bits as uint16) held as a bf16 host tier, or fp16 (a
        float16 tensor or array) held as an fp16 one; quantized
        (nearest, from the values as fp32) on the way in if the spec is
        quantized."""
        values, dtype = host_values(values)
        store = cls(values.shape[0], values.shape[1], spec, dtype)
        store._fill_host(values)
        return store

    @classmethod
    def from_payload(cls, q: np.ndarray, scale: np.ndarray,
                     spec: TieredSpec) -> "TieredValueStore":
        """A quantized store holding exactly this (N, m) payload (int8, or
        e4m3 bytes as uint8) and these (N,) scales, bit for bit."""
        q = np.asarray(q)
        store = cls(q.shape[0], q.shape[1], spec)
        store.load_payload(q, scale)
        return store

    def load_payload(self, q: np.ndarray, scale: np.ndarray) -> None:
        """Fill the host tier of a quantized store with this (N, m)
        payload and these (N,) scales, bit for bit (the cache is not
        touched: call before the first lookup)."""
        q = np.asarray(q)
        if self.quant == "none" or q.dtype != self.storage_dtype:
            raise ValueError(f"a {q.dtype} payload does not fit a store of "
                             f"quant={self.quant!r}")
        self._host[...] = q.reshape(self._host.shape)
        self._host_scale[...] = np.asarray(scale, np.float32).reshape(
            self._host_scale.shape)

    def to_dense(self) -> np.ndarray:
        """Flush the dirty slots and return the full (dequantized) table as
        an (N, m) fp32 array (a 2-byte host tier's values, exactly)."""
        self.flush()
        if self.quant == "none":
            return quant.host_rows_f32(self._host).reshape(
                self.num_rows, self.m).copy()
        return quant.dequantize_rows_np(self._host, self._host_scale) \
            .reshape(self.num_rows, self.m)

    def _fill_host(self, values: np.ndarray) -> None:
        """The host tier from (N, m) fp32 or fp16 values or bf16 bits:
        rounded to a 2-byte tier, quantized (nearest) for a 1-byte one."""
        if self.quant == "none":
            self._host[...] = self._host_form(values).reshape(
                self._host.shape)
        else:  # nearest rounding: the dense QuantizedTable's payload
            shaped = quant.host_rows_f32(values).reshape(self._host.shape)
            self._host[...], self._host_scale[...] = \
                quant.quantize_rows_np(shaped, self.quant)

    def _host_form(self, rows: np.ndarray) -> np.ndarray:
        """fp32 or fp16 values or bf16 bits as the dense host tier holds
        them: bf16 bits or fp16 values (rounded to nearest even), or
        fp32."""
        if self.dtype == torch.bfloat16:
            if rows.dtype == np.uint16:
                return rows
            return quant.f32_to_bf16(rows)
        if self.dtype == torch.float16:
            if rows.dtype == np.float16:
                return rows
            return quant.host_rows_f32(rows).astype(np.float16)
        return quant.host_rows_f32(rows)

    def _cache_form(self, host_rows: np.ndarray) -> np.ndarray:
        """Host-tier rows as the cache holds them: a bf16 or fp16 tier's
        widened to fp32 (exact); a 1-byte or fp32 payload as it is."""
        if self.dtype == torch.bfloat16:
            return quant.bf16_to_f32(host_rows)
        if self.dtype == torch.float16:
            return host_rows.astype(np.float32)
        return host_rows

    def load_dense(self, values) -> None:
        """Replace the table with `values` (N, m) (fp32, bf16 as a tensor
        or its bits, or fp16), rounded to a 2-byte host tier or quantized
        (nearest) on the way in; empties the cache."""
        values, _ = host_values(values)
        if values.shape != (self.num_rows, self.m):
            raise ValueError(f"shape {values.shape} != "
                             f"{(self.num_rows, self.m)}")
        with self._lock:
            self._shard_slot[:] = -1
            self._slot_shard[:] = -1
            self._lru.clear()
            self._free = list(range(self.cache_slots - 1, -1, -1))
            self._dirty.clear()
            self._dev_stale.clear()
            self._cache_dev = self._scale_dev = None
            self._fill_host(values)

    def _apply(self, fn, recurse=True):
        # `.to()` / `.cuda()`: the host tier stays; the device tier follows
        # and is uploaded whole from the host tier on the next sync
        device = fn(torch.empty(0, device=self.device)).device
        if device != self.device:
            with self._lock:
                self.device = device
                self._cache_dev = self._scale_dev = None
        return self

    # ----------------------------------------------------------- addressing

    def _split(self, flat_idx: np.ndarray):
        flat_idx = flat_idx.astype(np.int64)
        return flat_idx >> self._log2R, flat_idx & (self.shard_rows - 1)

    # -------------------------------------------------- residency / mapping

    def _ensure_resident(self, shards: Iterable[int]) -> None:
        """Make `shards` resident where capacity allows (LRU eviction, the
        request's own shards pinned; a dirty victim is written back first).
        A fill copies the host shard into the cache mirror; the slot goes
        stale on the device until the next `_sync_device`."""
        pinned = set(int(s) for s in shards)
        t0 = time.perf_counter()
        fills = evictions = 0
        with self._lock:
            for s in sorted(pinned):
                if self._shard_slot[s] >= 0:  # hit: touch
                    self._lru.move_to_end(s)
                    continue
                if self._free:
                    slot = self._free.pop()
                else:
                    victim = next(
                        (sh for sh in self._lru if sh not in pinned), None
                    )
                    if victim is None:  # whole cache pinned by this batch
                        continue
                    slot = self._lru.pop(victim)
                    self._writeback_slot(slot)
                    self._shard_slot[victim] = -1
                    self.stats["evictions"] += 1
                    evictions += 1
                self.cache_np[slot] = self._cache_form(self._host[s])
                if self.quant != "none":
                    self.cache_scale_np[slot] = self._host_scale[s]
                self._shard_slot[s] = slot
                self._slot_shard[slot] = s
                self._lru[s] = slot
                self._lru.move_to_end(s)
                self._dev_stale.add(slot)
                self.stats["fills"] += 1
                fills += 1
        if fills:
            obs.counter("memstore.fills").inc(fills)
            obs.histogram("memstore.fill_s").observe(
                time.perf_counter() - t0)
        if evictions:
            obs.counter("memstore.evictions").inc(evictions)

    def _map(self, flat_idx: np.ndarray):
        """(shard, row, slot, resident mask) for flat global row ids,
        filling misses along the way and counting hits / misses /
        uncached over every element."""
        shard, row = self._split(flat_idx)
        resident_before = self._shard_slot[shard] >= 0
        self._ensure_resident(np.unique(shard))
        slot = self._shard_slot[shard]
        mask = slot >= 0
        hits = int(resident_before.sum())
        misses = int((~resident_before & mask).sum())
        uncached = int((~mask).sum())
        with self._lock:
            self.last_access = flat_idx  # feeds prefetch_last()
            self.stats["lookups"] += 1
            self.stats["hits"] += hits
            self.stats["misses"] += misses
            self.stats["uncached"] += uncached
            self.shard_access += np.bincount(shard,
                                             minlength=self.num_shards)
        obs.counter("memstore.hits").inc(hits)
        obs.counter("memstore.misses").inc(misses)
        obs.counter("memstore.uncached").inc(uncached)
        return shard, row, slot.astype(np.int64), mask

    def prefetch(self, idx, *, sync_device: bool = True) -> None:
        """Fill the cache for a predicted index set without touching the
        hit/miss stats; with `sync_device` the host -> device copy is
        issued now (asynchronous on a card), else at the next lookup."""
        flat = np.asarray(idx).reshape(-1)
        shard, _ = self._split(flat)
        self._ensure_resident(np.unique(shard))
        if sync_device:
            self._sync_device()

    def prefetch_last(self, *, sync_device: bool = False) -> None:
        """Prefetch the previous lookup's accesses (decode locality): they
        turn most recently used, and shards that overflowed or were
        evicted get another fill attempt."""
        if self.last_access is not None:
            self.prefetch(self.last_access, sync_device=sync_device)

    def warm(self, shards: Iterable[int] | None = None) -> None:
        """Fill the cache ahead of serving (default: the lowest shards)."""
        if shards is None:
            shards = range(self.cache_slots)
        self._ensure_resident(shards)
        self._sync_device()

    # ------------------------------------------------------- device mirror

    def _raw_dtype(self) -> torch.dtype:
        """torch dtype of the host payload (fp8 as its uint8 bytes)."""
        return {"none": torch.float32, "int8": torch.int8,
                "fp8": torch.uint8}[self.quant]

    def _payload(self, raw: torch.Tensor) -> torch.Tensor:
        """A raw payload tensor viewed as its storage type (fp8 bytes as
        float8_e4m3fn)."""
        return raw.view(torch.float8_e4m3fn) if self.quant == "fp8" else raw

    def _staging(self, shape, dtype) -> torch.Tensor:
        # pinned on a card so the copy is asynchronous.  Each sync takes a
        # fresh buffer from torch's caching host allocator, which does not
        # hand a block out again until the copy recorded on it has finished,
        # so no staging buffer is rewritten while a copy from it is in flight
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _sync_device(self) -> None:
        """Copy every stale slot host -> device in one stacked copy (the
        whole cache on the first sync after a move)."""
        t0 = time.perf_counter()
        with self._lock:
            full = self._cache_dev is None
            if not full and not self._dev_stale:
                return
            slots = (np.arange(self.cache_slots) if full
                     else np.fromiter(sorted(self._dev_stale), np.int64))
            R, m = self.shard_rows, self.m
            block = self._staging((len(slots), R, m), self._raw_dtype())
            np.take(self.cache_np, slots, axis=0, out=block.numpy())
            sblock = None
            if self.quant != "none":
                sblock = self._staging((len(slots), R), torch.float32)
                np.take(self.cache_scale_np, slots, axis=0,
                        out=sblock.numpy())
            dev = block.to(self.device, non_blocking=True)
            sdev = (sblock.to(self.device, non_blocking=True)
                    if sblock is not None else None)
            if full:
                self._cache_dev = dev.reshape(-1, m)
                self._scale_dev = (sdev.reshape(-1) if sdev is not None
                                   else None)
            else:
                at = torch.from_numpy(slots).to(self.device)
                self._cache_dev.view(-1, R, m).index_copy_(0, at, dev)
                if sdev is not None:
                    self._scale_dev.view(-1, R).index_copy_(0, at, sdev)
            self._dev_stale.clear()
            synced = block.nbytes + (sblock.nbytes if sblock is not None
                                     else 0)
            self.stats["fill_bytes"] += synced
        obs.counter("memstore.fill_bytes").inc(synced)
        # the host's time to issue the copies (asynchronous on a card)
        obs.histogram("memstore.device_sync_s").observe(
            time.perf_counter() - t0)

    # ------------------------------------------------------------- lookups

    def gather(self, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """sum_k w[..., k] * values[idx[..., k]] -> (..., m) float32 on the
        store's device, not differentiable (`tiered_interp` and the plan's
        `lookup` are).  idx (..., k) int32 and w (..., k) float32 live on
        the store's device; idx is read on the host to map shards."""
        lead, top_k = idx.shape[:-1], idx.shape[-1]
        out = self._gather_mapped(
            self._map(idx.reshape(-1).cpu().numpy()),
            w.reshape(-1, top_k).float().contiguous(),
            idx.reshape(-1, top_k))
        return out.reshape(*lead, self.m)

    def _gather_mapped(self, mapped, w2: torch.Tensor, idx2=None,
                       sel=None) -> torch.Tensor:
        """(n, m) = sum_k w2 * rows of ids `_map` mapped: B5 / B6 when
        every one is resident, else K1 / B4 over the flat route.  `idx2`,
        the (n, k) ids on the device, where the caller has them.  With
        `sel`, a bool mask over the n * k elements, the ids mapped are
        the selected elements' and every other element reads the first
        selected one's row: the caller gives those weight 0."""
        self._sync_device()
        spread = ((lambda a: a) if sel is None
                  else (lambda a: _spread(a, sel)))
        if self.spec.use_pallas and mapped[3].all():
            if idx2 is None:
                shard, row = mapped[:2]
                idx2 = self._device_rows(spread(shard * self.shard_rows
                                                + row))
            cache = self._payload(self._cache_dev)
            slot_table = torch.from_numpy(self._shard_slot).to(self.device)
            idx2 = idx2.reshape(w2.shape).to(torch.int32).contiguous()
            if self.quant != "none":
                return tiered_gather.tiered_gather_quant(
                    cache, self._scale_dev, idx2, slot_table, w2,
                    shard_rows=self.shard_rows, resident=True)
            return tiered_gather.tiered_gather(
                cache, idx2, slot_table, w2, shard_rows=self.shard_rows,
                resident=True)
        raw, scale, rows = self._flat_table(*mapped)
        table = self._payload(raw)
        kernel = "pallas" if self.spec.use_pallas else "reference"
        rows = self._device_rows(spread(rows)).reshape(w2.shape)
        if scale is not None:
            return lookup.kernel_gather(kernel, "quant")(table, scale, rows,
                                                         w2)
        return lookup.kernel_gather(kernel, "fp32")(table, rows, w2)

    def lookup_rows(self, idx: torch.Tensor):
        """(table, scales or None, rows): the rows a lookup of `idx` reads,
        as one flat table on the store's device (the cache with the
        overflow rows appended) and each index's int32 row in it, shaped
        like idx.  Maps idx first (stats, fills) and syncs the device.
        The differentiable lookups read through this even when every shard
        is resident, and keep the table for their backward.

        On a mesh with more than one ``data`` rank idx is this rank's slice
        of the global batch: the global idx is gathered in rank order and
        mapped whole, so that fills, LRU order and stats are the one-rank
        run's on every rank (the int8 write-back draws in an order that
        depends on them), and this rank's rows are returned."""
        raw, scale, rows = self._flat_rows(*global_indices(idx))
        return self._payload(raw), scale, \
            self._device_rows(rows).reshape(idx.shape)

    def _flat_rows(self, flat_idx: np.ndarray, keep=None):
        """(raw table, scales or None, int64 rows) of global row ids,
        with no collective: map them all (stats, fills, LRU), then build
        the flat table for those `keep` selects (a bool mask; None: all)
        and sync the device."""
        mapped = self._map(flat_idx)
        if keep is not None:
            mapped = tuple(a[keep] for a in mapped)
        self._sync_device()
        return self._flat_table(*mapped)

    def _flat_table(self, shard, row, slot, mask):
        """The reference's XLA route: flat rows into the device cache with
        the overflow rows appended from the host tier.  The table is raw
        (fp8 as its uint8 bytes: `_payload` views it), the rows numpy."""
        table, table_scale = self._cache_dev, self._scale_dev
        slot_rows = np.where(mask, slot * self.shard_rows + row, 0)
        if not mask.all():
            inv = ~mask
            ovf = self._cache_form(self._host[shard[inv], row[inv]])
            slot_rows[inv] = table.shape[0] + np.arange(len(ovf))
            table = torch.cat([table, torch.from_numpy(ovf).to(self.device)])
            if table_scale is not None:  # overflow rows stay 1-byte
                ovf_scale = self._host_scale[shard[inv], row[inv]]
                table_scale = torch.cat(
                    [table_scale, torch.from_numpy(ovf_scale).to(self.device)])
        return table, table_scale, slot_rows

    def _device_rows(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int32)).to(self.device)

    # ------------------------------------------------------------ training

    def writeback(self, idx: torch.Tensor, w: torch.Tensor,
                  g: torch.Tensor) -> None:
        """The table's gradient from a differentiable lookup, applied as
        the sparse SGD step: idx (..., k), w (..., k) and g (..., m) come
        to the host (8 bytes an index and weight, 4m a query) and w ⊗ g is
        formed there in float32, the reference's product.  On a mesh with
        more than one ``data`` rank they are this rank's slice of the
        global batch: every rank gathers all three over ``data`` in rank
        order (not w ⊗ g, k times larger) and applies the global batch's
        update, as the one-rank run does.  A no-op while `writeback_lr` is
        0."""
        if self.writeback_lr > 0.0:
            self.apply_writeback(*global_update(idx, w, g))

    def apply_writeback(self, idx, wg) -> None:
        """Sparse SGD write-back: values[idx] -= writeback_lr * wg.

        `wg` (idx.shape + (m,)) is w ⊗ dL/dout, dL/dvalues restricted to
        the touched rows.  Resident rows are updated in the cache mirror
        (their slots turn dirty and stale on the device); rows of other
        shards update the host tier directly."""
        if self.writeback_lr <= 0.0:
            return
        flat = np.asarray(idx).reshape(-1)
        upd = -self.writeback_lr * np.asarray(wg, np.float32).reshape(
            -1, self.m)
        with self._lock:
            if self.quant != "none":
                self._apply_writeback_quant(flat, upd)
            else:
                shard, row = self._split(flat)
                slot = self._shard_slot[shard].astype(np.int64)
                mask = slot >= 0
                if mask.any():
                    np.add.at(self.cache_np, (slot[mask], row[mask]),
                              upd[mask])
                    touched = set(np.unique(slot[mask]).tolist())
                    self._dirty |= touched
                    self._dev_stale |= touched
                if not mask.all():
                    inv = ~mask
                    if self.dtype == torch.bfloat16:
                        self._add_bf16(shard[inv], row[inv], upd[inv])
                    else:  # an fp16 tier: each update rounded first
                        np.add.at(self._host, (shard[inv], row[inv]),
                                  upd[inv].astype(self._host.dtype))
            self.stats["writebacks"] += 1
        obs.counter("memstore.writebacks").inc()

    def _add_bf16(self, shard: np.ndarray, row: np.ndarray,
                  upd: np.ndarray) -> None:
        """host[shard, row] += bf16(upd), pair by pair in order, each sum
        taken in fp32 and rounded to bf16: the reference's `np.add.at` on
        its bf16 host tier, duplicates included.  The k-th pair of every
        row goes in one vectorised step (the rows of a step are distinct),
        steps in k order."""
        upd = quant.bf16_to_f32(quant.f32_to_bf16(upd))
        key = shard * self.shard_rows + row
        order = np.argsort(key, kind="stable")
        sk = key[order]
        first = np.r_[True, sk[1:] != sk[:-1]]
        pos = np.arange(len(sk))
        rank = np.empty(len(sk), np.int64)
        rank[order] = pos - np.maximum.accumulate(np.where(first, pos, 0))
        by_rank = np.argsort(rank, kind="stable")
        ends = np.cumsum(np.bincount(rank))
        for lo, hi in zip(np.r_[0, ends[:-1]], ends):
            sel = by_rank[lo:hi]
            sh, rw = shard[sel], row[sel]
            self._host[sh, rw] = quant.f32_to_bf16(
                quant.bf16_to_f32(self._host[sh, rw]) + upd[sel])

    def _apply_writeback_quant(self, flat: np.ndarray,
                               upd: np.ndarray) -> None:
        """Quantization-aware sparse step: duplicate indices accumulate
        first; each touched row is dequantized, updated and requantized
        with a fresh per-row scale and stochastic rounding (int8), the
        resident rows' draws first, then the host rows'."""
        uniq, inv = np.unique(flat, return_inverse=True)
        acc = np.zeros((len(uniq), self.m), np.float32)
        np.add.at(acc, inv, upd)
        shard, row = self._split(uniq)
        slot = self._shard_slot[shard].astype(np.int64)
        mask = slot >= 0
        rng = self._wb_rng if self.quant == "int8" else None
        if mask.any():
            sl, rw = slot[mask], row[mask]
            cur = quant.dequantize_rows_np(self.cache_np[sl, rw],
                                           self.cache_scale_np[sl, rw])
            q, s = quant.quantize_rows_np(cur + acc[mask], self.quant,
                                          rng=rng)
            self.cache_np[sl, rw] = q
            self.cache_scale_np[sl, rw] = s
            touched = set(np.unique(sl).tolist())
            self._dirty |= touched
            self._dev_stale |= touched
        if not mask.all():
            nm = ~mask
            sh, rw = shard[nm], row[nm]
            cur = quant.dequantize_rows_np(self._host[sh, rw],
                                           self._host_scale[sh, rw])
            q, s = quant.quantize_rows_np(cur + acc[nm], self.quant, rng=rng)
            self._host[sh, rw] = q
            self._host_scale[sh, rw] = s

    def _flush_slot_to_host(self, slot: int) -> None:
        shard = self._slot_shard[slot]
        self._host[shard] = (self.cache_np[slot] if self.quant != "none"
                             else self._host_form(self.cache_np[slot]))
        if self.quant != "none":
            self._host_scale[shard] = self.cache_scale_np[slot]

    def _writeback_slot(self, slot: int) -> None:
        if slot in self._dirty:
            self._flush_slot_to_host(slot)
            self._dirty.discard(slot)
            self.stats["dirty_writebacks"] += 1

    def flush(self) -> None:
        """Write every dirty cached shard back to its host shard."""
        with self._lock:
            for slot in sorted(self._dirty):
                self._flush_slot_to_host(slot)
                self.stats["dirty_writebacks"] += 1
            self._dirty.clear()

    # ---------------------------------------------------------- checkpoint

    def shard_host(self, i: int) -> np.ndarray:
        """Shard `i`'s stored payload as seen through the cache (a dirty
        slot wins, rounded to a 2-byte tier): fp32 rows, bf16 bits (uint16),
        fp16 rows,
        or the 1-byte payload of a quantized store (e4m3 as uint8 bytes),
        whose scales `shard_scale_host` gives."""
        with self._lock:
            slot = int(self._shard_slot[i])
            if slot >= 0 and slot in self._dirty:
                if self.quant != "none":
                    return self.cache_np[slot].copy()
                return np.array(self._host_form(self.cache_np[slot]))
            return self._host[i].copy()

    def shard_scale_host(self, i: int) -> np.ndarray:
        """Per-row fp32 scales of shard `i` (quantized stores only)."""
        if self.quant == "none":
            raise ValueError("a dense store has no scales")
        with self._lock:
            slot = int(self._shard_slot[i])
            if slot >= 0 and slot in self._dirty:
                return self.cache_scale_np[slot].copy()
            return self._host_scale[i].copy()

    def load_shard(self, i: int, arr: np.ndarray,
                   scale: np.ndarray | None = None) -> None:
        """Replace shard `i` with `arr` (shard_rows, m): fp32 or fp16 rows
        or bf16 bits (uint16; quantized, nearest, if the store is; rounded
        to a 2-byte tier, widened to an fp32 one), or a 1-byte payload (int8, or
        e4m3 as uint8 bytes) with its per-row `scale` (dequantized for a
        dense store, requantized for one of the other kind).  A cached copy
        is refreshed: stale on the device, no longer dirty; it takes the
        rows as given, widened to fp32 (the reference's
        `arr.astype(np.float32)`), not the 2-byte tier's rounding of
        them."""
        arr = np.asarray(arr)
        if arr.shape != (self.shard_rows, self.m):
            raise ValueError(f"shard {i}: shape {arr.shape} != "
                             f"{(self.shard_rows, self.m)}")
        if scale is not None and arr.dtype.itemsize != 1:
            raise ValueError("scale given but payload is not quantized")
        cached = None
        if quant.is_bf16_bits(arr):
            arr = arr.view(np.uint16)  # the reference's V2 bytes too
        if self.quant == "none":
            rows = (quant.dequantize_rows_np(arr, scale) if scale is not None
                    else arr)
            q, s, cached = self._host_form(rows), None, \
                quant.host_rows_f32(rows)
        elif scale is None:  # fp rows: quantize (nearest) on the way in
            q, s = quant.quantize_rows_np(quant.host_rows_f32(arr),
                                          self.quant)
        elif arr.dtype != self.storage_dtype:  # the other kind: requantize
            q, s = quant.quantize_rows_np(
                quant.dequantize_rows_np(arr, scale), self.quant)
        else:
            q, s = arr, np.asarray(scale, np.float32)
        with self._lock:
            self._host[i] = q
            if s is not None:
                self._host_scale[i] = s
            slot = int(self._shard_slot[i])
            if slot >= 0:  # refresh the cached copy too
                self.cache_np[slot] = q if cached is None else cached
                if s is not None:
                    self.cache_scale_np[slot] = s
                self._dirty.discard(slot)
                self._dev_stale.add(slot)

    # ----------------------------------------------------------- lifecycle

    def _read_rows_raw(self, rows: np.ndarray):
        """(payload, scales or None) of global row ids in storage form (the
        1-byte payload, fp8 as its uint8 bytes, and per-row scales; else
        fp32 rows or bf16 bits), read from the host tier after flushing the
        dirty slots.
        Residency, LRU order and stats are untouched: the bulk read of
        growth and migration, not a lookup."""
        with self._lock:
            self.flush()
            shard, row = self._split(np.asarray(rows).reshape(-1))
            payload = self._host[shard, row]
            scales = (self._host_scale[shard, row] if self.quant != "none"
                      else None)
        return payload, scales

    def grow_rows(self, new_num_rows: int, parents: np.ndarray) -> None:
        """Append rows [num_rows, new_num_rows), each a copy of its old
        row `parents[j - num_rows]` (payload and scale bit for bit), IN
        PLACE.  Growth is append-only (`indexing.grow_torus` keeps every
        old index), so the cache, the shard -> slot map of old shards, LRU
        order and dirty flags stay valid and nothing goes to the device;
        the appended shards compete for the same slots."""
        delta = new_num_rows - self.num_rows
        if delta <= 0 or delta % self.shard_rows:
            raise ValueError(
                f"new_num_rows={new_num_rows} must exceed {self.num_rows} "
                f"by a multiple of shard_rows={self.shard_rows}")
        parents = np.asarray(parents, np.int64).reshape(-1)
        if parents.size != delta:
            raise ValueError(f"need {delta} parent rows, got {parents.size}")
        if parents.min() < 0 or parents.max() >= self.num_rows:
            raise ValueError("parent row ids must index the old table")
        with self._lock:
            payload, scales = self._read_rows_raw(parents)
            new_shards = delta // self.shard_rows
            payload = payload.reshape(new_shards, self.shard_rows, self.m)
            if scales is not None:
                scales = scales.reshape(new_shards, self.shard_rows)
            old, old_scale = self._host, self._host_scale
            self.num_rows = new_num_rows
            self.num_shards += new_shards
            # a host tier of the new shape (a memmap: a fresh file, its
            # name has the rows), the old rows then the new
            self._host, self._host_scale = self._alloc_host()
            self._host[:len(old)] = old
            self._host[len(old):] = payload
            if scales is not None:
                self._host_scale[:len(old)] = old_scale
                self._host_scale[len(old):] = scales
            self._shard_slot = np.concatenate([
                self._shard_slot, np.full(new_shards, -1, np.int32)])
            self.shard_access = np.concatenate([
                self.shard_access, np.zeros(new_shards, np.int64)])
            self.last_access = None  # old ids stay valid, but re-prime

    def row_stats(self) -> tuple[np.ndarray, int]:
        """(looked-up elements a shard, rows a shard): the store's side of
        `repro_torch.memctl.telemetry`, one bin a host shard."""
        return self.shard_access.copy(), self.shard_rows

    # --------------------------------------------------------------- stats

    def reset_stats(self) -> None:
        with self._lock:
            self.shard_access[:] = 0
            self.stats = {
                "lookups": 0, "hits": 0, "misses": 0, "uncached": 0,
                "fills": 0, "evictions": 0, "writebacks": 0,
                "dirty_writebacks": 0, "fill_bytes": 0,
            }

    def bytes_per_entry(self) -> int:
        """Host-tier storage bytes per table row (payload + scale; 2m for
        a bf16 or fp16 tier)."""
        if self.quant == "none":
            return self.m * self.dtype.itemsize
        return quant.bytes_per_entry(self.m, self.quant)

    def hit_rate(self) -> float:
        total = self.stats["hits"] + self.stats["misses"] \
            + self.stats["uncached"]
        return self.stats["hits"] / total if total else 0.0

    def resident_shards(self) -> list[int]:
        """Shards currently cached, least- to most-recently used."""
        return list(self._lru)

    def extra_repr(self) -> str:
        return (f"rows={self.num_rows}, m={self.m}, "
                f"shards={self.num_shards}x{self.shard_rows}, "
                f"slots={self.cache_slots}, quant={self.quant!r}, "
                f"dtype={self.dtype}, device={self.device}")


# a dense store's rows -> its host tier's numpy dtype (bf16 as raw bits)
_HOST_DTYPE = {torch.float32: np.dtype(np.float32),
               torch.bfloat16: np.dtype(np.uint16),
               torch.float16: np.dtype(np.float16)}


def host_values(values) -> tuple[np.ndarray, torch.dtype]:
    """(host array, dtype) of a table handed to a store: a bfloat16 tensor
    (or bf16 bits: uint16, the reference's `V2` bytes) as its bits and
    torch.bfloat16; a float16 tensor or array as fp16 values and
    torch.float16; anything else as fp32 values and torch.float32."""
    if isinstance(values, torch.Tensor):
        if values.dtype == torch.bfloat16:
            return quant.bf16_bits(values), torch.bfloat16
        if values.dtype == torch.float16:
            return values.detach().cpu().numpy(), torch.float16
        return values.detach().float().cpu().numpy(), torch.float32
    values = np.asarray(values)
    if quant.is_bf16_bits(values):
        return values.view(np.uint16), torch.bfloat16
    if values.dtype == np.float16:
        return values, torch.float16
    return np.asarray(values, np.float32), torch.float32


def _spread(a: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """`a`'s values where `sel` is set, in order, and its first value at
    every other place."""
    out = np.full(sel.shape, a[0], a.dtype)
    out[sel] = a
    return out


def global_indices(idx: torch.Tensor):
    """(the global batch's flat indices on the host, the bool mask of this
    rank's among them or None): idx is this rank's slice of the batch,
    gathered over the ambient mesh's batch axes in rank order (C3)."""
    flat = idx.reshape(-1)
    group = context.batch_group()
    glob = collectives.all_gather_rows(flat, group).cpu().numpy()
    if group is None:
        return glob, None
    keep = np.zeros(glob.size, bool)
    rank = dist.get_rank(group)
    keep[rank * flat.numel():(rank + 1) * flat.numel()] = True
    return glob, keep


def global_update(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(idx, w ⊗ g) of the global batch on the host, the write-back's
    input: idx, w and g gathered over the ambient mesh's batch axes in
    rank order (not w ⊗ g, k times larger), w ⊗ g formed in float32."""
    group = context.batch_group()
    idx_np, w_np, g_np = (
        collectives.all_gather_rows(t.detach(), group).cpu().numpy()
        for t in (idx, w.float(), g.float()))
    return idx_np, w_np[..., None] * g_np[..., None, :]
