"""Fault-tolerant checkpointing: atomic, checksummed, async (torch
counterpart of `repro.checkpoint.manager`, writing the same files).

Layout:  <dir>/step_<n>/
            manifest.json   — leaf paths, shapes, dtypes, crc32 checksums
            <leaf>.npy      — one file per tree leaf (path-mangled)

A tree is nested dicts (keys taken in sorted order, as a JAX pytree
flattens them) and lists or tuples (by index) whose leaves are numpy
arrays, torch tensors on any device, or tiered stores.  A leaf's name is
its path joined by "/": for a model, `repro_torch.launch.convert.
reference_tree` gives the reference's names, so the directory, manifest,
dtypes and crc32s are the reference's byte for byte and a checkpoint of
either package restores in the other.

Guarantees:
  * atomicity   — writes go to `step_<n>.tmp/` and are renamed only after
    the manifest (written last) is fsync'd; a crash mid-save never corrupts
    the latest valid checkpoint;
  * integrity   — restore verifies every leaf's and shard's crc32 against
    the manifest and falls back to the newest *valid* checkpoint;
  * async       — `save(..., blocking=False)` copies every leaf to host
    memory now (the training step mutates the live tensors in place) and
    writes in a daemon thread, overlapping I/O with the next steps;
  * retention   — keep the newest `keep` checkpoints;
  * tiered      — a `TieredValueStore` leaf is saved by *streaming* its
    shards to `<leaf>.shards/shard_NNNNNN.npy` one at a time (dirty cache
    slots flushed first), and restored by streaming them back into the
    live store in place.  A store under several paths (params and both
    Adam moments hold the same store) is written once and referenced
    (`tiered_ref`).  Such saves are blocking: the store's state is live;
  * quantized   — a quantized store writes its 1-byte payload plus
    `scale_NNNNNN.npy` per-row fp32 scales, each checksummed.  Restore
    converts freely (`TieredValueStore.load_shard`): quantized shards into
    a dense store, a dense checkpoint into a quantized one, int8 into
    e4m3 and back; a tiered checkpoint restored into a dense leaf is
    materialized (dequantized) on the host;
  * growth      — a smaller memory table restores into a larger one by
    tiling (`j mod old_N`); a shrink or a shard geometry mismatch raises
    `CheckpointError`;
  * mesh        — `sharding` ({leaf name: (mesh, axis)}, from
    `launch.convert.reference_sharding`) names the leaves that hold this
    rank's rows of a table split over a mesh axis.  A save on a mesh is
    called by every rank: those leaves are gathered into their global
    arrays (`distributed.sharding.gather_rows`, over the axis's gloo
    group, in `save` itself: the writer thread issues no collective), and
    rank 0 alone writes, renames and prunes, so the files are a
    one-process run's.  A tiered store is alike on every rank; rank 0
    streams it.  A restore with `sharding` checks each such leaf against
    `like`'s global shape and keeps this rank's rows of it
    (`distributed.sharding.own_rows`): a checkpoint restores onto any
    mesh shape, onto one process, or from one process onto a mesh.

fp8 payloads are e4m3 bytes: written as numpy's `<V1` (the descr the
reference's `ml_dtypes.float8_e4m3fn` arrays get), read back from `V1` as
uint8 bytes, so neither side needs `ml_dtypes`.  Every save and restore
appends its timings to `history`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import quant
from repro_torch.core import lookup
from repro_torch.distributed import sharding as mesh_rows

_MANIFEST = "manifest.json"
_FP8 = "float8_e4m3fn"


def _mangle(path: str) -> str:
    return path.replace("/", "__") + ".npy"


def _children(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _tree_items(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) in the order a JAX pytree flattens: dict keys sorted,
    sequences by index; a store is a leaf."""
    kids = None if lookup.is_store(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    items = []
    for key, child in kids:
        items += _tree_items(child, f"{prefix}/{key}" if prefix else key)
    return items


def _rebuild(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if lookup.is_store(like):
        return next(leaves)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of the leaf, its dtype's name); fp8 as uint8 bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.uint8).numpy(), _FP8
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _save(path: str, arr: np.ndarray, fp8: bool = False) -> None:
    """np.save, or for e4m3 bytes the reference's file: descr `<V1`."""
    if not fp8:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V1", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load(path: str) -> np.ndarray:
    """np.load; a `V1` array (e4m3 written by either package) as uint8."""
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 1:
        arr = arr.view(np.uint8)
    return arr


class CheckpointError(ValueError):
    """A checkpoint/target size mismatch the manager cannot reconcile —
    e.g. restoring a larger table into a smaller one (shrink), or
    incompatible shard geometry.  A *caller* error: raised through the
    newest-first fallback instead of silently trying older checkpoints.

    The reconcilable direction — a smaller checkpoint into a larger
    table — restores via grow-on-restore: old shards stream in at their
    ids, appended rows warm-start from their coarse-lattice parent
    (`j mod old_N`)."""


class _StructureMismatch(KeyError):
    """`like` asks for leaves the checkpoint does not have — a caller
    error, re-raised instead of triggering newest-first fallback."""


class _TieredLeaf:
    """A verified, not-yet-loaded tiered table inside a checkpoint dir."""

    def __init__(self, directory: str, meta: dict):
        self.dir = directory
        self.meta = meta

    @property
    def quant(self) -> str:
        return self.meta.get("quant", "none")

    def _read(self, kind: str, i: int) -> np.ndarray:
        """Load and checksum one shard's payload ("shard") or scales
        ("scale"): verify while loading, one read."""
        arr = _load(os.path.join(self.dir, self.meta["dir"],
                                 f"{kind}_{i:06d}.npy"))
        key = "crc32" if kind == "shard" else "scale_crc32"
        if _crc(arr) != self.meta[key][i]:
            raise IOError(f"checksum mismatch for {kind} {i}")
        return arr

    def load_into(self, store, mutated: list | None = None):
        meta = self.meta
        if meta["shard_rows"] != store.shard_rows or meta["m"] != store.m:
            raise CheckpointError(
                f"tiered shard geometry mismatch: checkpoint has "
                f"{meta['num_shards']}x{meta['shard_rows']}x{meta['m']}, "
                f"store is {store.num_shards}x{store.shard_rows}x{store.m}"
            )
        if meta["num_shards"] > store.num_shards:
            raise CheckpointError(
                f"cannot shrink: checkpoint has {meta['num_shards']} "
                f"shards, store only {store.num_shards} — restore into a "
                f"table of at least the checkpoint's size"
            )
        if store.num_shards % meta["num_shards"]:
            raise CheckpointError(
                f"grow-on-restore needs the store's {store.num_shards} "
                f"shards to be a multiple of the checkpoint's "
                f"{meta['num_shards']}"
            )
        for i in range(meta["num_shards"]):
            # may raise: mark the mutation first.  load_shard converts
            # between quantized and dense payloads as needed
            arr = self._read("shard", i)
            scale = self._read("scale", i) if self.quant != "none" else None
            if mutated is not None and store not in mutated:
                mutated.append(store)
            store.load_shard(i, arr, scale)
            # grow-on-restore: appended shards alias their coarse-lattice
            # parent shard (j mod old_N; shard_rows divides old_N)
            for j in range(i + meta["num_shards"], store.num_shards,
                           meta["num_shards"]):
                store.load_shard(j, arr, scale)
        return store

    def materialize(self) -> np.ndarray:
        """Concatenate shards into a dense host table (restore-into-dense);
        quantized checkpoints are dequantized to fp32 on the way out."""
        meta = self.meta
        quantized = self.quant != "none"
        out = np.empty(
            (meta["num_shards"] * meta["shard_rows"], meta["m"]),
            np.float32 if quantized else np.dtype(meta["dtype"]),
        )
        r = meta["shard_rows"]
        for i in range(meta["num_shards"]):
            arr = self._read("shard", i)
            if quantized:
                arr = quant.dequantize_rows_np(arr, self._read("scale", i))
            out[i * r:(i + 1) * r] = arr
        return out


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None  # of the async write
        # one record a save ({"op": "save", "step", "snapshot_ms",
        # "write_ms", "bytes"}, the write's filled in when it ends) and a
        # restore ({"op": "restore", "step", "ms"})
        self.history: list[dict] = []

    # ---------------- save ----------------

    def save(self, step: int, tree, *, blocking: bool = True,
             sharding: dict | None = None) -> None:
        """Checkpoint `tree` as step `step`.  With `sharding` ({leaf name:
        (mesh, axis)}) or in any run of several ranks every rank calls
        this: the named leaves are gathered over their axis, and only
        rank 0 writes."""
        t0 = time.perf_counter()
        sharding = sharding or {}
        writer = not dist.is_initialized() or dist.get_rank() == 0
        # copy to host memory now: the live tensors change in place
        host, stores = [], []
        for name, leaf in _tree_items(tree):
            if lookup.is_store(leaf):
                stores.append((name, leaf))
            elif name in sharding:  # a collective: every rank, in order
                arr, dtype = _host_copy(leaf)
                arr = mesh_rows.gather_rows(arr, *sharding[name])
                if writer:
                    host.append((name, arr, dtype))
            elif writer:
                host.append((name, *_host_copy(leaf)))
        record = {"op": "save", "step": step,
                  "snapshot_ms": 1e3 * (time.perf_counter() - t0)}
        self.history.append(record)
        if not writer:
            return
        self.wait()  # one writer at a time (async or blocking)
        if blocking or stores:  # shard streaming reads live store state
            self._write(step, host, stores, record)
        else:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, stores, record),
                daemon=True)
            self._thread.start()

    def _write_async(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def wait(self) -> None:
        """Wait for the pending asynchronous write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _write(self, step: int, host_items, store_items, record) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:012d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for name, arr, dtype in host_items:
            fn = _mangle(name)
            _save(os.path.join(tmp, fn), arr, dtype == _FP8)
            manifest["leaves"][name] = {
                "file": fn, "shape": list(arr.shape), "dtype": dtype,
                "crc32": _crc(arr),
            }
        seen: dict[int, str] = {}
        for name, store in store_items:
            if id(store) in seen:  # params + optimizer share the store
                manifest["leaves"][name] = {
                    "kind": "tiered_ref", "ref": seen[id(store)]
                }
                continue
            seen[id(store)] = name
            store.flush()
            sub = _mangle(name) + ".shards"
            os.makedirs(os.path.join(tmp, sub))
            quantized = store.quant != "none"
            crcs, scale_crcs = [], []
            for i in range(store.num_shards):  # streamed, one at a time
                arr = store.shard_host(i)
                _save(os.path.join(tmp, sub, f"shard_{i:06d}.npy"), arr,
                      store.quant == "fp8")
                crcs.append(_crc(arr))
                if quantized:  # per-row fp32 scales ride beside it
                    s = store.shard_scale_host(i)
                    np.save(os.path.join(tmp, sub, f"scale_{i:06d}.npy"), s)
                    scale_crcs.append(_crc(s))
            manifest["leaves"][name] = {
                "kind": "tiered",
                "dir": sub,
                "num_shards": store.num_shards,
                "shard_rows": store.shard_rows,
                "m": store.m,
                "dtype": "float32",  # the rows' logical dtype
                "crc32": crcs,
            }
            if quantized:
                manifest["leaves"][name]["quant"] = store.quant
                manifest["leaves"][name]["scale_crc32"] = scale_crcs
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        record["bytes"] = sum(os.path.getsize(os.path.join(d, f))
                              for d, _, fs in os.walk(tmp) for f in fs)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        record["write_ms"] = 1e3 * (time.perf_counter() - t0)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(
                os.path.join(self.dir, f"step_{s:012d}"), ignore_errors=True
            )

    # ---------------- restore ----------------

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.removeprefix("step_")))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_dir(self, step: int):
        d = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        out, refs = {}, {}
        for name, meta in manifest["leaves"].items():
            kind = meta.get("kind", "array")
            if kind == "tiered":
                # shards are checksummed while streaming into the target in
                # restore(): a corrupt shard raises there, inside the same
                # newest-first fallback loop (no second read of the table)
                out[name] = _TieredLeaf(d, meta)
            elif kind == "tiered_ref":
                refs[name] = meta["ref"]
            else:
                arr = _load(os.path.join(d, meta["file"]))
                if _crc(arr) != meta["crc32"]:
                    raise IOError(
                        f"checksum mismatch for {name} at step {step}"
                    )
                out[name] = arr
        for name, target in refs.items():
            out[name] = out[target]
        return out

    def restore(self, like, *, step: int | None = None,
                sharding: dict | None = None):
        """Restore into the structure of `like` (a tree of arrays, tensors,
        meta tensors or stores: a leaf gives the shape and dtype).  Tries
        newest-first until a valid checkpoint loads.  Returns (step, tree)
        with numpy leaves (fp8 payloads as uint8 bytes) and every store
        loaded in place, or (None, None) if nothing restorable.

        `sharding` ({leaf name: (mesh, axis)}, the reference's elastic
        re-placement) names the leaves of which this rank keeps its rows:
        `like` gives their global shape, the leaf is restored whole and
        this rank's rows [i * R, (i + 1) * R) of it are returned.  Every
        other leaf restores whole.  No collective: each rank reads the
        checkpoint itself.

        Tiered shards are checksummed *while* streaming into the target
        store (single read); a corrupt shard aborts that attempt and falls
        back to the next-newest checkpoint, whose load overwrites every
        shard again.  If every candidate fails AFTER a live store was
        partially overwritten, restore raises instead of returning
        (None, None): training on a half-loaded table is worse than
        stopping.
        """
        t0 = time.perf_counter()
        steps = [step] if step is not None else self.all_steps()[::-1]
        mutated: list = []
        for s in steps:
            try:
                tree = self._assemble(like, self._load_dir(s), s, mutated,
                                      sharding or {})
            except (_StructureMismatch, CheckpointError):
                raise  # `like` does not match the checkpoint: caller error
            except Exception:  # missing, corrupt or a malformed manifest
                continue
            self.history.append({"op": "restore", "step": s,
                                 "ms": 1e3 * (time.perf_counter() - t0)})
            return s, tree
        if mutated:
            raise IOError(
                "no valid checkpoint found, and a tiered value store was "
                "partially overwritten during failed restore attempts — "
                "re-initialize it before training"
            )
        return None, None

    def _assemble(self, like, data, found, mutated=None, sharding=None):
        items = _tree_items(like)
        missing = [n for n, _ in items if n not in data]
        if missing:
            raise _StructureMismatch(
                f"checkpoint at step {found} missing: {missing[:5]}"
            )
        leaves = []
        loaded: set[int] = set()
        for name, proto in items:
            arr = data[name]
            if lookup.is_store(proto):
                if id(proto) not in loaded:
                    loaded.add(id(proto))
                    if isinstance(arr, _TieredLeaf):
                        arr.load_into(proto, mutated)  # streamed, in place
                    else:  # dense checkpoint -> tiered store
                        if mutated is not None and proto not in mutated:
                            mutated.append(proto)
                        # the proto IS a store: a memory table whatever
                        # its path
                        proto.load_dense(_reconcile_rows(
                            name, np.asarray(arr),
                            (proto.num_rows, proto.m), is_table=True,
                        ))
                leaves.append(proto)
                continue
            if isinstance(arr, _TieredLeaf):  # tiered checkpoint -> dense
                arr = arr.materialize()
            shape = getattr(proto, "shape", None)
            if shape is not None and tuple(arr.shape) != tuple(shape):
                arr = _reconcile_rows(name, np.asarray(arr), tuple(shape))
            want = _numpy_dtype(getattr(proto, "dtype", None))
            if want is not None and arr.dtype != want:
                arr = arr.astype(want)
            if sharding and name in sharding:
                arr = mesh_rows.own_rows(arr, *sharding[name])
            leaves.append(arr)
        return _rebuild(like, iter(leaves))


def _numpy_dtype(dtype) -> np.dtype | None:
    """The numpy dtype a restored leaf takes for a proto's dtype (None:
    keep the file's; an fp8 proto keeps its uint8 bytes)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        if dtype == torch.float8_e4m3fn:
            return np.dtype(np.uint8)
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def _is_lram_table_path(name: str) -> bool:
    """Does this leaf path name an LRAM value table?  Matches
    `…/lram/values` (and a QuantizedTable's `…/lram/values/<child>`) plus
    the bare `values` of a layer-level param dict — NOT `pkm/values` or
    other coincidental `values` leaves, whose rows carry no
    lattice-parent structure to alias-grow by."""
    parts = name.split("/")
    if parts and parts[-1].isdigit():
        parts = parts[:-1]
    if parts[-1:] != ["values"]:
        return False
    return len(parts) == 1 or parts[-2] == "lram"


def _reconcile_rows(name: str, arr: np.ndarray, want: tuple, *,
                    is_table: bool | None = None) -> np.ndarray:
    """Reconcile a checkpoint leaf against a differently-sized target.

    Memory-table leaves (the fp32 table, a quantized payload, or its
    per-row scales — all row-major over N) grow-on-restore by the alias
    rule `j mod old_N` (tiling): a smaller checkpoint warm-starts a larger
    table.  Everything else — shrinks, non-multiple sizes, non-table
    leaves — raises a clear `CheckpointError` instead of handing back a
    silently mis-shaped leaf.
    """
    if tuple(arr.shape) == tuple(want):
        return arr
    if is_table is None:
        is_table = _is_lram_table_path(name)
    rows_compatible = (
        is_table
        and len(want) == arr.ndim
        and tuple(arr.shape[1:]) == tuple(want[1:])
    )
    if rows_compatible and want[0] > arr.shape[0] \
            and want[0] % arr.shape[0] == 0:
        reps = (want[0] // arr.shape[0],) + (1,) * (arr.ndim - 1)
        return np.tile(arr, reps)
    if rows_compatible and want[0] < arr.shape[0]:
        raise CheckpointError(
            f"cannot shrink {name}: checkpoint has {arr.shape[0]} rows, "
            f"target {want[0]} — restore into a table of at least the "
            f"checkpoint's size"
        )
    raise CheckpointError(
        f"shape mismatch for {name}: checkpoint {tuple(arr.shape)} vs "
        f"target {tuple(want)}"
    )
