"""Continuous-batching serve engine over fixed-shape decode slots (torch
counterpart of `repro.serving.engine`).

The engine owns a slotted KV cache (`transformer.init_cache` with the
batch axis as a pool of `slots` sequences) and runs one decode step per
tick over the whole pool:

  * **admit** — a ready request is prefilled at batch=1, its prompt padded
    up to a power-of-two bucket as the reference does, and its sub-cache
    copied into a free slot.  Padded positions are harmless: decode writes
    its KV row at the current position before attending, and the mask only
    exposes positions <= the slot's depth.  A sliding-window model and an
    SSM prefill at the prompt's exact length instead, as the reference's:
    a ring keeps the last `window` positions of what was prefilled, all
    valid once the ring is full, and a recurrent state integrates every
    position, so pad rows there could not be masked.
  * **step** — one `transformer.decode_step` with a per-slot position
    vector; free slots ride along (token 0 at a frozen position) and their
    outputs are dropped.  Greedy argmax picks the next token.
  * **retire** — a slot whose request reaches its budget or the cache end
    is marked free; the next admission overwrites its cache rows.

The enc-dec and VLM families are refused, as the reference's engine
refuses them (their entry points are `transformer.prefill` /
`decode_step` with the batch extras).  A hybrid is served as an SSM is
(exact-length prefills; the decode tick advances the state and conv
window of every unit's Mamba layers beside the shared block's K/V).

`continuous` admits into any free slot every tick; `static` admits only
when every slot is free (gang admission).  The KV cache is updated IN
PLACE (decode writes its row, admission copies into the slot); the
reference donates and replaces the cache instead.

**The decode tick as one CUDA graph** (the port's form of the reference's
one jitted decode step): on a card, in `continuous` mode, with
`EngineConfig.cuda_graph` and every lookup plan `supports_graph` (the
dense ``pallas`` cells: no host work in the forward), `decode_step` and
the argmax are captured once, after torch's warm-up iterations on a side
stream, over static token and position buffers the tick fills by
`copy_`; each tick replays it.  The capture happens in `warmup()` or on
the first tick after a (re)binding; `swap_model` drops it.  A capture
that fails fails the run.  Under a graph a wrapper's launch counter
moves at capture only: the counts a capture made are taken back and
added again on every replay, so the counters still count launches.
Tiered placements run eagerly (their lookups map shards on the host).

**Lifecycle**: a `controller` (`repro_torch.memctl.MemoryController`)
runs between decode ticks (`on_tick`); it may migrate the model's tables
and call `swap_model`, which re-binds the stores and the graph while the
slots and the KV cache carry every request in flight.  `ticks` counts
decode ticks since construction (the policy's clock).

Tiered memory: when the model's lookup plan `supports_prefetch`, the
engine collects the model's tiered stores (a `ShardedTieredStore` as one:
its warm and prefetch reach every range), warms them and resets their
stats at the start of `run`, attributes each prefill's and each tick's
hit / miss / uncached deltas to the requests in flight, and calls
`prefetch_last()` after every tick.  Prefill lookups count every position
of the padded bucket, as the reference's traced path does.

**Per-tenant overlays** (`EngineConfig.overlay_rows` > 0, a plan that
`supports_overlay`): an `OverlayManager` (`repro_torch.serving.overlay`)
binds each request's tenant to its slot before the prefill (which reads
the slot's pack slice) and releases it at retirement; every decode tick
runs under `repro_torch.core.overlay.activate(..., collect=True)`, and
after it the tick's (idx, w, y) are written back into each active
slot's tenant on the host and the packs refresh.  Under the CUDA graph
the packs and the recorded accesses are static device buffers: the packs
are copied in before every replay, outside the capture, and the accesses
read back after it, so attaching, detaching and writing back never
capture again (`graph_captures` stays 1).  A tick under overlays that
cannot be captured fails the run, as any capture does.  The base rows
the deltas diff against are read through `lookup.read_rows_fp32` for a
store and from a host copy of a device table taken once a binding;
`swap_model` binds the reader again.

**Observability** (`repro_torch.obs`, the reference's points and names):
`run` is one `serve.run` span (profiled under `--profile-dir`), each
admission a `serve.admit` span holding its `serve.prefill`, each tick a
`serve.decode_tick` span around `_decode` and its tokens' read-back (the
overlays' write-back after it is outside), each retirement a
`serve.retire` span; the counters `serve.tokens`, `serve.admitted`,
`serve.retired` and `serve.overlay_writebacks`, the histograms
`serve.prefill_s`, `serve.decode_step_s` and `serve.request_latency_s`.
The stores' `memstore.*` counters land on the span that caused them.
Under the decode graph a tick's span wraps the replay on the host: no
obs call runs inside a capture, so one capture serves obs on and off and
the launch counters count the same launches.  The summary's `metrics`
is `obs.metrics_doc()`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any

import numpy as np
import torch

from repro_torch import kernels, obs, quant
from repro_torch.core import lookup, overlay
from repro_torch.core.lram import LRAM
from repro_torch.models import transformer
from repro_torch.serving.overlay import OverlayManager
from repro_torch.serving.requests import Request, RequestQueue

_STAT_KEYS = ("hits", "misses", "uncached")
_GRAPH_WARMUP = 3  # eager ticks on a side stream before a capture
# cache leaves a decode tick advances (the state and conv window of an
# SSM's or a hybrid's Mamba layers);
# the KV leaves it writes get the same row however often it runs
_STATE_LEAVES = ("ssm", "conv")


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """The one side stream of a device for every warm-up and capture: each
    new stream gets a cuBLAS workspace of its own (32 MiB on an H100) that
    stays allocated for the life of the process."""
    return torch.cuda.Stream(device)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine shape: pool size and per-slot sequence budget."""

    slots: int = 4
    max_len: int = 64           # per-slot cache length (prompt + generation)
    mode: str = "continuous"    # continuous | static (gang admission)
    cuda_graph: bool = True     # decode tick as one CUDA graph, where the
    #                             plans allow it (False: the eager twin)
    # per-tenant memory overlays (repro_torch.serving.overlay): rows a slot
    # a memory layer; 0 turns the subsystem off
    overlay_rows: int = 0
    overlay_write_lr: float = 0.1   # the decode tick's Hebbian write rate

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("need at least one slot")
        if self.mode not in ("continuous", "static"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.overlay_rows < 0:
            raise ValueError("overlay_rows must be >= 0")


@dataclasses.dataclass
class _Slot:
    """Host-side state of one in-flight sequence."""

    request: Request
    pos: int                    # absolute position of the next decode write
    generated: list[int]
    admit_s: float
    prefill_s: float
    first_logits: np.ndarray    # (V,) logits of the first generated token
    stats: dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(_STAT_KEYS, 0)
    )
    decode_steps: int = 0


def _bucket(n: int, cap: int) -> int:
    """Round a prompt length up to its power-of-two bucket."""
    return min(1 << (n - 1).bit_length(), cap)


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclasses.dataclass
class FinishedRequest:
    """Per-request serving record (the report's `requests` entries)."""

    id: int
    prompt_len: int
    tokens: list[int]
    admit_s: float
    finish_s: float
    prefill_s: float
    decode_steps: int
    cache_hit_rate: float | None
    first_logits: np.ndarray | None = None   # (V,) — equivalence testing

    def summary(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "prompt_len": self.prompt_len,
            "generated": len(self.tokens),
            "admit_s": round(self.admit_s, 4),
            "finish_s": round(self.finish_s, 4),
            "latency_s": round(self.finish_s - self.admit_s, 4),
            "prefill_ms": round(1e3 * self.prefill_s, 3),
            "decode_steps": self.decode_steps,
            "cache_hit_rate": self.cache_hit_rate,
        }


@dataclasses.dataclass
class EngineReport:
    """Aggregate result of one trace replay."""

    mode: str
    wall_s: float
    generated_tokens: int
    step_s: list[float]
    prefill_s: list[float]
    requests: list[FinishedRequest]
    cache: dict[str, Any] | None = None   # tiered-store stats
    cuda_graph: bool = False    # the last binding's ticks replay a graph
    graph_captures: int = 0     # captures since the engine was built
    graph_ticks: int = 0        # ticks of this run replayed from a graph
    overlay: dict[str, Any] | None = None   # OverlayManager.summary()
    overlay_s: list[float] = dataclasses.field(default_factory=list)
    #                             a tick's host write-back into the overlays

    @property
    def tokens_per_sec(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s else 0.0

    def p50_ms(self) -> float:
        return 1e3 * _percentile(self.step_s, 50)

    def p99_ms(self) -> float:
        return 1e3 * _percentile(self.step_s, 99)

    def rows(self, prefix: str = "serve") -> list[list[Any]]:
        """Benchmark-harness rows: [name, us_per_call, derived]."""
        med_prefill = 1e6 * _percentile(self.prefill_s, 50)
        med_step = 1e6 * _percentile(self.step_s, 50)
        us_per_tok = (1e6 * self.wall_s / self.generated_tokens
                      if self.generated_tokens else 0.0)
        hit = (f"hit={self.cache['hit_rate']}" if self.cache else "dense")
        rows = [
            [f"{prefix}_prefill", round(med_prefill, 3),
             f"n={len(self.prefill_s)}"],
            [f"{prefix}_decode_step", round(med_step, 3),
             f"p50_ms={self.p50_ms():.3f} p99_ms={self.p99_ms():.3f} {hit}"],
            [f"{prefix}_token", round(us_per_tok, 3),
             f"tokens_per_sec={self.tokens_per_sec:.1f} "
             f"requests={len(self.requests)} mode={self.mode}"],
        ]
        if self.overlay:
            o = self.overlay
            rows.append([
                f"{prefix}_overlay", 0.0,
                f"tenants={o['tenants']} hit_rate={o['hit_rate']} "
                f"bytes_per_tenant={o['bytes_per_tenant']} "
                f"writebacks={o['writebacks']}",
            ])
        return rows

    def summary(self, arch: str) -> dict[str, Any]:
        """The `--json` summary document."""
        return {
            "arch": arch,
            "mode": self.mode,
            "metrics": obs.metrics_doc(),
            "rows": self.rows(),
            "per_step_ms": [round(1e3 * s, 3) for s in self.step_s],
            "decode_median_ms": round(1e3 * _percentile(self.step_s, 50), 2),
            "p50_ms": round(self.p50_ms(), 3),
            "p99_ms": round(self.p99_ms(), 3),
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "generated_tokens": self.generated_tokens,
            "cache": self.cache,
            "cuda_graph": self.cuda_graph,
            "graph_captures": self.graph_captures,
            "graph_ticks": self.graph_ticks,
            "overlay": self.overlay,
            "overlay_writeback_ms": [round(1e3 * s, 3)
                                     for s in self.overlay_s],
            "requests": [r.summary() for r in self.requests],
        }


class ServeEngine:
    """Slot-pool serving engine (see the module docstring)."""

    def __init__(self, model: transformer.Transformer,
                 engine_cfg: EngineConfig, *, controller=None):
        cfg = model.cfg
        if cfg.objective != "clm":
            raise ValueError("serving requires a causal-LM arch")
        if cfg.family in ("encdec", "vlm"):
            raise ValueError(
                f"continuous batching supports decoder-only families; "
                f"{cfg.name} is {cfg.family}")
        self.engine_cfg = engine_cfg
        self.controller = controller
        self.ticks = 0  # decode ticks since construction (policy clock)
        self.graph_captures = 0
        device, B = model.embed.embedding.device, engine_cfg.slots
        self._axes = transformer.cache_batch_axes(cfg, engine_cfg.max_len)
        self.cache = transformer.init_cache(cfg, B, engine_cfg.max_len,
                                            device)
        # the decode graph's static inputs, filled by copy_ each tick
        self._tok = torch.zeros((B, 1), dtype=torch.long, device=device)
        self._pos = torch.zeros((B,), dtype=torch.long, device=device)
        # per-tenant overlays, checked against the plan's capability flag
        self.overlays: OverlayManager | None = None
        self._packs = None  # the packs on the device: the graph's inputs
        self._access = None  # the last tick's (idx, w, y) on the host
        if engine_cfg.overlay_rows > 0:
            plans = lookup.model_plans(cfg)
            if not plans:
                raise ValueError(f"overlay_rows needs a memory arch; "
                                 f"{cfg.name} has no LRAM layer")
            if not plans[0].supports_overlay:
                raise ValueError(f"lookup plan {plans[0].cell} does not "
                                 f"support per-tenant overlays")
            self.overlays = OverlayManager(
                num_layers=len(cfg.lram_layers), m=cfg.lram.m,
                storage=plans[0].storage, slots=B,
                rows=engine_cfg.overlay_rows,
                write_lr=engine_cfg.overlay_write_lr)
            self._packs = (torch.from_numpy(self.overlays.ids).to(device),
                           torch.from_numpy(self.overlays.deltas).to(device))
        self.swap_model(model)

    def swap_model(self, model: transformer.Transformer) -> None:
        """(Re)bind the engine to `model` (after a live migration, its own
        model with new tables and config): the stores it prefetches and
        the decode graph, dropped here and captured again on the next
        tick where the new plans allow it.  The slots and the KV cache
        are untouched (their shapes depend on the engine config alone),
        so requests in flight resume on the next tick."""
        self.model = model.eval()
        self.cfg = model.cfg
        self.device = model.embed.embedding.device
        plans = lookup.model_plans(self.cfg)
        # prefetch handles come from the plan's capability flag
        self.stores = (lookup.find_stores(model)
                       if any(p.supports_prefetch for p in plans) else [])
        self._graph = None
        self.use_graph = (self.engine_cfg.cuda_graph
                          and self.device.type == "cuda"
                          and self.engine_cfg.mode == "continuous"
                          and all(p.supports_graph for p in plans))
        if self.overlays is not None:
            self._bind_overlay_reader()

    def _bind_overlay_reader(self) -> None:
        """Point the overlay manager at the model's base tables now (on
        every binding, so a live migration keeps the deltas against
        wherever the rows live): a store is read through its host tier,
        a device table from a host copy taken once a binding."""
        tables = [m.values for m in self.model.modules()
                  if isinstance(m, LRAM)]
        host: dict[int, Any] = {}

        def read(layer: int, rows) -> np.ndarray:
            table = tables[layer]
            rows = np.asarray(rows, np.int64).reshape(-1)
            if lookup.is_store(table):
                return lookup.read_rows_fp32(table, rows)
            cached = host.get(layer)
            if cached is None:
                cached = host[layer] = (
                    lookup.host_quantized(table)
                    if isinstance(table, quant.QuantizedTable)
                    else table.detach().float().cpu().numpy())
            if isinstance(cached, tuple):
                return quant.dequantize_rows_np(cached[0][rows],
                                                cached[1][rows])
            return cached[rows]

        self.overlays.set_base_reader(read)

    def prefill_len(self, prompt_len: int) -> int:
        """The length a prompt is prefilled at: its power-of-two bucket,
        or its exact length for an SSM, a hybrid or a sliding-window
        model."""
        if self.cfg.family in ("ssm", "hybrid") or self.cfg.attention == "swa":
            return prompt_len
        return _bucket(prompt_len, self.engine_cfg.max_len)

    def _step(self, tok: torch.Tensor, pos: torch.Tensor, packs):
        """`decode_step` over the pool: (logits, the stacked (idx, w, y)
        of every memory layer under the overlay packs, or None without
        them)."""
        if packs is None:
            return transformer.decode_step(self.model, tok, pos,
                                           self.cache), None
        with overlay.activate(*packs, collect=True) as octx:
            logits = transformer.decode_step(self.model, tok, pos,
                                             self.cache)
            return logits, octx.stacked()

    def _upload_packs(self) -> None:
        """Copy the manager's packs into their device buffers, which the
        model reads (the decode graph among them; outside any capture)."""
        for dev, host in zip(self._packs, (self.overlays.ids,
                                           self.overlays.deltas)):
            dev.copy_(torch.from_numpy(host))

    def _capture(self) -> None:
        """Capture `decode_step` (under the overlay packs' device buffers,
        where the engine has overlays) and the argmax over the static
        buffers as one CUDA graph (the buffers hold this tick's inputs, or
        zeros: the warm-up ticks write each slot's KV row at its own
        position, as the tick itself then does).  The warm-up ticks would
        also advance an SSM's state and conv window, which the replay that
        follows advances once more: those leaves are put back as they
        were."""
        held = [(leaf, leaf.clone()) for leaves in self.cache.values()
                for k, leaf in leaves.items() if k in _STATE_LEAVES]
        stream = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(_GRAPH_WARMUP):
                self._step(self._tok, self._pos, self._packs)
        stream.wait_stream(side)
        for leaf, kept in held:
            leaf.copy_(kept)
        del held
        counters = kernels.launch_counters()
        before = {name: fn.launches for name, fn in counters.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            logits, access = self._step(self._tok, self._pos, self._packs)
            next_tok = torch.argmax(logits[:, -1], dim=-1)
        # what the capture counted was recorded, not launched: take it
        # back, and add it on every replay
        self._graph_launches = {}
        for name, fn in counters.items():
            if fn.launches != before[name]:
                self._graph_launches[fn] = fn.launches - before[name]
                fn.launches = before[name]
        self._graph, self._logits, self._next = graph, logits, next_tok
        self._graph_access = access
        self.graph_captures += 1

    def _decode(self, tok_buf: np.ndarray, pos_buf: np.ndarray):
        """One decode tick over the pool: (logits (B, 1, V) on the device,
        next tokens (B,) on the host), replayed from the graph where the
        binding allows it, else eager.  Under overlays the tick's (idx, w,
        y) land in `_access`, on the host."""
        if self.overlays is not None:
            self._upload_packs()
        if not self.use_graph:
            logits, access = self._step(
                torch.from_numpy(tok_buf).to(self.device),
                torch.from_numpy(pos_buf).to(self.device), self._packs)
            next_tok = torch.argmax(logits[:, -1], dim=-1)
        else:
            self._tok.copy_(torch.from_numpy(tok_buf))
            self._pos.copy_(torch.from_numpy(pos_buf))
            if self._graph is None:
                self._capture()
            self._graph.replay()
            for fn, n in self._graph_launches.items():
                fn.launches += n
            logits, next_tok, access = (self._logits, self._next,
                                        self._graph_access)
        if access is not None:
            self._access = tuple(a.cpu().numpy() for a in access)
        return logits, next_tok.cpu().numpy()

    @torch.inference_mode()
    def warmup(self, prompt_lens) -> None:
        """Prefill once at every length the prompts of `prompt_lens` (a
        trace's prompt lengths) are prefilled at (`prefill_len`: their
        buckets, or an SSM's or a sliding window's exact lengths) and run
        one decode tick, so the first call of each shape (library kernel choice,
        allocator growth) falls outside a timed `run`, and capture the
        decode graph where the binding uses one.  The cache rows it
        writes are overwritten by the next admission into each slot."""
        cap = self.engine_cfg.max_len
        for n in sorted({self.prefill_len(s) for s in prompt_lens}):
            transformer.prefill(self.model, torch.zeros(
                (1, n), dtype=torch.long, device=self.device), cap)
        B = self.engine_cfg.slots
        self._step(torch.zeros((B, 1), dtype=torch.long, device=self.device),
                   torch.zeros((B,), dtype=torch.long, device=self.device),
                   self._packs)
        if self.use_graph and self._graph is None:
            self._tok.zero_()
            self._pos.zero_()
            if self.overlays is not None:
                self._upload_packs()
            self._capture()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self, req: Request, now: float,
               slot: int) -> tuple[_Slot, Any]:
        """Prefill one request at batch=1 (at `prefill_len`) for `slot`;
        under overlays the request's tenant is attached to the slot first,
        so the prompt reads through the tenant's rows already."""
        s = req.prompt_len
        if self.engine_cfg.max_len - s < 1:
            raise ValueError(
                f"request {req.id}: prompt ({s}) leaves no room to "
                f"generate within max_len={self.engine_cfg.max_len}"
            )
        bucket = self.prefill_len(s)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :s] = req.prompt
        t0 = time.perf_counter()
        with obs.span("serve.prefill", request=req.id, prompt_len=s,
                      bucket=bucket):
            ctx = contextlib.nullcontext()
            if self.overlays is not None:
                self.overlays.attach(slot, req.tenant_id, tick=self.ticks)
                self._upload_packs()
                ctx = overlay.activate(*(p[:, slot:slot + 1]
                                         for p in self._packs))
            with ctx:
                logits, sub_cache = transformer.prefill(
                    self.model, torch.from_numpy(tokens).to(self.device),
                    self.engine_cfg.max_len,
                )
            first_logits = logits[0, s - 1].float().cpu().numpy()
        prefill_s = time.perf_counter() - t0
        obs.counter("serve.admitted").inc()
        obs.histogram("serve.prefill_s").observe(prefill_s)
        return _Slot(
            request=req, pos=s, generated=[int(np.argmax(first_logits))],
            admit_s=now, prefill_s=prefill_s, first_logits=first_logits,
        ), sub_cache

    def _store_stats(self) -> dict[str, int]:
        out = dict.fromkeys(_STAT_KEYS, 0)
        for _, store in self.stores:
            for k in _STAT_KEYS:
                out[k] += store.stats[k]
        return out

    def _attribute(self, slots: list[_Slot], prev: dict[str, int]
                   ) -> dict[str, int]:
        """Add the store-stat deltas since `prev` to every slot in
        `slots` (shared-batch attribution); returns the new totals."""
        cur = self._store_stats()
        for sl in slots:
            for k in _STAT_KEYS:
                sl.stats[k] += cur[k] - prev[k]
        return cur

    def _cache_summary(self) -> dict[str, Any] | None:
        if not self.stores:
            return None
        agg = dict.fromkeys(
            ("hits", "misses", "uncached", "fills", "evictions"), 0)
        for _, store in self.stores:
            for k in agg:
                agg[k] += store.stats[k]
        return {
            "hit_rate": round(float(np.mean(
                [s.hit_rate() for _, s in self.stores])), 4),
            **agg,
        }

    def _finish(self, slot: _Slot, now: float) -> FinishedRequest:
        total = sum(slot.stats.values())
        obs.counter("serve.retired").inc()
        obs.histogram("serve.request_latency_s").observe(now - slot.admit_s)
        if not self.stores:
            hit_rate = None
        else:
            hit_rate = (round(slot.stats["hits"] / total, 4) if total
                        else 0.0)
        return FinishedRequest(
            id=slot.request.id,
            prompt_len=slot.request.prompt_len,
            tokens=slot.generated,
            admit_s=slot.admit_s,
            finish_s=now,
            prefill_s=slot.prefill_s,
            decode_steps=slot.decode_steps,
            cache_hit_rate=hit_rate,
            first_logits=slot.first_logits,
        )

    def _done(self, slot: _Slot) -> bool:
        return (len(slot.generated) >= slot.request.max_new_tokens
                or slot.pos >= self.engine_cfg.max_len)

    @torch.inference_mode()
    def run(self, requests: list[Request]) -> EngineReport:
        """Replay a request trace to completion and report, under one
        `serve.run` span (a `torch.profiler` trace where `--profile-dir`
        armed the tracer)."""
        with obs.span("serve.run", profile=True,
                      mode=self.engine_cfg.mode, requests=len(requests)):
            return self._run(requests)

    def _run(self, requests: list[Request]) -> EngineReport:
        B = self.engine_cfg.slots
        static = self.engine_cfg.mode == "static"
        queue = RequestQueue(requests)
        for _, store in self.stores:
            store.warm()
            store.reset_stats()
        prev_stats = self._store_stats()
        slots: list[_Slot | None] = [None] * B
        tok_buf = np.zeros((B, 1), np.int64)
        pos_buf = np.zeros((B,), np.int64)
        step_s: list[float] = []
        prefill_s: list[float] = []
        finished: list[FinishedRequest] = []
        overlay_s: list[float] = []
        generated = 0
        graph_ticks = 0
        t0 = time.perf_counter()

        while True:
            now = time.perf_counter() - t0
            # -- admission (static mode gates on a fully drained pool)
            if not static or all(sl is None for sl in slots):
                for b in range(B):
                    if slots[b] is not None:
                        continue
                    req = queue.pop_ready(now)
                    if req is None:
                        break
                    with obs.span("serve.admit", request=req.id, slot=b,
                                  tick=self.ticks):
                        slot, sub_cache = self._admit(req, now, b)
                        transformer.write_cache_slot(self.cache, sub_cache,
                                                     b, self._axes)
                    prefill_s.append(slot.prefill_s)
                    generated += 1  # the first token comes from the prefill
                    # the prefill's stat deltas belong to this request
                    prev_stats = self._attribute([slot], prev_stats)
                    now = time.perf_counter() - t0
                    if self._done(slot):  # 1-token budget: no decode steps
                        finished.append(self._finish(slot, now))
                        if self.overlays is not None:
                            self.overlays.detach(b)
                        continue
                    slots[b] = slot
                    tok_buf[b, 0] = slot.generated[-1]
                    pos_buf[b] = slot.pos

            active = [b for b in range(B) if slots[b] is not None]
            if not active:
                nxt = queue.next_arrival()
                if nxt is None:
                    break  # drained
                time.sleep(max(0.0, nxt - (time.perf_counter() - t0)))
                continue

            # -- one fixed-shape decode tick over the whole pool
            graph_ticks += self.use_graph
            with obs.span("serve.decode_tick", tick=self.ticks,
                          active=len(active)):
                # timed inside the span: its exit writes the tick's event,
                # which is the exporter's cost, not the tick's
                t_step = time.perf_counter()
                _, next_tok = self._decode(tok_buf, pos_buf)
                dt_step = time.perf_counter() - t_step
            step_s.append(dt_step)
            obs.histogram("serve.decode_step_s").observe(dt_step)
            obs.counter("serve.tokens").inc(len(active))
            self.ticks += 1

            # the decode tick's write-back: this tick's lattice accesses
            # folded into each active slot's tenant (the packs refresh on
            # the host and reach the device with the next tick)
            if self.overlays is not None:
                t_ov = time.perf_counter()
                idx_a, w_a, y_a = self._access
                for b in active:
                    self.overlays.writeback(b, idx_a[:, b, 0], w_a[:, b, 0],
                                            y_a[:, b, 0], tick=self.ticks)
                overlay_s.append(time.perf_counter() - t_ov)
                obs.counter("serve.overlay_writebacks").inc(len(active))

            if self.stores:
                prev_stats = self._attribute([slots[b] for b in active],
                                             prev_stats)
                # the union of the active sequences' accesses turns most
                # recently used and its overflowed shards get another fill;
                # the copies go up with the next lookup's stacked sync
                for _, store in self.stores:
                    store.prefetch_last()

            # the lifecycle hook: the controller may swap the model between
            # ticks (spill a dense table to the tiered store); the slots in
            # flight ride through untouched
            if self.controller is not None and self.controller.on_tick(self):
                prev_stats = self._store_stats()

            now = time.perf_counter() - t0
            for b in active:
                sl = slots[b]
                sl.generated.append(int(next_tok[b]))
                sl.pos += 1
                sl.decode_steps += 1
                generated += 1
                tok_buf[b, 0] = int(next_tok[b])
                pos_buf[b] = sl.pos
                if self._done(sl):
                    with obs.span("serve.retire", request=sl.request.id,
                                  slot=b, tick=self.ticks):
                        finished.append(self._finish(sl, now))
                        slots[b] = None
                        if self.overlays is not None:
                            self.overlays.detach(b)  # retiring frees it

        finished.sort(key=lambda r: r.id)
        return EngineReport(
            mode=self.engine_cfg.mode,
            wall_s=time.perf_counter() - t0,
            generated_tokens=generated,
            step_s=step_s,
            prefill_s=prefill_s,
            requests=finished,
            cache=self._cache_summary(),
            cuda_graph=self.use_graph,
            graph_captures=self.graph_captures,
            graph_ticks=graph_ticks,
            overlay=(self.overlays.summary()
                     if self.overlays is not None else None),
            overlay_s=overlay_s,
        )


def serve_requests(model: transformer.Transformer, requests: list[Request],
                   *, slots: int = 4, max_len: int | None = None,
                   mode: str = "continuous") -> EngineReport:
    """One-shot convenience: build an engine sized for `requests`, run it."""
    if max_len is None:
        max_len = max(r.prompt_len + r.max_new_tokens for r in requests)
    engine = ServeEngine(model,
                         EngineConfig(slots=slots, max_len=max_len, mode=mode))
    return engine.run(requests)
