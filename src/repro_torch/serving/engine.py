"""Continuous-batching serve engine over fixed-shape decode slots (torch
counterpart of `repro.serving.engine`).

The engine owns a slotted KV cache (`transformer.init_cache` with the
batch axis as a pool of `slots` sequences) and runs one decode step per
tick over the whole pool:

  * **admit** — a ready request is prefilled at batch=1, its prompt padded
    up to a power-of-two bucket as the reference does, and its sub-cache
    copied into a free slot.  Padded positions are harmless: decode writes
    its KV row at the current position before attending, and the mask only
    exposes positions <= the slot's depth.
  * **step** — one `transformer.decode_step` with a per-slot position
    vector; free slots ride along (token 0 at a frozen position) and their
    outputs are dropped.  Greedy argmax picks the next token.
  * **retire** — a slot whose request reaches its budget or the cache end
    is marked free; the next admission overwrites its cache rows.

`continuous` admits into any free slot every tick; `static` admits only
when every slot is free (gang admission).  The KV cache is updated IN
PLACE (decode writes its row, admission copies into the slot); the
reference donates and replaces the cache instead.

Tiered memory: when the model's lookup plan `supports_prefetch`, the
engine collects the model's tiered stores (a `ShardedTieredStore` as one:
its warm and prefetch reach every range), warms them and resets their
stats at the start of `run`, attributes each prefill's and each tick's
hit / miss / uncached deltas to the requests in flight, and calls
`prefetch_last()` after every tick.  Prefill lookups count every position
of the padded bucket, as the reference's traced path does.  Not ported
yet: per-tenant overlays, the memory controller and the observability
spans.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import lookup
from repro_torch.models import transformer
from repro_torch.serving.requests import Request, RequestQueue

_STAT_KEYS = ("hits", "misses", "uncached")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine shape: pool size and per-slot sequence budget."""

    slots: int = 4
    max_len: int = 64           # per-slot cache length (prompt + generation)
    mode: str = "continuous"    # continuous | static (gang admission)

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("need at least one slot")
        if self.mode not in ("continuous", "static"):
            raise ValueError(f"unknown mode {self.mode!r}")


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
        return [
            [f"{prefix}_prefill", round(med_prefill, 3),
             f"n={len(self.prefill_s)}"],
            [f"{prefix}_decode_step", round(med_step, 3),
             f"p50_ms={self.p50_ms():.3f} p99_ms={self.p99_ms():.3f} {hit}"],
            [f"{prefix}_token", round(us_per_tok, 3),
             f"tokens_per_sec={self.tokens_per_sec:.1f} "
             f"requests={len(self.requests)} mode={self.mode}"],
        ]

    def summary(self, arch: str) -> dict[str, Any]:
        """The `--json` summary document."""
        return {
            "arch": arch,
            "mode": self.mode,
            "rows": self.rows(),
            "per_step_ms": [round(1e3 * s, 3) for s in self.step_s],
            "decode_median_ms": round(1e3 * _percentile(self.step_s, 50), 2),
            "p50_ms": round(self.p50_ms(), 3),
            "p99_ms": round(self.p99_ms(), 3),
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "generated_tokens": self.generated_tokens,
            "cache": self.cache,
            "requests": [r.summary() for r in self.requests],
        }


class ServeEngine:
    """Slot-pool serving engine (see the module docstring)."""

    def __init__(self, model: transformer.Transformer,
                 engine_cfg: EngineConfig):
        cfg = model.cfg
        if cfg.objective != "clm":
            raise ValueError("serving requires a causal-LM arch")
        self.model = model.eval()
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.device = model.embed.embedding.device
        self._axes = transformer.cache_batch_axes(cfg, engine_cfg.max_len)
        self.cache = transformer.init_cache(
            cfg, engine_cfg.slots, engine_cfg.max_len, self.device
        )
        # prefetch handles come from the plan's capability flag
        self.stores = (
            lookup.find_stores(model)
            if any(p.supports_prefetch for p in lookup.model_plans(cfg))
            else []
        )

    @torch.inference_mode()
    def warmup(self) -> None:
        """Prefill once at every prompt bucket and run one decode tick, so
        the first call of each shape (library kernel choice, allocator
        growth) falls outside a timed `run`.  The cache rows it writes are
        overwritten by the next admission into each slot."""
        cap = self.engine_cfg.max_len
        for bucket in sorted({_bucket(s, cap) for s in range(1, cap)}):
            transformer.prefill(self.model, torch.zeros(
                (1, bucket), dtype=torch.long, device=self.device), cap)
        B = self.engine_cfg.slots
        transformer.decode_step(
            self.model, torch.zeros((B, 1), dtype=torch.long,
                                    device=self.device),
            torch.zeros((B,), dtype=torch.long, device=self.device),
            self.cache,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit(self, req: Request, now: float) -> tuple[_Slot, Any]:
        """Prefill one request at batch=1 (bucketed prompt)."""
        s = req.prompt_len
        if self.engine_cfg.max_len - s < 1:
            raise ValueError(
                f"request {req.id}: prompt ({s}) leaves no room to "
                f"generate within max_len={self.engine_cfg.max_len}"
            )
        bucket = _bucket(s, self.engine_cfg.max_len)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :s] = req.prompt
        t0 = time.perf_counter()
        logits, sub_cache = transformer.prefill(
            self.model, torch.from_numpy(tokens).to(self.device),
            self.engine_cfg.max_len,
        )
        first_logits = logits[0, s - 1].cpu().numpy()
        prefill_s = time.perf_counter() - t0
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
        """Replay a request trace to completion and report."""
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
        generated = 0
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
                    slot, sub_cache = self._admit(req, now)
                    transformer.write_cache_slot(self.cache, sub_cache, b,
                                                 self._axes)
                    prefill_s.append(slot.prefill_s)
                    generated += 1  # the first token comes from the prefill
                    # the prefill's stat deltas belong to this request
                    prev_stats = self._attribute([slot], prev_stats)
                    now = time.perf_counter() - t0
                    if self._done(slot):  # 1-token budget: no decode steps
                        finished.append(self._finish(slot, now))
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
            t_step = time.perf_counter()
            logits = transformer.decode_step(
                self.model, torch.from_numpy(tok_buf).to(self.device),
                torch.from_numpy(pos_buf).to(self.device), self.cache,
            )
            next_tok = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            step_s.append(time.perf_counter() - t_step)

            if self.stores:
                prev_stats = self._attribute([slots[b] for b in active],
                                             prev_stats)
                # the union of the active sequences' accesses turns most
                # recently used and its overflowed shards get another fill;
                # the copies go up with the next lookup's stacked sync
                for _, store in self.stores:
                    store.prefetch_last()

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
                    finished.append(self._finish(sl, now))
                    slots[b] = None

        finished.sort(key=lambda r: r.id)
        return EngineReport(
            mode=self.engine_cfg.mode,
            wall_s=time.perf_counter() - t0,
            generated_tokens=generated,
            step_s=step_s,
            prefill_s=prefill_s,
            requests=finished,
            cache=self._cache_summary(),
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
