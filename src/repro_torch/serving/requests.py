"""Requests, arrival traces, and the admission queue for the serve engine
(the port's own copy of `repro.serving.requests`, which is numpy only).

A `Request` is one generation job: a prompt, a generation budget, and an
arrival time.  `synthetic_trace` builds the mixed-length open-loop traces
the benchmarks replay (Poisson arrivals at a configurable offered load;
`rate=0` degenerates to the closed-loop "everything queued at t=0" case
tests use).  `RequestQueue` is the engine-facing view: requests become
*ready* when the engine clock passes their arrival time, in arrival order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request (prompt tokens + decode budget)."""

    id: int
    prompt: np.ndarray          # (S,) int32 token ids, S >= 1
    max_new_tokens: int         # number of tokens to generate (>= 1)
    arrival_s: float = 0.0      # seconds since trace start
    tenant_id: str | None = None  # per-tenant memory overlay key
    #                               (None = anonymous: base table only)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.id}: max_new_tokens must be >=1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)


def synthetic_trace(
    rng: np.random.Generator,
    num_requests: int,
    *,
    vocab_size: int,
    max_prompt: int,
    max_gen: int,
    rate: float = 0.0,
    mixed: bool = True,
    tenants: int = 0,
) -> list[Request]:
    """Mixed-length request trace with Poisson arrivals.

    `mixed=True` draws prompt lengths uniformly from [1, max_prompt] and
    generation budgets from [1, max_gen] — the head-of-line-blocking regime
    where continuous batching beats the fixed-batch loop.  `mixed=False`
    pins every request to (max_prompt, max_gen), reproducing the legacy
    fixed-shape workload.  `rate` is the offered load in requests/second;
    0 means every request is queued at t=0 (closed loop).  `tenants > 0`
    assigns each request a random tenant id from a pool of that size
    (``"t0".."t{n-1}"``) for the per-tenant memory overlays; 0 keeps the
    trace anonymous (and draws no extra random numbers, so existing
    seeded traces are unchanged).
    """
    reqs = []
    t = 0.0
    for i in range(num_requests):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        s = int(rng.integers(1, max_prompt + 1)) if mixed else max_prompt
        g = int(rng.integers(1, max_gen + 1)) if mixed else max_gen
        tenant = f"t{int(rng.integers(0, tenants))}" if tenants > 0 else None
        reqs.append(Request(
            id=i,
            prompt=rng.integers(0, vocab_size, size=(s,)).astype(np.int32),
            max_new_tokens=g,
            arrival_s=t,
            tenant_id=tenant,
        ))
    return reqs


class RequestQueue:
    """Arrival-ordered admission queue driven by the engine clock."""

    def __init__(self, requests: list[Request] = ()):  # noqa: B006 - tuple
        self._pending: list[Request] = sorted(
            requests, key=lambda r: (r.arrival_s, r.id)
        )

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, request: Request) -> None:
        """Insert keeping arrival order (the real-entrypoint hook)."""
        self._pending.append(request)
        self._pending.sort(key=lambda r: (r.arrival_s, r.id))

    def next_arrival(self) -> float | None:
        """Arrival time of the earliest pending request (None if empty)."""
        return self._pending[0].arrival_s if self._pending else None

    def num_ready(self, now: float) -> int:
        return sum(1 for r in self._pending if r.arrival_s <= now)

    def pop_ready(self, now: float) -> Request | None:
        """Earliest request that has arrived by `now`, or None."""
        if self._pending and self._pending[0].arrival_s <= now:
            return self._pending.pop(0)
        return None
