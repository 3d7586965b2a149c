"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms
(torch counterpart of `repro.obs.registry`).

Three rules shape the design, as in the reference:

1. **Disabled means free.**  A disabled registry hands every caller the
   same null metric, whose mutators are empty methods: call sites
   instrument unconditionally (`obs.counter("x").inc()`), and the off path
   costs one dict lookup and one no-op call, with no device work.
2. **Host metrics are thread-safe.**  Store fills run on the sharded
   store's prefetch threads, so every mutator takes the metric's lock.
   Snapshots are consistent a metric, not across metrics.
3. **Device-side accumulation drains at boundaries.**  The helpers
   `accum_init` / `accum_add` / `hist_bucket_add` keep counts in a tensor
   on the device (the `memctl.telemetry_update` pattern: one `index_add_`)
   and return a new tensor, as the reference's pure functions do; the
   caller drains it into the host registry at a step or tick boundary
   (`Histogram.merge_counts`, `Counter.inc`).

Metric names are dotted (`serve.decode_step_s`, `memstore.fill_bytes`);
the Prometheus exporter rewrites dots to underscores.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Sequence

import torch

# log-ish spaced seconds: 100 us .. 10 s, the default latency buckets
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Counter:
    """Monotonically increasing value (`.inc`)."""

    __slots__ = ("name", "help", "_value", "_lock")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        with self._lock:
            self._value += v

    def get(self) -> float:
        return self._value

    def snapshot(self) -> dict[str, Any]:
        return {"kind": self.kind, "value": self._value}


class Gauge:
    """Last-write-wins value (`.set` / `.add`)."""

    __slots__ = ("name", "help", "_value", "_lock")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += float(v)

    def get(self) -> float:
        return self._value

    def snapshot(self) -> dict[str, Any]:
        return {"kind": self.kind, "value": self._value}


class Histogram:
    """Fixed-bucket histogram: counts a bucket, a +Inf overflow, the sum."""

    __slots__ = ("name", "help", "bounds", "_counts", "_sum", "_lock")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name}: buckets must be non-empty and "
                f"strictly increasing, got {bounds}"
            )
        self.name = name
        self.help = help
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # the last is +Inf
        self._sum = 0.0
        self._lock = threading.Lock()

    def _bucket(self, v: float) -> int:
        # the first bound >= v (cumulative `le` semantics, as Prometheus)
        for i, b in enumerate(self.bounds):
            if v <= b:
                return i
        return len(self.bounds)

    def observe(self, v: float) -> None:
        i = self._bucket(float(v))
        with self._lock:
            self._counts[i] += 1
            self._sum += float(v)

    def merge_counts(self, counts, total: float = 0.0) -> None:
        """Drain a device-side accumulator (a `hist_bucket_add` tensor, or
        any count vector of len(bounds) + 1) into this histogram; `total`
        adds to the running sum (the values' sum, where the caller kept
        it)."""
        if isinstance(counts, torch.Tensor):
            counts = counts.detach().cpu().tolist()
        counts = [int(c) for c in counts]
        if len(counts) != len(self._counts):
            raise ValueError(
                f"histogram {self.name}: expected {len(self._counts)} "
                f"bucket counts, got {len(counts)}"
            )
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += float(total)

    @property
    def count(self) -> int:
        return sum(self._counts)

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """The bucket upper bound that estimates the q-quantile (0..1)."""
        total = self.count
        if not total:
            return 0.0
        rank = q * total
        acc = 0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= rank:
                return (self.bounds[i] if i < len(self.bounds)
                        else math.inf)
        return math.inf

    def snapshot(self) -> dict[str, Any]:
        return {
            "kind": self.kind,
            "buckets": list(self.bounds),
            "counts": list(self._counts),
            "sum": self._sum,
            "count": self.count,
        }


class _NullMetric:
    """The shared do-nothing metric a disabled registry hands out."""

    __slots__ = ()
    name = "<disabled>"
    help = ""
    bounds = LATENCY_BUCKETS_S
    count = 0
    sum = 0.0

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def merge_counts(self, counts, total: float = 0.0) -> None:
        pass

    def get(self) -> float:
        return 0.0

    def quantile(self, q: float) -> float:
        return 0.0


NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Name -> metric map.  `enabled=False` is the hard off switch: every
    factory returns `NULL_METRIC` and `snapshot()` is empty."""

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kw):
        if not self.enabled:
            return NULL_METRIC
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_create(name, Histogram, help=help,
                                   buckets=buckets)

    def metrics(self) -> list[Any]:
        with self._lock:
            return list(self._metrics.values())

    def counter_values(self) -> dict[str, float]:
        """The counters' current totals (the span tracer's deltas)."""
        with self._lock:
            return {n: m.get() for n, m in self._metrics.items()
                    if isinstance(m, Counter)}

    def snapshot(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            items = list(self._metrics.items())
        return {n: m.snapshot() for n, m in items}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# device-side accumulators (drained at host boundaries)
# ---------------------------------------------------------------------------

def accum_init(bins: int, device=None) -> torch.Tensor:
    """A zeroed float32 scatter-add accumulator of `bins` slots."""
    return torch.zeros(bins, dtype=torch.float32, device=device)


def _checked_flat(acc: torch.Tensor, idx) -> torch.Tensor:
    flat = torch.as_tensor(idx, device=acc.device).reshape(-1).long()
    # JAX wraps a negative index and drops one past the end; here both
    # raise (a device-side index assert would end the CUDA context)
    if flat.numel() and not bool(((flat >= 0)
                                  & (flat < acc.shape[0])).all()):
        raise IndexError(
            f"accumulator of {acc.shape[0]} slots: index out of range "
            f"(min {int(flat.min())}, max {int(flat.max())})")
    return flat


def accum_add(acc: torch.Tensor, idx, w=None) -> torch.Tensor:
    """One observation step, a new tensor: `acc` with 1 (or the matching
    `w`) added at every index of `idx`.  The reference's counts for
    indices in [0, len(acc)); any other index raises IndexError (the
    reference drops it).  Reads the indices' range on the host."""
    flat = _checked_flat(acc, idx)
    if w is None:
        src = torch.ones(flat.shape, dtype=acc.dtype, device=acc.device)
    else:
        src = torch.as_tensor(w, device=acc.device).reshape(-1).to(
            acc.dtype)
    return acc.clone().index_add_(0, flat, src)


def hist_bucket_add(acc: torch.Tensor, values,
                    bounds: Sequence[float]) -> torch.Tensor:
    """A histogram step on the device, a new tensor: bucket `values` by
    `bounds` (cumulative `le` semantics: the first bound >= v, as
    `jnp.searchsorted(side="left")`) and add one a value into `acc`,
    which has len(bounds) + 1 slots (`accum_init(len(bounds) + 1)`).
    Drain with `Histogram.merge_counts(acc)`."""
    if acc.shape != (len(bounds) + 1,):
        raise ValueError(f"a histogram of {len(bounds)} bounds needs "
                         f"{len(bounds) + 1} slots, got {tuple(acc.shape)}")
    v = torch.as_tensor(values, device=acc.device).reshape(-1).float()
    b = torch.bucketize(v, torch.tensor(bounds, dtype=torch.float32,
                                        device=acc.device), right=False)
    return acc.clone().index_add_(
        0, b, torch.ones(b.shape, dtype=acc.dtype, device=acc.device))
