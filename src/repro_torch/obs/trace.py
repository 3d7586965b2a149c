"""Span tracer: parent-linked wall-time spans with attached metric deltas
(torch counterpart of `repro.obs.trace`).

    with obs.span("serve.decode_tick", tick=7):
        ...

Spans form a stack a thread: a span opened inside another records the
outer span's id as its parent, so an exported trace rebuilds the call
tree (run -> admit -> prefill, run -> decode tick, ...).  On exit each
span carries:

* its wall time (a `perf_counter` delta),
* the user's attributes (the keyword arguments),
* **metric deltas**: the change in every registry *counter* over the
  span's life, nonzero entries only.  A `serve.decode_tick` span thus
  shows how many store fills, hits and bytes that one tick cost, without
  the instrumented layers knowing of each other.

A disabled tracer's `span()` is one shared no-op context manager (one
dict lookup, no allocation), the registry's off-is-free rule.

`profile_dir` arms `torch.profiler`: a span entered with `profile=True`
runs under `torch.profiler.profile` (the outermost such span only: the
profiler is process-wide), with CPU activities always and CUDA
activities once the process has initialised CUDA (a model on the card).
On exit the trace is written into `profile_dir` as a Chrome / Perfetto
JSON trace, `<span name>.<span id>.<pid>.pt.trace.json`, and the span's
attribute `profile_trace` names the file.  A profiler that cannot start
raises out of the span (the reference records the span without a
profile then).  The reference writes `jax.profiler`'s XLA trace instead:
neither package reads the other's profile.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Callable

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.obs.registry import MetricsRegistry


@dataclasses.dataclass
class Span:
    """One finished (or open) span."""

    name: str
    span_id: int
    parent_id: int | None
    t0_s: float                      # process-relative (perf_counter)
    attrs: dict[str, Any]
    dur_s: float | None = None
    metrics: dict[str, float] = dataclasses.field(default_factory=dict)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def to_event(self) -> dict[str, Any]:
        """The JSONL `span` event (`repro_torch.obs.export.validate_event`)."""
        return {
            "kind": "span",
            "name": self.name,
            "id": self.span_id,
            "parent": self.parent_id,
            "t0_s": round(self.t0_s, 6),
            "dur_s": round(self.dur_s or 0.0, 6),
            "attrs": self.attrs,
            "metrics": {k: round(v, 6) for k, v in self.metrics.items()},
        }


class _NullSpan:
    """What a disabled tracer yields: attribute writes vanish."""

    __slots__ = ()

    def set_attr(self, key: str, value: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


@contextlib.contextmanager
def _null_ctx():
    yield _NULL_SPAN


def _profiler(path: str):
    """`torch.profiler.profile` over CPU (and CUDA, where the process uses
    a card) activities that writes its Chrome trace to `path` on exit."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=lambda prof: prof.export_chrome_trace(path))


class Tracer:
    """A process's tracer over a `MetricsRegistry` (for counter deltas).

    `on_finish` (set by `obs.configure`) streams each finished span to the
    JSONL exporter; finished spans are also kept in a bounded list
    (`finished`, at most `max_spans`; `dropped` counts the rest) for
    reports and tests.
    """

    def __init__(self, registry: MetricsRegistry | None = None, *,
                 enabled: bool = True, max_spans: int = 100_000,
                 profile_dir: str | None = None,
                 on_finish: Callable[[Span], None] | None = None):
        self.enabled = enabled
        self.registry = registry
        self.max_spans = max_spans
        self.profile_dir = profile_dir
        self.on_finish = on_finish
        self.finished: list[Span] = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._profiling = False  # a profiled span is open

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, *, profile: bool = False, **attrs):
        """Open a span; yields the `Span` (set late attributes on it)."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        sp = Span(
            name=name, span_id=next(self._ids), parent_id=parent,
            t0_s=time.perf_counter(), attrs=dict(attrs),
        )
        before = (self.registry.counter_values()
                  if self.registry is not None else {})
        stack.append(sp)
        profiler_ctx = contextlib.nullcontext()
        started_profile = False
        if profile and self.profile_dir and not self._profiling:
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(
                self.profile_dir,
                f"{name}.{sp.span_id}.{os.getpid()}.pt.trace.json")
            profiler_ctx = _profiler(path)
            sp.attrs["profile_trace"] = path
            self._profiling = started_profile = True
        try:
            with profiler_ctx:
                yield sp
        finally:
            if started_profile:
                self._profiling = False
            stack.pop()
            sp.dur_s = time.perf_counter() - sp.t0_s
            if self.registry is not None:
                after = self.registry.counter_values()
                sp.metrics = {
                    k: after[k] - before.get(k, 0.0)
                    for k in after
                    if after[k] - before.get(k, 0.0) != 0.0
                }
            with self._lock:
                if len(self.finished) < self.max_spans:
                    self.finished.append(sp)
                else:
                    self.dropped += 1
            if self.on_finish is not None:
                self.on_finish(sp)

    def span_count(self) -> int:
        with self._lock:
            return len(self.finished) + self.dropped


class _NullTracer:
    """The disabled tracer: `span()` returns a shared no-op context."""

    enabled = False
    finished: list[Span] = []
    dropped = 0

    def span(self, name: str, **attrs):
        return _null_ctx()

    def span_count(self) -> int:
        return 0


NULL_TRACER = _NullTracer()
