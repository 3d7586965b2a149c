"""Observability: metrics registry, span tracer, exporters (torch
counterpart of `repro.obs`).

The measurement layer the serve engine, the tiered stores, the lifecycle
controller and both CLIs instrument against:

* `registry`: the process's `MetricsRegistry` (counters, gauges,
  fixed-bucket histograms; `repro_torch.obs.registry` also holds the
  device-side accumulators drained at step or tick boundaries).
* `trace`: `Tracer` / `Span`, parent-linked wall-time spans carrying the
  counters' deltas, and `torch.profiler` traces of marked spans.
* `export`: the append-only JSONL event log and the Prometheus textfile,
  both validated, in the reference's schema (`repro.obs.v1`); `metrics_doc`
  is the summary document's `metrics` field.

**Off by default, and off is free**: until `configure()` runs, every
`counter()` / `gauge()` / `histogram()` returns one shared null metric and
`span()` one shared null context, host-side no-ops: the same tokens,
losses and kernel launches as without them (`tests/test_torch_obs.py`).
The CLIs arm it with `--metrics-dir` (and `--profile-dir` for
`torch.profiler` traces of marked spans).

Call sites fetch through the module, so a late `configure()` takes
effect:

    from repro_torch import obs
    obs.counter("memstore.fills").inc()
    with obs.span("serve.decode_tick", tick=t):
        ...
"""

from __future__ import annotations

import os
import threading

from repro_torch.obs import export as export  # noqa: F401
from repro_torch.obs.export import (  # noqa: F401
    JsonlExporter,
    metrics_doc as _metrics_doc,
    prometheus_text,
    read_jsonl,
    validate_event,
    validate_metrics_doc,
    write_prometheus,
)
from repro_torch.obs.registry import (  # noqa: F401
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    NULL_METRIC,
    accum_add,
    accum_init,
    hist_bucket_add,
)
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer  # noqa: F401

_lock = threading.Lock()
_registry = MetricsRegistry(enabled=False)
_tracer = NULL_TRACER
_exporter: JsonlExporter | None = None
_metrics_dir: str | None = None

JSONL_NAME = "metrics.jsonl"
PROM_NAME = "metrics.prom"


def registry() -> MetricsRegistry:
    """The process's registry (disabled until `configure()`)."""
    return _registry


def tracer():
    return _tracer


def enabled() -> bool:
    return _registry.enabled


def counter(name: str, help: str = ""):
    return _registry.counter(name, help)


def gauge(name: str, help: str = ""):
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets=LATENCY_BUCKETS_S):
    return _registry.histogram(name, help, buckets)


def span(name: str, **attrs):
    """Open a span on the process's tracer (a no-op until configured)."""
    return _tracer.span(name, **attrs)


def emit_event(name: str, **attrs) -> None:
    """Write a lifecycle event to the JSONL log (dropped without one)."""
    if _exporter is not None:
        _exporter.write_event(name, **attrs)


def configure(*, metrics_dir: str | None = None,
              profile_dir: str | None = None,
              enabled: bool = True) -> MetricsRegistry:
    """Arm (or re-arm) the process's observability state, with a fresh
    registry.

    `metrics_dir` turns the exporters on: spans go to
    `<dir>/metrics.jsonl` as they finish, and `flush()` (the CLIs call it
    at the end) appends a snapshot of the registry there and writes the
    Prometheus textfile `<dir>/metrics.prom`.  Without it the registry
    and tracer still run in memory (reports, tests).  `profile_dir` arms
    `torch.profiler` traces of `span(..., profile=True)`.
    """
    global _registry, _tracer, _exporter, _metrics_dir
    with _lock:
        if _exporter is not None:
            _exporter.close()
        _registry = MetricsRegistry(enabled=enabled)
        _exporter = None
        _metrics_dir = None
        if not enabled:
            _tracer = NULL_TRACER
            return _registry
        on_finish = None
        if metrics_dir is not None:
            os.makedirs(metrics_dir, exist_ok=True)
            _metrics_dir = metrics_dir
            _exporter = JsonlExporter(os.path.join(metrics_dir, JSONL_NAME))
            on_finish = _exporter.write_span
        _tracer = Tracer(_registry, profile_dir=profile_dir,
                         on_finish=on_finish)
        return _registry


def disable() -> None:
    """Back to the free default (idempotent; closes the JSONL file)."""
    configure(enabled=False)


def flush() -> None:
    """Write the registry to the exporters: one `metrics` JSONL snapshot
    event and the Prometheus textfile.  Safe to call again (each flush
    appends a snapshot and rewrites the textfile)."""
    with _lock:
        if _exporter is not None:
            _exporter.write_snapshot(_registry)
        if _metrics_dir is not None:
            write_prometheus(_registry,
                             os.path.join(_metrics_dir, PROM_NAME))


def metrics_doc() -> dict:
    """The summary document's `metrics` field for the current state."""
    return _metrics_doc(_registry, spans=_tracer.span_count())
