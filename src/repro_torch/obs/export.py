"""Exporters: an append-only JSONL event log and a Prometheus textfile
snapshot (torch counterpart of `repro.obs.export`: the same schema, the
same files, so each package reads and validates the other's).

Two sinks, one schema (`validate_event`):

* **JSONL** (`JsonlExporter`) — one JSON object per line, streamed as
  events happen (spans on finish, lifecycle events as they fire, metric
  snapshots at flush), so a crashed run still leaves a readable log.
  Event kinds:

    {"kind": "span",    "name", "id", "parent", "t0_s", "dur_s",
                        "attrs": {...}, "metrics": {...}}
    {"kind": "event",   "name", "t_s", "attrs": {...}}
    {"kind": "metrics", "t_s", "metrics": {name: snapshot, ...}}

* **Prometheus textfile** (`write_prometheus`) — the node-exporter
  textfile-collector format: the whole registry as `# TYPE`-annotated
  families, dots rewritten to underscores, histograms in cumulative
  `_bucket{le=...}` form.  Written at flush/exit (a snapshot, not a
  stream): point a textfile collector at `--metrics-dir` and the run's
  final state scrapes like any other exporter.

`metrics_doc` / `validate_metrics_doc` define the summary document's
`metrics` field (`EngineReport.summary`, the serve CLI's `--json`): the
schema id, the enabled flag, the span count and the whole registry
snapshot.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Any

from repro_torch.obs.registry import MetricsRegistry

METRICS_SCHEMA = "repro.obs.v1"
EVENT_KINDS = ("span", "event", "metrics")

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_.]*$")


def _check_num(doc: dict, key: str, ctx: str) -> None:
    v = doc.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)) \
            or not math.isfinite(v):
        raise ValueError(f"{ctx}: {key!r} must be a finite number, got {v!r}")


def validate_event(doc: Any) -> None:
    """Assert `doc` is a well-formed JSONL event; raises ValueError."""
    if not isinstance(doc, dict):
        raise ValueError(f"event must be an object, got {type(doc)}")
    kind = doc.get("kind")
    if kind not in EVENT_KINDS:
        raise ValueError(f"event kind must be one of {EVENT_KINDS}, "
                         f"got {kind!r}")
    if kind in ("span", "event"):
        name = doc.get("name")
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ValueError(f"{kind} event: bad name {name!r}")
        attrs = doc.get("attrs", {})
        if not isinstance(attrs, dict):
            raise ValueError(f"{kind} event {name}: attrs must be an object")
    if kind == "span":
        _check_num(doc, "t0_s", f"span {doc.get('name')}")
        _check_num(doc, "dur_s", f"span {doc.get('name')}")
        if doc.get("dur_s") < 0:
            raise ValueError(f"span {doc.get('name')}: negative dur_s")
        if not isinstance(doc.get("id"), int):
            raise ValueError(f"span {doc.get('name')}: id must be an int")
        parent = doc.get("parent")
        if parent is not None and not isinstance(parent, int):
            raise ValueError(
                f"span {doc.get('name')}: parent must be an int or null"
            )
        metrics = doc.get("metrics", {})
        if not isinstance(metrics, dict) or not all(
            isinstance(k, str) and isinstance(v, (int, float))
            and not isinstance(v, bool) and math.isfinite(v)
            for k, v in metrics.items()
        ):
            raise ValueError(f"span {doc.get('name')}: bad metrics map")
    if kind == "event":
        _check_num(doc, "t_s", f"event {doc.get('name')}")
    if kind == "metrics":
        _check_num(doc, "t_s", "metrics event")
        _validate_snapshot(doc.get("metrics"))


def _validate_snapshot(metrics: Any) -> None:
    if not isinstance(metrics, dict):
        raise ValueError("metrics snapshot must be an object")
    for name, m in metrics.items():
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ValueError(f"metrics snapshot: bad metric name {name!r}")
        if not isinstance(m, dict):
            raise ValueError(f"metric {name}: snapshot must be an object")
        kind = m.get("kind")
        if kind in ("counter", "gauge"):
            _check_num(m, "value", f"metric {name}")
        elif kind == "histogram":
            buckets, counts = m.get("buckets"), m.get("counts")
            if not (isinstance(buckets, list) and isinstance(counts, list)
                    and len(counts) == len(buckets) + 1
                    and all(isinstance(c, int) and c >= 0 for c in counts)):
                raise ValueError(f"histogram {name}: bad buckets/counts")
            _check_num(m, "sum", f"histogram {name}")
        else:
            raise ValueError(f"metric {name}: unknown kind {kind!r}")


def validate_metrics_doc(doc: Any) -> None:
    """Assert `doc` is a summary document's `metrics` field; raises
    ValueError."""
    if not isinstance(doc, dict):
        raise ValueError(f"metrics doc must be an object, got {type(doc)}")
    if doc.get("schema") != METRICS_SCHEMA:
        raise ValueError(
            f"metrics doc schema must be {METRICS_SCHEMA!r}, "
            f"got {doc.get('schema')!r}"
        )
    if not isinstance(doc.get("enabled"), bool):
        raise ValueError("metrics doc: 'enabled' must be a bool")
    if not isinstance(doc.get("spans"), int) or doc["spans"] < 0:
        raise ValueError("metrics doc: 'spans' must be a non-negative int")
    _validate_snapshot(doc.get("metrics"))


def metrics_doc(registry: MetricsRegistry, *, spans: int = 0) -> dict:
    """The summary-document `metrics` field for this registry's state."""
    return {
        "schema": METRICS_SCHEMA,
        "enabled": registry.enabled,
        "spans": spans,
        "metrics": registry.snapshot(),
    }


class JsonlExporter:
    """Append-only JSONL event sink (validated, flushed per event)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def write(self, doc: dict) -> None:
        validate_event(doc)
        line = json.dumps(doc, sort_keys=True)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def write_span(self, span) -> None:
        self.write(span.to_event())

    def write_event(self, name: str, **attrs) -> None:
        self.write({
            "kind": "event", "name": name,
            "t_s": round(time.perf_counter(), 6), "attrs": attrs,
        })

    def write_snapshot(self, registry: MetricsRegistry) -> None:
        self.write({
            "kind": "metrics", "t_s": round(time.perf_counter(), 6),
            "metrics": registry.snapshot(),
        })

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_jsonl(path: str) -> list[dict]:
    """Load and re-validate a JSONL event log (tests, analysis)."""
    events = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            try:
                validate_event(doc)
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: {e}") from None
            events.append(doc)
    return events


# ---------------------------------------------------------------------------
# Prometheus textfile snapshot
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    return "repro_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """The whole registry in Prometheus text exposition format."""
    out: list[str] = []
    for m in registry.metrics():
        pname = _prom_name(m.name)
        if m.help:
            out.append(f"# HELP {pname} {m.help}")
        out.append(f"# TYPE {pname} {m.kind}")
        snap = m.snapshot()
        if m.kind in ("counter", "gauge"):
            suffix = "_total" if m.kind == "counter" else ""
            out.append(f"{pname}{suffix} {_prom_num(snap['value'])}")
        else:  # histogram: cumulative le buckets + sum + count
            cum = 0
            for bound, c in zip(snap["buckets"] + [math.inf],
                                snap["counts"]):
                cum += c
                out.append(
                    f'{pname}_bucket{{le="{_prom_num(bound)}"}} {cum}'
                )
            out.append(f"{pname}_sum {_prom_num(snap['sum'])}")
            out.append(f"{pname}_count {snap['count']}")
    return "\n".join(out) + ("\n" if out else "")


_PROM_LINE_RE = re.compile(
    r"^(#\s(HELP|TYPE)\s[a-zA-Z_][a-zA-Z0-9_]*(\s.*)?"
    r"|[a-zA-Z_][a-zA-Z0-9_]*(\{le=\"[^\"]+\"\})?\s\S+)$"
)


def validate_prometheus_text(text: str) -> None:
    """Line-level sanity check of the exposition format (tests)."""
    for i, line in enumerate(text.splitlines()):
        if line and not _PROM_LINE_RE.match(line):
            raise ValueError(f"prometheus text line {i + 1} invalid: "
                             f"{line!r}")


def write_prometheus(registry: MetricsRegistry, path: str) -> None:
    text = prometheus_text(registry)
    validate_prometheus_text(text)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
