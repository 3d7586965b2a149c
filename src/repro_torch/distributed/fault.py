"""Fault-tolerance runtime pieces: heartbeats, stragglers, failure
injection (the port's own copy of `repro.distributed.fault`, which is
plain Python).

The train driver wires them in: `--simulate-failure-at` raises
`SimulatedFailure` before that step (a relaunch resumes from the latest
valid checkpoint), and a step slower than twice the running median is
tagged `STRAGGLER` on its log line.
"""

from __future__ import annotations

import dataclasses
import time


class SimulatedFailure(RuntimeError):
    """Raised by the train driver to simulate a node crash."""


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-host step heartbeats; flags missing or straggling hosts.

    EWMA of per-host step durations; a host is a *straggler* when its EWMA
    exceeds `straggler_factor` x the fleet median, and *dead* when no
    heartbeat arrives within `timeout_s`.
    """

    num_hosts: int
    straggler_factor: float = 1.5
    timeout_s: float = 60.0
    alpha: float = 0.3

    def __post_init__(self):
        self._ewma: dict[int, float] = {}
        self._last_seen: dict[int, float] = {}

    def heartbeat(self, host: int, step_duration: float,
                  now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        prev = self._ewma.get(host)
        self._ewma[host] = (
            step_duration if prev is None
            else self.alpha * step_duration + (1 - self.alpha) * prev
        )
        self._last_seen[host] = now

    def fleet_median(self) -> float:
        vals = sorted(self._ewma.values())
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def stragglers(self) -> list[int]:
        med = self.fleet_median()
        if med <= 0:
            return []
        return sorted(
            h for h, v in self._ewma.items()
            if v > self.straggler_factor * med
        )

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        seen = set(self._last_seen)
        missing = [h for h in range(self.num_hosts) if h not in seen]
        timed_out = [
            h for h, t in self._last_seen.items()
            if now - t > self.timeout_s
        ]
        return sorted(missing + timed_out)

    def healthy(self, now: float | None = None) -> bool:
        return not self.dead_hosts(now)


@dataclasses.dataclass
class StepTimer:
    """Per-step wall-time stats with outlier (straggler-step) detection."""

    window: int = 50

    def __post_init__(self):
        self.durations: list[float] = []

    def record(self, seconds: float) -> None:
        self.durations.append(seconds)
        if len(self.durations) > self.window:
            self.durations.pop(0)

    def median(self) -> float:
        s = sorted(self.durations)
        return s[len(s) // 2] if s else 0.0

    def is_outlier(self, seconds: float, factor: float = 2.0) -> bool:
        med = self.median()
        return med > 0 and seconds > factor * med
