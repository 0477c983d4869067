"""Fault-tolerance runtime: heartbeats, straggler detection, restart policy.

A copy of the reference ``runtime/monitor.py`` (pure Python, behaviour
unchanged), so that the port imports nothing of the reference package.

At 1000+ nodes the dominant failures are (a) a host dying (no heartbeat),
(b) a straggler stretching every synchronous step, (c) transient device
errors.  The monitor is deliberately simple and file/dict-based so it
works in the single-process container and generalizes to a shared
filesystem or KV store at fleet scale:

* every worker stamps ``heartbeat(worker_id, step)`` each step;
* the monitor flags workers silent for ``dead_after_s`` (-> restart
  decision by the supervisor: restore latest committed checkpoint, rebuild
  the mesh without the dead host — elastic path in checkpoint.restore);
* per-step durations feed an EWMA; a worker slower than
  ``straggler_factor`` x the fleet median is flagged (mitigation: the
  trainer can drop it from the data assignment or trigger re-scheduling).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class MonitorConfig:
    dead_after_s: float = 60.0
    straggler_factor: float = 2.0
    ewma: float = 0.7


class HeartbeatMonitor:
    def __init__(self, cfg: MonitorConfig | None = None, clock=time.monotonic):
        self.cfg = cfg or MonitorConfig()
        self.clock = clock
        self.last_seen: dict[str, float] = {}
        self.last_step: dict[str, int] = {}
        self.step_time: dict[str, float] = {}
        self._prev_beat: dict[str, float] = {}

    def heartbeat(self, worker: str, step: int) -> None:
        now = self.clock()
        prev = self._prev_beat.get(worker)
        if prev is not None and step > self.last_step.get(worker, -1):
            dt = now - prev
            old = self.step_time.get(worker)
            self.step_time[worker] = (dt if old is None else
                                      self.cfg.ewma * old
                                      + (1 - self.cfg.ewma) * dt)
        self._prev_beat[worker] = now
        self.last_seen[worker] = now
        self.last_step[worker] = step

    def dead_workers(self) -> list[str]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.cfg.dead_after_s]

    def stragglers(self) -> list[str]:
        times = sorted(self.step_time.values())
        if len(times) < 2:
            return []
        median = times[len(times) // 2]
        return [w for w, t in self.step_time.items()
                if t > self.cfg.straggler_factor * median]

    def healthy(self) -> bool:
        return not self.dead_workers()


@dataclasses.dataclass
class RestartPolicy:
    """Supervisor decision table on failure events."""

    max_restarts: int = 100
    backoff_s: float = 5.0
    restarts: int = 0

    def on_failure(self, dead: list[str]) -> dict:
        """-> action dict for the launcher."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            return {"action": "abort", "reason": "restart budget exhausted"}
        return {
            "action": "restart_from_checkpoint",
            "exclude_workers": dead,
            "backoff_s": self.backoff_s,
            # elastic: restore onto the surviving mesh (checkpoint leaves
            # are gathered per leaf, so any new device layout works)
            "elastic": True,
        }


class StepTimer:
    """Per-step wall time + simple anomaly counter for the trainer loop."""

    def __init__(self):
        self.t0 = None
        self.history: list[float] = []

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self.t0
        self.history.append(dt)
        return dt
