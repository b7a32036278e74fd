"""Fault tolerance primitives of the serving stack (the port's copy of
``repro.distributed.fault_tolerance``, which imports no JAX).

* **Preemption handling**: SIGTERM/SIGINT sets a flag; the server
  drains (stops intake, finishes or checkpoints in-flight requests) at
  the next megatick boundary (a cloud preemption notice arrives as
  SIGTERM).
* **Straggler detection**: a per-megatick wall-time watchdog on the
  MONOTONIC clock; persistent outliers step the engine down its
  degraded-mode ladder.
* **Heartbeats**: each host records (step, t, ...); a missing heartbeat
  past ``timeout`` marks the host dead. File-backed across processes,
  in memory (``path=None``) for one process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time


class PreemptionGuard:
    """SIGTERM/SIGINT -> graceful checkpoint-and-exit flag."""

    def __init__(self):
        self._flag = threading.Event()
        self._installed = False

    def install(self):
        if self._installed:
            return self
        self._prev_term = signal.signal(signal.SIGTERM, self._handler)
        self._prev_int = signal.signal(signal.SIGINT, self._handler)
        self._installed = True
        return self

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self):      # for tests and /admin/drain
        self._flag.set()


@dataclasses.dataclass
class Heartbeat:
    """Liveness records keyed by host.

    ``path`` set: append JSON lines to a shared file (multi-process
    training). ``path=None``: keep records in memory (single-process
    serving — beating must never touch the filesystem from a hot
    loop).  ``clock`` is injectable so timeout tests don't sleep;
    it defaults to wall time because heartbeat files are compared
    ACROSS hosts, where monotonic clocks don't align.
    """
    path: str | None = None
    host_id: int = 0
    timeout_s: float = 300.0
    clock: object = time.time
    _mem: dict = dataclasses.field(default_factory=dict)

    def beat(self, step: int, **info):
        rec = {"host": self.host_id, "step": step, "t": self.clock(),
               **info}
        if self.path is None:
            self._mem[self.host_id] = rec
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def dead_hosts(self, now: float | None = None) -> list[int]:
        """Hosts whose last heartbeat is older than timeout."""
        now = now if now is not None else self.clock()
        last: dict[int, float] = {}
        if self.path is None:
            last = {h: rec["t"] for h, rec in self._mem.items()}
        elif os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        last[rec["host"]] = max(
                            last.get(rec["host"], 0), rec["t"])
                    except (json.JSONDecodeError, KeyError):
                        continue
        return sorted(h for h, t in last.items()
                      if now - t > self.timeout_s)


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps (and hosts) that exceed k× the rolling median step
    time.  Callers should feed it MONOTONIC-clock durations
    (``time.monotonic`` deltas): serving megaticks are milliseconds,
    where a wall-clock NTP slew is indistinguishable from a straggler.
    ``timed()`` wraps that idiom."""
    factor: float = 2.0
    window: int = 50
    min_samples: int = 10
    _times: list = dataclasses.field(default_factory=list)
    slow_steps: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step was a straggler."""
        times = self._times
        times.append(dt)
        if len(times) > self.window:
            times.pop(0)
        med = sorted(times)[len(times) // 2]
        slow = len(times) >= self.min_samples and dt > self.factor * med
        if slow:
            self.slow_steps.append((step, dt, med))
        return slow

    def timed(self, step: int, t0: float) -> bool:
        """Record the monotonic elapsed time since ``t0`` for ``step``
        (``t0`` from ``time.monotonic()``); returns straggler-ness."""
        return self.record(step, time.monotonic() - t0)

    def summary(self) -> dict:
        return {"n_slow": len(self.slow_steps),
                "recent": self.slow_steps[-5:]}
