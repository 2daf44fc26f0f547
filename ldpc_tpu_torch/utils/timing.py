"""Lightweight wall-clock timing.

A copy of the JAX package's ``utils/timing.py`` (the port imports nothing
from that package). The reference only reports coarse elapsed time
(main.py:646-667); here per-stage timers feed throughput metrics.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.laps: dict[str, float] = {}

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self.t0 = now
        return dt

    def reset(self) -> None:
        self.t0 = time.perf_counter()
