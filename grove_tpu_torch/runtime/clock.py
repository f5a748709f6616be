"""Injectable clock.

Counterpart of ``grove_tpu/runtime/clock.py``: condition timestamps come from
``store.clock.now()``, so a simulated world runs on virtual time.
"""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        return time.time()


class VirtualClock(Clock):
    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("cannot move time backwards")
        self._now += seconds
