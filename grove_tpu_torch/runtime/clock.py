"""Injectable clock.

Counterpart of ``grove_tpu/runtime/clock.py``: condition timestamps come from
``store.clock.now()``, so a simulated world runs on virtual time, and a
waiter's ``sleep`` advances it.
"""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        # grovelint: disable=GL001 -- this IS the wall-clock injection boundary every other module must go through
        return time.time()

    def sleep(self, seconds: float) -> None:
        # grovelint: disable=GL001 -- the real clock's sleep; virtual-time code gets VirtualClock.sleep via injection
        time.sleep(seconds)


class VirtualClock(Clock):
    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("cannot move time backwards")
        self._now += seconds
