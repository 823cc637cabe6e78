"""Clock abstraction: tests drive a ManualClock deterministically; examples
and benchmarks use the RealClock."""
from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, s: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        # replint: ignore[R001] -- RealClock IS the sanctioned wall-clock boundary; everything else injects a Clock
        return time.monotonic()

    def sleep(self, s: float) -> None:
        # replint: ignore[R001] -- RealClock IS the sanctioned wall-clock boundary; everything else injects a Clock
        time.sleep(s)


class ManualClock(Clock):
    def __init__(self, start: float = 0.0):
        self._t = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def advance(self, s: float) -> None:
        with self._lock:
            self._t += s

    def sleep(self, s: float) -> None:  # cooperative: sleeping advances time
        self.advance(s)
