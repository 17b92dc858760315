"""Jittered exponential backoff with a deadline (a trimmed copy of
``nomad_tpu/utils/backoff.py``).

- ``Backoff``: the delay sequence ``min(cap, base * factor**n)`` with
  multiplicative jitter; give it a seeded ``random.Random`` for
  reproducible delays.
- ``Retryer``: attempts until a deadline or a stop event; the first runs
  at once, and iteration ends when the next sleep would cross the
  deadline. ``Retryer.call(fn)`` re-raises the last error on exhaustion.
  The raft layer's snapshot sender and the cluster's forwarding loop
  use it.

Not ported: ``RetryBudget``, the shared retry budget of the API's
clients; it waits for the HTTP API.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Iterator, Optional, Tuple, Type


class Backoff:
    """Exponential delay sequence with jitter; not thread-safe (give
    each retry loop / peer its own instance)."""

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 cap: float = 5.0, jitter: float = 0.1,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.factor = factor
        self.cap = cap
        self.jitter = jitter
        self._rng = rng if rng is not None else random
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def next_delay(self) -> float:
        """The delay before the next attempt; advances the sequence."""
        raw = min(self.cap, self.base * (self.factor ** self._attempt))
        self._attempt += 1
        if self.jitter <= 0:
            return raw
        # full +/- jitter fraction, never negative
        spread = raw * self.jitter
        return max(0.0, raw + self._rng.uniform(-spread, spread))

    def peek(self) -> float:
        """The un-jittered delay the next next_delay() is based on."""
        return min(self.cap, self.base * (self.factor ** self._attempt))

    def at_cap(self) -> bool:
        """True once the un-jittered delay has saturated at `cap`."""
        return self.base * (self.factor ** self._attempt) >= self.cap

    def reset(self) -> None:
        self._attempt = 0


class Retryer:
    """Deadline-bounded attempt iterator (see module docstring)."""

    def __init__(self, deadline_s: Optional[float], base: float = 0.05,
                 factor: float = 2.0, cap: float = 5.0, jitter: float = 0.1,
                 stop: Optional[threading.Event] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.deadline_s = deadline_s
        self._backoff = Backoff(base=base, factor=factor, cap=cap,
                                jitter=jitter, rng=rng)
        self._stop = stop
        self._sleep = sleep
        self._clock = clock

    def __iter__(self) -> Iterator[int]:
        start = self._clock()
        attempt = 0
        while True:
            if self._stop is not None and self._stop.is_set():
                return
            yield attempt
            attempt += 1
            delay = self._backoff.next_delay()
            if self.deadline_s is not None:
                remaining = self.deadline_s - (self._clock() - start)
                if remaining <= 0:
                    return
                delay = min(delay, remaining)
            if self._stop is not None:
                # an Event wait doubles as an interruptible sleep
                if self._stop.wait(delay):
                    return
            else:
                self._sleep(delay)

    def call(self, fn: Callable[[], object],
             retry_on: Tuple[Type[BaseException], ...] = (Exception,)):
        """Run fn until it returns, retrying `retry_on`; re-raises the
        last error once the deadline/stop exhausts the attempts."""
        last: Optional[BaseException] = None
        for _ in self:
            try:
                return fn()
            except retry_on as e:
                last = e
        if last is not None:
            raise last
        raise TimeoutError("retry loop stopped before the first attempt")
