"""The measured window and the statistics over its calls.

A window is whole calls: the loop starts a call only while fewer than
`seconds` have passed since the window opened, and the window closes when
the last call returns. Every rate is all the work over that whole time,
and every percentile is over every call of the window.
"""

from __future__ import annotations

import time


class Window:
    """Start and end times of every call of one closed-loop caller."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = float(seconds)
        self.clock = clock
        self.t0: float | None = None
        self.calls: list[tuple[float, float]] = []

    def open(self) -> float:
        self.t0 = self.clock()
        return self.t0

    def elapsed(self) -> float:
        return self.clock() - self.t0

    def more(self) -> bool:
        """Whether another call may start."""
        return self.elapsed() < self.seconds

    def record(self, start: float, end: float) -> None:
        self.calls.append((start, end))

    @property
    def window_s(self) -> float:
        """From the opening to the return of the last call."""
        if not self.calls:
            return 0.0
        return max(end for _, end in self.calls) - self.t0

    def latencies(self) -> list[float]:
        return [end - start for start, end in self.calls]


def percentile(values, q: float) -> float:
    """The `q`th percentile of every value, interpolated linearly between
    the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
