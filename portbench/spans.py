"""The program's own spans in a traced run (`utils/profiling.phase`
ranges of the port), as the per-layer metrics read them: the ranges of
one name inside the traced window, their host time less that of the
ranges nested in them, and the device's idle time inside them.

A trace without device events is a trace the profiler failed to take (it
is retaken, `trace.Tracer`): every function here returns None for it, as
for a program that opens no range of the name asked for.
"""

from __future__ import annotations

from portbench.trace import gaps, union_seconds


def ranges(trace, name: str) -> list[tuple[float, float]] | None:
    """[(start, end)] in microseconds of the host ranges named `name`
    that start inside the traced window, or None where there are none."""
    if trace is None or not trace.device:
        return None
    out = [(a, b) for a, b, n, _ in trace.ranges
           if n == name and trace.lo <= a < trace.hi]
    return out or None


def host_seconds(trace, name: str, less: str) -> float | None:
    """Seconds inside the ranges `name`, less the part of them that the
    ranges `less` cover."""
    outer = ranges(trace, name)
    if outer is None:
        return None
    inner = ranges(trace, less) or []
    return 1e-6 * sum((b - a) - union_seconds(inner, a, b)
                      for a, b in outer)


def idle_seconds(trace, name: str) -> float | None:
    """Seconds of the device's idle gaps in the window that lie inside the
    ranges `name`."""
    outer = ranges(trace, name)
    if outer is None:
        return None
    idle = gaps([(a, b) for a, b, *_ in trace.device], trace.lo, trace.hi)
    return 1e-6 * sum(union_seconds(outer, a, b) for a, b in idle)
