"""The device trace of a traced run: taking it, and reading it.

`Tracer` runs `torch.profiler` over a short steady part of the window: one
warm-up step (a trace that starts cold can miss the first kernels) and
one active step of a few calls, or of a fixed time. A trace that kept no
device event is taken again, at most three times. The active step's
events are exported as a Chrome trace and read by `Trace`:

- the window is the benchmark's own range `portbench.active`, opened
  at the start of the active step and closed at its end (else the longest
  `ProfilerStep#<n>`);
- device events are kernels, copies and sets; busy time is the union of
  their intervals clipped to the window, never a sum of self times;
- a device event belongs to a host range (`record_function`) when the
  runtime call that launched it (same correlation id) lies inside that
  range on the same thread;
- each idle gap of the device is put down to the innermost host range or
  operator open at its middle, on any thread.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("user_annotation", "cpu_op")
STEP = "ProfilerStep#"
ACTIVE = "portbench.active"
NO_RANGE = "(no host range)"
MAX_ATTEMPTS = 3


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of [a, b) intervals clipped to [lo, hi)."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def idle_percent(trace) -> float | None:
    """The device's idle share of a trace's window, in percent, or None
    where there is no trace or it kept no device event."""
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


class Trace:
    """One exported Chrome trace (times in microseconds)."""

    def __init__(self, doc: dict):
        events = [e for e in doc.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in events if e.get("cat") in RANGE_CATS
                 and str(e.get("name", "")).startswith((STEP, ACTIVE))]
        self.device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        str(e["name"]), (e.get("args") or {}).get("correlation"))
                       for e in events if e.get("cat") in DEVICE_CATS]
        self.launch = {}
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (float(e["ts"]), e.get("tid"))
        self.ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        str(e["name"]), e.get("tid"))
                       for e in events if e.get("cat") in RANGE_CATS
                       and not str(e.get("name", "")).startswith(
                           (STEP, ACTIVE))]
        if marks:
            mark = max(marks, key=lambda e: (e["name"] == ACTIVE,
                                             float(e["dur"])))
            self.lo = float(mark["ts"])
            self.hi = self.lo + float(mark["dur"])
        else:
            spans = [(a, b) for a, b, *_ in self.device + self.ranges]
            self.lo = min((a for a, _ in spans), default=0.0)
            self.hi = max((b for _, b in spans), default=0.0)

    @staticmethod
    def load(path) -> "Trace":
        with open(path) as f:
            return Trace(json.load(f))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_seconds([(a, b) for a, b, *_ in self.device],
                             self.lo, self.hi) * 1e-6

    def device_time(self, name_part: str) -> float:
        """Seconds of the device events whose name contains `name_part`."""
        return sum(b - a for a, b, name, _ in self.device
                   if name_part in name) * 1e-6

    def range_time(self, name: str) -> tuple[float, int]:
        """(seconds, count) of the host ranges named `name`."""
        spans = [b - a for a, b, n, _ in self.ranges if n == name]
        return sum(spans) * 1e-6, len(spans)

    def device_time_in_range(self, name: str) -> float:
        """Seconds of the device events launched inside a host range named
        `name` (on the launching thread)."""
        spans = [(a, b, tid) for a, b, n, tid in self.ranges if n == name]
        total = 0.0
        for a, b, _, corr in self.device:
            at = self.launch.get(corr)
            if at is None:
                continue
            ts, tid = at
            if any(lo <= ts <= hi and t == tid for lo, hi, t in spans):
                total += b - a
        return total * 1e-6

    def top_device_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, float] = {}
        for a, b, name, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], s] for name, s in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device seconds by the innermost host range open at the
        middle of each gap, the largest first."""
        by_name: dict[str, float] = {}
        for a, b in gaps([(x, y) for x, y, *_ in self.device],
                         self.lo, self.hi):
            mid = 0.5 * (a + b)
            open_ = [(y - x, name) for x, y, name, _ in self.ranges
                     if x <= mid <= y]
            name = min(open_)[1] if open_ else NO_RANGE
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], s] for name, s in top]


class Tracer:
    """Runs the profiler over one warm-up step and one active step.

    Call-driven (`before_call` / `after_call` around each call of a
    closed loop): the profiler starts at the first call after `start_s` of
    the window, that call is the warm-up step, and the next `calls` calls
    are the active step. Time-driven (`timed`): warm-up and active steps
    of fixed lengths, for a window whose calls run on other threads."""

    def __init__(self, tmpdir: Path, start_s: float, calls: int, log):
        self.tmpdir = Path(tmpdir)
        self.start_s = float(start_s)
        self.calls = int(calls)
        self.log = log
        self.trace: Trace | None = None
        self.attempts = 0
        self.state = "wait"
        self._prof = None
        self._active = None
        self._count = 0

    def prime(self) -> None:
        """Start and stop the profiler once on a trivial operation, in
        set-up: the first start on the card initialises its tracing
        library, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            x = torch.ones(8, device="cuda" if torch.cuda.is_available()
                           else "cpu")
            (x + x).sum().item()

    @property
    def pending(self) -> bool:
        """Whether the trace is still to be taken or finished."""
        return self.state != "done"

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.attempts += 1
        path = self.tmpdir / f"trace_{self.attempts}.json"
        self._path = path
        self._prof = profile(
            activities=activities,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
        self._prof.start()

    def _open_active(self) -> None:
        from torch.profiler import record_function

        self._active = record_function(ACTIVE)
        self._active.__enter__()

    def _finish(self) -> None:
        self._active.__exit__(None, None, None)
        self._active = None
        self._prof.step()  # ends the active step: the trace is exported
        self._prof.stop()
        self._prof = None
        trace = Trace.load(self._path) if self._path.exists() else None
        if self._path.exists():
            os.unlink(self._path)
        if trace is not None and trace.device:
            self.trace, self.state = trace, "done"
            return
        self.log(f"trace {self.attempts} of {MAX_ATTEMPTS} kept no device "
                 f"event")
        if self.attempts >= MAX_ATTEMPTS:
            self.trace = trace
            self.state = "done"
        else:
            self.state, self.start_s = "wait", 0.0

    def before_call(self, elapsed: float) -> bool:
        """Whether the call about to start is in the active step."""
        if self.state == "wait" and elapsed >= self.start_s:
            self._start()
            self.state = "warm"
        return self.state == "active"

    def after_call(self) -> None:
        if self.state == "warm":
            self._prof.step()
            self._open_active()
            self.state, self._count = "active", 0
        elif self.state == "active":
            self._count += 1
            if self._count >= self.calls:
                self._finish()

    def close(self) -> None:
        """At the end of the window: finish an active step that has calls,
        drop one that has none."""
        if self.state == "active" and self._count > 0:
            self._finish()
        elif self._prof is not None:
            if self._active is not None:
                self._active.__exit__(None, None, None)
                self._active = None
            self._prof.stop()
            self._prof = None
        if self.state != "done":
            self.state = "done"

    def timed(self, warm_s: float, active_s: float) -> None:
        """Warm-up and active steps of fixed lengths, retaken while the
        trace keeps no device event."""
        while self.state != "done":
            self._start()
            time.sleep(warm_s)
            self._prof.step()
            self._open_active()
            time.sleep(active_s)
            self._finish()
