"""Tracing / profiling + logging (rebuild of SURVEY.md §5 aux subsystems).

A copy of `amcslam_tpu/utils/timing.py` grown into the port's tracer; the
span names the pipeline uses (`track.*`, `tlm.*`, `lm.*`) are the
reference's. The reference gates `std::chrono` span collection behind
REGISTER_TIMES (Frame.h:23) and dumps per-stage vectors (`PrintTimeStats`,
Tracking.cc:192-542); `Verbose::PrintMess` is a 5-level static logger
(System.h:47-72).

Here: a stage timer, on by default, that keeps for each stage name the
durations of its spans (`samples`, seconds) and, in a bounded buffer of the
latest spans, each span's start and end (ns since the epoch, the wall clock
that torch.profiler's device events carry), its thread, its parent (the
enclosing span open on the same thread) and its root (the outermost one:
every span of one `System.track_multicamera` call shares the frame's root).
`write_trace` exports the buffer as Chrome trace-event JSON.

A span is host time. It never synchronizes the device: CUDA launches are
asynchronous, so a span around a launch ends before the work does, and a
span around a host read (`host.read`) holds the wait for the work queued
before it. The device's own time per stage comes from a device trace placed
against the spans on the shared clock. A span inside a function that a
CUDA graph captures (solver/graphs.py) would run once, at capture, so none
goes there. The same 5-level logger defaults to QUIET.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from enum import IntEnum

import numpy as np

# perf_counter_ns() + _EPOCH_NS is time.time_ns() read at import: the
# monotonic clock placed on the wall clock once
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()

BUFFER_SPANS = 1 << 20  # the latest spans kept with their times


class _Thread(threading.local):
    def __init__(self):
        self.stack: list[_Span] = []
        self.tid = threading.get_ident()


class _Span:
    """One open span: its id, parent and root, and its children's time."""

    __slots__ = ("timer", "name", "id", "parent", "root", "t0", "child_ns")

    def __init__(self, timer: StageTimer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        timer = self.timer
        stack = timer._thread.stack
        self.id = sid = next(timer._ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[0].id
        else:
            self.parent, self.root = -1, sid
        self.child_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        timer = self.timer
        thread = timer._thread
        stack = thread.stack
        stack.pop()
        dur = t1 - self.t0
        if stack:
            stack[-1].child_ns += dur
        name = self.name
        timer.samples[name].append(dur * 1e-9)
        timer.self_samples[name].append((dur - self.child_ns) * 1e-9)
        timer.records.append((name, self.t0 + _EPOCH_NS, t1 + _EPOCH_NS, thread.tid,
                              self.id, self.parent, self.root))
        return False


class _Off:
    """The span of a disabled timer: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class StageTimer:
    """Spans by stage name. `samples`: name -> durations in seconds, appended
    as spans end; `self_samples`: the same less each span's children on its
    thread; `records`: the latest `buffer` spans as (name, start_ns, end_ns,
    thread, id, parent, root), times on the wall clock, parent -1 for a
    root."""

    def __init__(self, enabled: bool = True, buffer: int = BUFFER_SPANS):
        self.enabled = enabled
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.records: deque = deque(maxlen=buffer)
        self.self_samples: dict[str, list[float]] = defaultdict(list)
        self._ids = itertools.count()
        self._thread = _Thread()

    def span(self, name: str):
        """A context manager timing the stage `name`."""
        return _Span(self, name) if self.enabled else _OFF

    def clear(self) -> None:
        """Forget every span recorded (open spans still end normally)."""
        self.samples.clear()
        self.records.clear()
        self.self_samples.clear()

    def stats(self) -> dict[str, dict[str, float]]:
        """median/mean per stage (multicam_amv.cc:120-128 prints both), and
        the mean self time: a span's duration less what its children on
        its thread cover."""
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v)
            own = self.self_samples.get(k)
            out[k] = {
                "n": len(a),
                "median_ms": float(np.median(a) * 1e3),
                "mean_ms": float(np.mean(a) * 1e3),
                "max_ms": float(np.max(a) * 1e3),
                "self_mean_ms": float(np.mean(own) * 1e3) if own else 0.0,
            }
        return out

    def print_stats(self, file=None):
        for k, s in sorted(self.stats().items()):
            print(
                f"{k:32s} n={s['n']:5d} median={s['median_ms']:8.3f}ms "
                f"mean={s['mean_ms']:8.3f}ms self={s['self_mean_ms']:8.3f}ms "
                f"max={s['max_ms']:8.3f}ms",
                file=file,
            )

    def write_trace(self, path) -> int:
        """Write the buffered spans to `path` as Chrome trace-event JSON (one
        complete event a span, times in µs since the epoch; chrome://tracing
        or Perfetto opens it). Returns the number of spans written."""
        pid = os.getpid()
        names = {t.ident: t.name for t in threading.enumerate()}
        records = list(self.records)
        events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": names.get(tid, str(tid))}}
                  for tid in sorted({r[3] for r in records})]
        events += [{"name": name, "ph": "X", "pid": pid, "tid": tid, "ts": t0 / 1e3,
                    "dur": (t1 - t0) / 1e3, "args": {"id": sid, "parent": parent, "root": root}}
                   for name, t0, t1, tid, sid, parent, root in records]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(records)


class VerbosityLevel(IntEnum):
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    VERY_VERBOSE = 3
    DEBUG = 4


class Verbose:
    """Static threshold logger (System.h:47-72); QUIET at startup
    (System.cc:209)."""

    level = VerbosityLevel.QUIET

    @classmethod
    def set_level(cls, level: VerbosityLevel):
        cls.level = level

    @classmethod
    def print_mess(cls, msg: str, level: VerbosityLevel = VerbosityLevel.NORMAL):
        if level <= cls.level:
            print(msg)


GLOBAL_TIMER = StageTimer()
