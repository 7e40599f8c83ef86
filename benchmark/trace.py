"""The device trace of a traced run, and its reduction.

`DeviceTrace` records the card's activity (kernels, copies, fills) with
`torch.profiler` (CUPTI) over a part of the window; it records no host
operators, whose recording would slow the host-bound program it watches.
While it records, each span of the program's stage timer is also kept with
its start and end on the wall clock (ns since the epoch, the clock the
profiler's events carry), so the trace can place the host's stages beside
the card's work. `stop` reads the raw events (the profiler's own event tree
is not built: for a window of a million kernels it takes minutes) and
`reduce_events` turns them into the record that the metric readers take:

- `window_s`: the traced window, on the host's clock;
- `busy_s`: the union of the intervals in which a kernel, copy or fill ran;
- `kernel_s`: device seconds by kernel name;
- `idle_by_span`: the idle seconds, each gap charged to the innermost span
  open on the host at its middle ("no span" outside them).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_events(events, spans, window: tuple[float, float]) -> dict:
    """`events`: (name, activity, start_s, end_s) of the card; `spans`: (start_s,
    end_s, name) of the host's stages; `window`: the traced interval, all on
    one clock."""
    w0, w1 = window
    dev = []
    kernel_s: dict[str, float] = {}
    for name, activity, t0, t1 in events:
        if activity is not None and activity not in DEVICE_ACTIVITIES:
            continue
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        dev.append((t0, t1))
        kernel_s[name] = kernel_s.get(name, 0.0) + (t1 - t0)
    busy, gaps = merge(dev, w0, w1)
    idle: dict[str, float] = {}
    if gaps:
        label = innermost_labels(spans, [(a + b) / 2 for a, b in gaps])
        for (a, b), lab in zip(gaps, label):
            idle[lab] = idle.get(lab, 0.0) + (b - a)
    return {"window_s": w1 - w0, "busy_s": busy, "kernel_s": kernel_s, "idle_by_span": idle}


def merge(intervals, w0: float, w1: float):
    """(busy seconds, idle gaps) of intervals inside [w0, w1]."""
    if not intervals:
        return 0.0, [(w0, w1)] if w1 > w0 else []
    a = np.array(sorted(intervals))
    starts, ends = a[:, 0], np.maximum.accumulate(a[:, 1])
    # a new busy block starts where an interval begins after every earlier end
    new = np.concatenate([[True], starts[1:] > ends[:-1]])
    b_start = starts[new]
    b_end = np.concatenate([ends[np.nonzero(new)[0][1:] - 1], ends[-1:]])
    busy = float(np.sum(b_end - b_start))
    edges = np.concatenate([[w0], b_end]), np.concatenate([b_start, [w1]])
    gaps = [(float(x), float(y)) for x, y in zip(*edges) if y > x]
    return busy, gaps


def innermost_labels(spans, times) -> list[str]:
    """For each time, the name of the innermost span (the latest-starting
    one) that contains it, or "no span". Spans nest, as context managers on
    one thread do."""
    bounds = sorted([(t0, 1, i) for i, (t0, _, _) in enumerate(spans)]
                    + [(t1, 0, i) for i, (_, t1, _) in enumerate(spans)])
    marks, labels, stack = [], [], []
    for t, opening, i in bounds:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        marks.append(t)
        labels.append(spans[stack[-1]][2] if stack else "no span")
    if not marks:
        return ["no span"] * len(times)
    at = np.searchsorted(np.asarray(marks), np.asarray(times), side="right") - 1
    return [labels[k] if k >= 0 else "no span" for k in at]


class DeviceTrace:
    """torch.profiler's record of the card over a part of the window; the
    spans of the program's stage timer `timer` are kept with their times
    while it records."""

    def __init__(self, timer):
        self.timer = timer
        self.spans: list[tuple[float, float, str]] = []
        self._span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        original = self.timer.span
        spans = self.spans

        @contextmanager
        def span(name):
            t0 = time.time_ns()
            try:
                with original(name):
                    yield
            finally:
                spans.append((t0 * 1e-9, time.time_ns() * 1e-9, name))

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._span = original
        self.timer.span = span
        self.t0 = time.time_ns() * 1e-9

    def stop(self) -> dict:
        import torch
        import torch.autograd.profiler as autograd_profiler

        torch.cuda.synchronize()
        t1 = time.time_ns() * 1e-9
        # the raw events, without the profiler's event tree (see the module doc)
        results = torch._C._autograd._disable_profiler()
        autograd_profiler._run_on_profiler_stop()
        self.timer.span = self._span
        cuda = torch.autograd.DeviceType.CUDA
        rows = []
        for ev in results.events():
            if ev.device_type() != cuda:
                continue
            s = _ns(ev, "start") * 1e-9
            activity = ev.activity_type() if hasattr(ev, "activity_type") else None
            rows.append((ev.name(), activity, s, s + _ns(ev, "duration") * 1e-9))
        out = reduce_events(rows, self.spans, (self.t0, t1))
        # where the card's events lie against the host's window: a check of
        # the two clocks (both near 0 when they agree)
        if rows:
            out["clock_check_s"] = [min(r[2] for r in rows) - self.t0,
                                    max(r[3] for r in rows) - t1]
        out["device_events"] = len(rows)
        return out


def _ns(ev, what: str) -> int:
    """start / duration of a raw profiler event in ns (older releases give µs)."""
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return fn()
    return getattr(ev, f"{what}_us")() * 1000
