"""Tracing / profiling + logging (rebuild of SURVEY.md §5 aux subsystems).

A copy of `amcslam_tpu/utils/timing.py`; the span names the pipeline uses
(`track.*`, `tlm.*`, `lm.*`) are the reference's. The reference gates
`std::chrono` span collection behind REGISTER_TIMES (Frame.h:23) and dumps
per-stage vectors (`PrintTimeStats`, Tracking.cc:192-542);
`Verbose::PrintMess` is a 5-level static logger (System.h:47-72).
Here: a stage timer that collects per-stage samples (enabled by default —
it costs one perf_counter call) with summary statistics, and the same
5-level logger defaulting to QUIET. On-device spans should synchronize
before stopping (CUDA launches are asynchronous).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from enum import IntEnum

import numpy as np


class StageTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self) -> dict[str, dict[str, float]]:
        """median/mean per stage (multicam_amv.cc:120-128 prints both)."""
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v)
            out[k] = {
                "n": len(a),
                "median_ms": float(np.median(a) * 1e3),
                "mean_ms": float(np.mean(a) * 1e3),
                "max_ms": float(np.max(a) * 1e3),
            }
        return out

    def print_stats(self, file=None):
        for k, s in sorted(self.stats().items()):
            print(
                f"{k:32s} n={s['n']:5d} median={s['median_ms']:8.3f}ms "
                f"mean={s['mean_ms']:8.3f}ms max={s['max_ms']:8.3f}ms",
                file=file,
            )


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
