"""The window's arithmetic: rates over the whole window, the p95 over all
frames, the closing solve counted whole."""

import time

import numpy as np
import pytest

from benchmark import run
from benchmark.metrics import frame_ms_p95, frames_per_s, gba_s, setup_s


class FakeSession:
    dtype_name = "float32"

    def __init__(self, unit, durations):
        self.unit, self.durations, self.i = unit, list(durations), 0

    def step(self):
        if self.i >= len(self.durations):
            return None
        time.sleep(self.durations[self.i])
        self.i += 1
        return {"failed": False}


def test_frames_rate_and_p95_over_every_frame():
    durs = [0.01] * 19 + [0.06]
    rec = run.run_window(FakeSession("frame", durs), 5.0, "cpu", None)
    n = len(rec["units"])
    assert n == 20 and rec["exhausted"]          # the drive ran out first
    assert rec["window_s"] >= sum(durs)
    assert frames_per_s.read(rec, "frames_per_s") == pytest.approx(n / rec["window_s"])
    ms = [u["ms"] for u in rec["units"]]
    assert frame_ms_p95.read(rec, "frame_ms_p95") == pytest.approx(np.percentile(ms, 95))
    assert frame_ms_p95.read(rec, "frame_ms_p95") > 10.0
    assert gba_s.read(rec, "gba_s") is None
    assert setup_s.read(rec, "setup_s") == rec["setup_s"] > 0


def test_the_window_closes_after_the_first_solve_that_ends_past_it():
    rec = run.run_window(FakeSession("solve", [0.04] * 10), 0.1, "cpu", None)
    n = len(rec["units"])
    assert n == 3 and not rec["exhausted"]       # 0.04, 0.08, 0.12 >= 0.1
    assert rec["window_s"] >= 0.12
    assert gba_s.read(rec, "gba_s") == pytest.approx(rec["window_s"] / 3)
    assert frames_per_s.read(rec, "frames_per_s") is None


def test_compare_fails_a_missing_or_non_finite_number():
    limits = {"numbers": {"a": {"limit": 1.0}, "b": {"limit": 0.0}}}
    assert run.compare({"a": 0.5, "b": 0.0}, limits)[0]
    assert not run.compare({"a": 1.5, "b": 0.0}, limits)[0]
    assert not run.compare({"a": float("nan"), "b": 0.0}, limits)[0]
    assert not run.compare({"a": 0.5}, limits)[0]
