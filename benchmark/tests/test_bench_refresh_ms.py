"""`refresh_ms` on hand-made records: ms of `map.refresh_geometry` per
keyframe processed by local mapping, and nothing where there is no keyframe
or no such span (as in a program from before the span)."""

import pytest

from benchmark.metrics import refresh_ms


def rec_of(spans: dict) -> dict:
    return {"unit": "frame", "units": [{}] * 6, "spans": spans}


def test_ms_per_keyframe():
    rec = rec_of({"lm.process_new_kf": [0.001] * 2,
                  "map.refresh_geometry": [0.004, 0.010, 0.020, 0.006]})
    assert refresh_ms.read(rec, "refresh_ms") == pytest.approx(20.0)


def test_no_keyframe_reads_nothing():
    assert refresh_ms.read(rec_of({"map.refresh_geometry": [0.004]}), "refresh_ms") is None
    assert refresh_ms.read(rec_of({}), "refresh_ms") is None


def test_a_program_without_the_span_reads_nothing():
    rec = rec_of({"lm.process_new_kf": [0.001] * 2, "lm.ba_apply": [0.5] * 2})
    assert refresh_ms.read(rec, "refresh_ms") is None
