"""The readers of the program's own spans (`loop_closer_ms`, `track_host_ms`,
`capture_ms`, `graph_recaptures`, `host_wait_ms`) on hand-made records, and
a short drive whose window holds the spans they read: on the CPU (no graphs
there) and, with `-m card`, on the card."""

import pytest

from benchmark import run
from benchmark.metrics import (capture_ms, graph_recaptures, host_wait_ms, loop_closer_ms,
                               track_host_ms)
from benchmark.tests.test_bench_faults import small_limits

SPEC = run.load_spec()
NEW = {"loop_closer_ms": loop_closer_ms, "track_host_ms": track_host_ms,
       "capture_ms": capture_ms, "graph_recaptures": graph_recaptures,
       "host_wait_ms": host_wait_ms}
# the spans each new metric reads; the drive's frame root beside them
SPANS = {"sys.frame", "lc.run_once", "lc.detect", "lc.correct", "lc.kfdb_add",
         "tlm.ransac_extract", "tlm.ransac_solve", "tlm.ransac_apply", "tlm.pose_extract",
         "tlm.pose_lm", "tlm.pose_apply", "graph.warm", "graph.capture", "graph.recapture",
         "host.read"}
# a short drive revisits nothing (no loop to correct), and whether a graph
# entry comes back after its eviction depends on how the map grows: these
# two are held by tests/test_torch_timing.py
NOT_IN_A_SHORT_DRIVE = {"lc.correct", "graph.recapture"}
# no graphs on the CPU, and the closer detects from its 12th keyframe on
NOT_ON_THE_CPU = NOT_IN_A_SHORT_DRIVE | {"graph.warm", "graph.capture", "lc.detect"}


def rec_of(spans: dict, frames: int = 4) -> dict:
    return {"unit": "frame", "units": [{}] * frames, "spans": spans}


def test_readers_on_a_hand_made_record():
    rec = rec_of({
        "sys.frame": [0.5] * 4,
        "lc.run_once": [0.010, 0.006], "lc.detect": [0.004],
        "tlm.ransac_extract": [0.030] * 4, "tlm.ransac_solve": [0.025] * 4,
        "tlm.ransac_apply": [0.001] * 4, "tlm.pose_extract": [0.020] * 8,
        "tlm.pose_lm": [0.030] * 8, "tlm.pose_apply": [0.002] * 8,
        "graph.warm": [0.1, 0.2], "graph.capture": [0.3], "graph.recapture": [0.2, 0.2],
        "host.read": [0.001] * 40,
    })
    got = {name: m.read(rec, name) for name, m in NEW.items()}
    want = {"loop_closer_ms": 8.0, "track_host_ms": (0.120 + 0.004 + 0.160 + 0.016) * 1e3 / 4,
            "capture_ms": 1.0e3 / 4, "graph_recaptures": 2.0, "host_wait_ms": 10.0}
    assert got == pytest.approx(want)


def test_a_program_with_none_of_the_spans_reads_nothing():
    """As the program before these spans: every reader returns None."""
    rec = rec_of({"track.motion_model": [0.1] * 4, "bench.loop_closer": [0.01] * 2})
    assert {name: m.read(rec, name) for name, m in NEW.items()} == dict.fromkeys(NEW)
    assert all(m.read({**rec, "unit": "solve"}, name) is None for name, m in NEW.items())


def test_a_frame_without_captures_reads_zero():
    rec = rec_of({"sys.frame": [0.5] * 4, "host.read": [0.001]})
    assert capture_ms.read(rec, "capture_ms") == 0.0
    assert graph_recaptures.read(rec, "graph_recaptures") == 0.0
    assert track_host_ms.read(rec, "track_host_ms") is None
    assert loop_closer_ms.read(rec, "loop_closer_ms") is None


def short_drive(monkeypatch, device, n_frames, warm_frames, trace):
    """A run of the drive cut to `n_frames`; returns its result, its window's
    record and the names of every span the program recorded, set-up
    included."""
    from amcslam_tpu_torch.utils.timing import GLOBAL_TIMER

    recs = []
    window = run.run_window

    def keep(*args, **kw):
        recs.append(window(*args, **kw))
        return recs[-1]

    monkeypatch.setattr(run, "run_window", keep)
    cell = run.cell_of(SPEC, "amv6_rig.kp_drive")
    mix = dict(run.mix_of(cell), n_frames=n_frames, warm_frames=warm_frames, trace_seconds=1.0)
    if device == "cpu":
        mix["lm_per_frame"] = 40
    GLOBAL_TIMER.clear()
    res = run.run_cell(SPEC, cell, 3_000_000_019, 1e6, trace, device=device, mix=mix,
                       limits=small_limits(cell), log=lambda **k: None)
    return res, recs[0], set(GLOBAL_TIMER.samples)


def test_a_short_drive_on_the_cpu_records_the_spans(monkeypatch):
    res, rec, names = short_drive(monkeypatch, "cpu", 18, 8, False)
    assert res["correct"], res["checks"]
    assert SPANS - NOT_ON_THE_CPU <= names, SPANS - NOT_ON_THE_CPU - names
    for name, m in NEW.items():
        assert m.read(rec, name) >= 0.0, name


@pytest.mark.card
def test_a_short_drive_on_the_card_records_the_spans(monkeypatch, card):
    res, _, names = short_drive(monkeypatch, card, 90, 10, True)
    assert res["correct"], res["checks"]
    assert SPANS - NOT_IN_A_SHORT_DRIVE <= names, SPANS - NOT_IN_A_SHORT_DRIVE - names
    for name in NEW:
        assert name in res["metrics"], name
