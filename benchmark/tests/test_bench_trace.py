"""The reduction of a device trace: busy time, idle share, labels."""

import pytest

from benchmark import trace
from benchmark.metrics import device_idle_pct


def test_busy_is_the_union_of_device_intervals_and_gaps_get_the_innermost_span():
    spans = [(0.0, 6.0, "track.local_map"), (1.0, 3.0, "tlm.search_points")]
    events = [
        ("k1", "kernel", 0.5, 1.5),
        ("k2", "kernel", 1.2, 2.0),             # overlaps k1
        ("memcpy", "gpu_memcpy", 4.0, 5.0),
        ("tlm.search_points", "gpu_user_annotation", 1.0, 3.0),  # not work
        ("k3", "kernel", 9.0, 12.0),            # clipped at the window's end
    ]
    out = trace.reduce_events(events, spans, (0.0, 10.0))
    assert out["busy_s"] == pytest.approx(1.5 + 1.0 + 1.0)
    assert out["kernel_s"] == pytest.approx({"k1": 1.0, "k2": 0.8, "memcpy": 1.0, "k3": 1.0})
    idle = out["idle_by_span"]
    # gaps: [0, .5] local_map; [2, 4] search_points (mid 3.0: the end mark of
    # search_points, so local_map); [5, 9] mid 7 outside every span
    assert idle["track.local_map"] == pytest.approx(0.5 + 2.0)
    assert idle["no span"] == pytest.approx(4.0)
    assert sum(idle.values()) == pytest.approx(10.0 - out["busy_s"])
    rec = {"trace": out}
    assert device_idle_pct.read(rec, "device_idle_pct.online") == pytest.approx(65.0)


def test_an_empty_trace_is_all_idle_and_no_trace_reads_nothing():
    out = trace.reduce_events([], [], (2.0, 3.0))
    assert out["busy_s"] == 0.0 and out["idle_by_span"] == {"no span": pytest.approx(1.0)}
    assert device_idle_pct.read({"trace": None}, "device_idle_pct.gba") is None


def test_labels_of_nested_spans():
    spans = [(0.0, 10.0, "a"), (2.0, 4.0, "b"), (3.0, 3.5, "c"), (6.0, 7.0, "d")]
    got = trace.innermost_labels(spans, [-1.0, 1.0, 2.5, 3.2, 3.8, 5.0, 6.5, 11.0])
    assert got == ["no span", "a", "b", "c", "b", "a", "d", "no span"]
