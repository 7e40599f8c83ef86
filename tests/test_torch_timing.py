"""The port's stage timer (`utils/timing.StageTimer`) and the spans the
program opens with it: each span's parent, root and thread, its start and
end on the wall clock, self time, the bounded buffer, the Chrome trace
export; the graph cache's warm-up, capture and recapture spans under its
eviction; the loop closer's and the frame root's spans."""

import contextlib
import json
import threading
import time
from types import SimpleNamespace

import pytest

from amcslam_tpu_torch.pipeline.loop_closing import LoopClosing
from amcslam_tpu_torch.pipeline.system import System
from amcslam_tpu_torch.solver import graphs
from amcslam_tpu_torch.utils.timing import GLOBAL_TIMER, StageTimer


def by_name(timer) -> dict:
    """name -> list of (start_ns, end_ns, thread, id, parent, root)."""
    out = {}
    for name, *rest in timer.records:
        out.setdefault(name, []).append(tuple(rest))
    return out


def test_parent_root_and_thread_across_nesting_and_threads():
    t = StageTimer()
    barrier = threading.Barrier(2)

    def frame(tag):
        with t.span(f"root.{tag}"):
            with t.span(f"mid.{tag}"):
                barrier.wait(timeout=10)  # both threads hold their spans open at once
                with t.span(f"leaf.{tag}"):
                    pass
            with t.span(f"side.{tag}"):
                pass

    threads = [threading.Thread(target=frame, args=(tag,)) for tag in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    rec = by_name(t)
    ids = set()
    for tag, th in zip("ab", threads):
        (root,), (mid,), (leaf,), (side,) = (rec[f"{n}.{tag}"] for n in ("root", "mid", "leaf",
                                                                        "side"))
        assert root[4] == -1 and root[5] == root[3]  # a root is its own root
        assert mid[4] == root[3] and side[4] == root[3] and leaf[4] == mid[3]
        assert {s[5] for s in (mid, leaf, side)} == {root[3]}
        assert {s[2] for s in (root, mid, leaf, side)} == {th.ident}
        ids |= {s[3] for s in (root, mid, leaf, side)}
    assert len(ids) == 8
    assert {n: len(v) for n, v in t.samples.items()} == {n: 1 for n in rec}


def test_start_and_end_on_the_wall_clock():
    t = StageTimer()
    before = time.time_ns()
    with t.span("a"):
        time.sleep(0.01)
    after = time.time_ns()
    (_, t0, t1, *_), = t.records
    assert before - 1_000_000 <= t0 <= t1 <= after + 1_000_000
    assert t1 - t0 >= 10_000_000
    assert abs((t1 - t0) * 1e-9 - t.samples["a"][0]) < 1e-9


def test_self_time_is_the_duration_less_the_children():
    t = StageTimer()
    with t.span("outer"):
        time.sleep(0.02)
        for _ in range(2):
            with t.span("inner"):
                time.sleep(0.015)
    s = t.stats()
    inner = sum(t.samples["inner"])
    assert s["outer"]["self_mean_ms"] == pytest.approx(1e3 * (t.samples["outer"][0] - inner),
                                                       abs=1e-6)
    assert 15 <= s["outer"]["self_mean_ms"] < s["outer"]["mean_ms"] - 25
    assert s["inner"]["self_mean_ms"] == pytest.approx(s["inner"]["mean_ms"])


def test_a_disabled_timer_records_nothing():
    t = StageTimer(enabled=False)
    with t.span("a"):
        with t.span("b"):
            pass
    assert not t.samples and not t.records and t.stats() == {}


def test_the_buffer_is_bounded_and_keeps_the_latest_spans():
    t = StageTimer(buffer=8)
    for i in range(20):
        with t.span(f"s{i}"):
            pass
    assert [r[0] for r in t.records] == [f"s{i}" for i in range(12, 20)]
    assert len(t.samples) == 20  # the durations are all kept
    t.clear()
    assert not t.records and not t.samples and t.stats() == {}


def test_write_trace_writes_chrome_trace_events(tmp_path):
    t = StageTimer()
    with t.span("frame"):
        with t.span("stage"):
            pass
    path = tmp_path / "trace.json"
    assert t.write_trace(path) == 2
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(spans) == {"frame", "stage"}
    frame, stage = spans["frame"], spans["stage"]
    assert stage["args"]["parent"] == frame["args"]["id"] == stage["args"]["root"]
    assert frame["ts"] <= stage["ts"] and stage["ts"] + stage["dur"] <= frame["ts"] + frame["dur"]
    assert abs(frame["ts"] * 1e3 - time.time_ns()) < 60e9  # µs since the epoch
    names = [e for e in events if e["ph"] == "M"]
    assert [e["args"]["name"] for e in names] == [threading.current_thread().name]


@pytest.fixture
def fake_capture(monkeypatch):
    """solver/graphs.py's graphed path on the CPU, its capture a stand-in."""

    class Graph:
        def __init__(self, fn):
            self.fn = fn

        def replay(self):
            self.fn()

    monkeypatch.setattr(graphs, "graphed", lambda device, eager: not eager)
    monkeypatch.setattr(graphs, "_new_pool", lambda: None)
    monkeypatch.setattr(graphs, "_capture_graph", lambda fn, pool: Graph(fn))
    graphs.clear()
    GLOBAL_TIMER.clear()
    yield
    graphs.clear()


def test_graph_spans_follow_the_cache_eviction(fake_capture):
    """Each new entry warms and captures its step; an entry that the cache
    dropped past MAX_ENTRIES and that comes back captures as a recapture;
    replays are not spanned; `clear` forgets the dropped keys."""
    runs = []

    def solve(key):
        program = graphs.entry("kind", (key,), lambda p: p, "cpu", eager=False)
        for _ in range(3):  # warm-up, capture, replay
            program.run("step", lambda: runs.append(key))

    keys = list(range(graphs.MAX_ENTRIES + 1)) + [0, 1]
    for key in keys:
        solve(key)
    assert runs == [k for k in keys for _ in range(3)]  # the capture replays once
    spans = [name for name, *_ in GLOBAL_TIMER.records]
    fresh = ["graph.warm", "graph.capture"]
    assert spans == fresh * (graphs.MAX_ENTRIES + 1) + ["graph.warm", "graph.recapture"] * 2
    solve(1)  # still cached: replays only
    assert len(GLOBAL_TIMER.records) == len(spans)
    graphs.clear()
    solve(0)
    assert [name for name, *_ in GLOBAL_TIMER.records][len(spans):] == fresh


def test_loop_closer_spans():
    """`lc.run_once` holds the closer's stages (the detection and correction
    from 12 keyframes on, the database insert always); a call that finds the
    queue empty opens no span."""
    calls = []
    closer = SimpleNamespace(
        queue=[], map=SimpleNamespace(n_keyframes=lambda: n_kf),
        detect_common_regions=lambda kf: calls.append("detect") or ("loop_kf", "S12"),
        correct_loop=lambda kf, loop_kf, S12: calls.append("correct"),
        kfdb=SimpleNamespace(add=lambda kf: calls.append("add")))
    GLOBAL_TIMER.clear()
    n_kf = 12
    assert LoopClosing.run_once(closer) is False
    assert not GLOBAL_TIMER.records
    closer.queue += ["kf0"]
    assert LoopClosing.run_once(closer) is True
    n_kf = 11
    closer.queue += ["kf1"]
    assert LoopClosing.run_once(closer) is True
    assert calls == ["detect", "correct", "add", "add"]
    rec = by_name(GLOBAL_TIMER)
    runs = rec["lc.run_once"]
    assert len(runs) == 2 and [len(rec[n]) for n in ("lc.detect", "lc.correct")] == [1, 1]
    assert {s[4] for n in ("lc.detect", "lc.correct") for s in rec[n]} == {runs[0][3]}
    assert [s[4] for s in rec["lc.kfdb_add"]] == [r[3] for r in runs]


def test_every_span_of_a_frame_shares_the_frame_root():
    """`sys.frame` is the root of `System.track_multicamera`'s spans, the
    sequential schedule's local mapping and loop closing included."""
    timer = GLOBAL_TIMER

    def grab_frame(frame):
        with timer.span("track.stage"):
            return "OK"

    mapped = []

    def map_once():
        with timer.span("lm.stage"):
            mapped.append(1)
        return len(mapped) < 2

    system = SimpleNamespace(
        _raise_worker_error=lambda: None, threaded=False,
        atlas=SimpleNamespace(active=SimpleNamespace(mutex=contextlib.nullcontext())),
        tracker=SimpleNamespace(grab_frame=grab_frame),
        local_mapper=SimpleNamespace(run_once=map_once), loop_closer=None)
    timer.clear()
    assert System.track_multicamera(system, frame=None) == "OK"
    rec = by_name(timer)
    (root,), stages = rec["sys.frame"], rec["track.stage"] + rec["lm.stage"]
    assert root[4] == -1 and len(stages) == 3
    assert {s[4] for s in stages} == {s[5] for s in stages} == {root[3]}
