"""capture_ms: the host time of CUDA-graph warm-up and capture, per frame:
each step's first (eager) call on a new entry and its capture, whether the
entry is new (`graph.warm`, `graph.capture`) or one the thread had dropped
and made again (`graph.recapture`). None where the program records no frame
root span (`sys.frame`): it has none of these spans either."""

from benchmark.metrics._spans import count, total_ms

SPANS = ("graph.warm", "graph.capture", "graph.recapture")


def read(rec: dict, name: str):
    n = len(rec["units"]) if rec["unit"] == "frame" else 0
    if not n or not count(rec, "sys.frame"):
        return None
    return total_ms(rec, SPANS) / n
