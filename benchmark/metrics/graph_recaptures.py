"""graph_recaptures: steps captured again in the window for an entry that its
thread had dropped past the cache's size (`graph.recapture` spans): the
captures that a larger cache would have saved, as against those of shapes
seen for the first time. None where the program records no frame root span
(`sys.frame`): it has no `graph.recapture` span either."""

from benchmark.metrics._spans import count


def read(rec: dict, name: str):
    if rec["unit"] != "frame" or not count(rec, "sys.frame"):
        return None
    return float(count(rec, "graph.recapture"))
