"""local_map_search_ms: the `tlm.search_points` span (projecting the local
map into the frame and matching) over the window, per frame."""

from benchmark.metrics._spans import total_ms


def read(rec: dict, name: str):
    n = len(rec["units"]) if rec["unit"] == "frame" else 0
    return total_ms(rec, ("tlm.search_points",)) / n if n else None
