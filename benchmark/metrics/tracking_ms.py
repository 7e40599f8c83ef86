"""tracking_ms: the top-level `track.*` spans (motion model, reference
keyframe, local map, keyframe creation) summed over the window, per frame."""

from benchmark.metrics._spans import TRACK_TOP, total_ms


def read(rec: dict, name: str):
    n = len(rec["units"]) if rec["unit"] == "frame" else 0
    return total_ms(rec, TRACK_TOP) / n if n else None
