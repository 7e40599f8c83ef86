"""kf_mapping_ms: the top-level `lm.*` spans summed over the window, per
keyframe that local mapping processed in it."""

from benchmark.metrics._spans import MAPPING_TOP, count, total_ms


def read(rec: dict, name: str):
    n = count(rec, "lm.process_new_kf")
    return total_ms(rec, MAPPING_TOP) / n if n else None
