"""refresh_ms: the map points' viewing-geometry refresh (`map.refresh_geometry`,
one batched call per map-changing stage: the stereo seeding of a new
keyframe, triangulation, fuse and the local BA's write-back), summed over the
window, per keyframe that local mapping processed in it. None where the
program has no such span or no keyframe fell in the window."""

from benchmark.metrics._spans import count, total_ms

SPAN = "map.refresh_geometry"


def read(rec: dict, name: str):
    n = count(rec, "lm.process_new_kf")
    return total_ms(rec, (SPAN,)) / n if n and count(rec, SPAN) else None
