"""loop_detect_ms: the loop closer's own work (its `run_once` calls: the
keyframe database query, the consistency check and, on a detection, the
Sim3 solve and the correction) per keyframe that local mapping handed it in
the window. The program has no span there; the benchmark times its calls
into the closer (`traffic/keypoint_drive.LOOP_CLOSER_SPAN`)."""

from benchmark.metrics._spans import count, total_ms
from benchmark.traffic.keypoint_drive import LOOP_CLOSER_SPAN


def read(rec: dict, name: str):
    n = count(rec, "lm.loop_closing")
    return total_ms(rec, (LOOP_CLOSER_SPAN,)) / n if n else None
