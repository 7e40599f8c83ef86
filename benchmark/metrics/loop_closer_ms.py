"""loop_closer_ms: the loop closer's work on a keyframe, from the program's
own span (`lc.run_once`: the keyframe database query, the consistency check
and, on a detection, the Sim3 solve and the correction; a call that finds
its queue empty is not spanned), per keyframe it took in the window."""

from benchmark.metrics._spans import count, total_ms

SPAN = "lc.run_once"


def read(rec: dict, name: str):
    n = count(rec, SPAN)
    return total_ms(rec, (SPAN,)) / n if n else None
