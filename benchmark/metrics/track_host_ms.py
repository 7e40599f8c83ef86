"""track_host_ms: the tracking solves' host halves, per frame: building the
MC-RANSAC rows and the pose problem on the host and writing their answers
back (`tlm.ransac_extract`, `tlm.ransac_apply`, `tlm.pose_extract`,
`tlm.pose_apply`). The solves themselves and their reads
(`tlm.ransac_solve`, `tlm.pose_lm`) are left out. None where the program has
none of these spans."""

from benchmark.metrics._spans import count, total_ms

SPANS = ("tlm.ransac_extract", "tlm.ransac_apply", "tlm.pose_extract", "tlm.pose_apply")


def read(rec: dict, name: str):
    n = len(rec["units"]) if rec["unit"] == "frame" else 0
    if not n or not any(count(rec, s) for s in SPANS):
        return None
    return total_ms(rec, SPANS) / n
