"""Sums of the program's stage-timer spans over the window."""

TRACK_TOP = ("track.motion_model", "track.ref_kf", "track.local_map", "track.create_kf")
MAPPING_TOP = ("lm.process_new_kf", "lm.cull_map_points", "lm.create_new_points",
               "lm.fuse_neighbors", "lm.local_ba", "lm.loop_closing")


def total_ms(rec: dict, names) -> float:
    return 1e3 * sum(sum(rec["spans"].get(n, ())) for n in names)


def count(rec: dict, name: str) -> int:
    return len(rec["spans"].get(name, ()))
