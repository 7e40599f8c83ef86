"""device_idle_pct.<cells>: the share of the traced window in which no
kernel, copy or fill ran on the card (the union of their intervals in the
profiler's trace). The traced run alone gives it; the profiler's own cost
on the host is inside the window it divides by."""


def read(rec: dict, name: str):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
