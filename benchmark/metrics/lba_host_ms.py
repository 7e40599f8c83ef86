"""lba_host_ms: the local BA's host side, `lm.ba_extract` + `lm.ba_apply`,
per local BA run in the window."""

from benchmark.metrics._spans import count, total_ms


def read(rec: dict, name: str):
    n = count(rec, "lm.ba_extract")
    return total_ms(rec, ("lm.ba_extract", "lm.ba_apply")) / n if n else None
