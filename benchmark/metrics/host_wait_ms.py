"""host_wait_ms: the host's blocking device-to-host reads, per frame
(`host.read`: each LM trial's packet, every `convert.fetch` of an answer,
the matcher's reductions). A read waits for the work queued before it, so
this is how long the host waits on the card at its reads. Other syncs (a
copy from pageable host memory to the card waits for its stream too) are
not spanned. None where the program has no such span."""

from benchmark.metrics._spans import count, total_ms

SPAN = "host.read"


def read(rec: dict, name: str):
    n = len(rec["units"]) if rec["unit"] == "frame" else 0
    return total_ms(rec, (SPAN,)) / n if n and count(rec, SPAN) else None
