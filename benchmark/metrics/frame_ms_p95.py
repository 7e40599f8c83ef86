"""frame_ms_p95: the 95th percentile (linear interpolation) of every window
frame's latency, from the Frame handed over to the state returned."""

import numpy as np


def read(rec: dict, name: str):
    if rec["unit"] != "frame" or not rec["units"]:
        return None
    return float(np.percentile([u["ms"] for u in rec["units"]], 95))
