"""chain_roofline_pct: the GP-interpolation chain kernel
(`csrc/interp_chain.cu`) against its roofline over the traced window.

The least time of each launch is the larger of its bytes over the card's
HBM bandwidth and its operations over the float peak (`benchmark/peaks.json`);
the share is the sum of those over the kernel's device time in the trace.
Launches come from the program's counter of launches by entry and size
(replays of captured graphs included). Bytes count every input value that
the combos need read once and every output written once (the program's
`chip_smoke.chain_bound`, frozen here): per combo its query time and its 176
output values (Twb, Tbw, Q), the int64 index pair of the `indexed` entry,
and 19 values (R|t, v, time) per distinct state row. The rows an `indexed`
launch reads are not in the counter: two are counted, which is a floor, so
the share is never overstated.
"""

import json
from pathlib import Path

ROW_VALUES = 12 + 6 + 1
OUT_VALUES = 16 + 16 + 144
FLOP_PER_COMBO = 2700  # counted from csrc/interp_chain.cu (chip_smoke.py phase 10)
KERNEL = "chain_kernel"
PEAKS = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())


def launch_bound_s(entry: str, S: int, esize: int, dtype: str) -> float:
    rows = 2 * S if entry == "packs" else 2
    index_bytes = 16 * S if entry == "indexed" else 0
    nbytes = esize * (ROW_VALUES * rows + S + OUT_VALUES * S) + index_bytes
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               FLOP_PER_COMBO * S / PEAKS["flops_per_s"][dtype])


def read(rec: dict, name: str):
    tr = rec.get("trace")
    if not tr:
        return None
    device_s = sum(s for k, s in tr["kernel_s"].items() if KERNEL in k)
    launches = tr.get("chain_by_size") or {}
    if device_s <= 0 or not launches:
        return None
    dtype = rec["dtype"]
    esize = {"float32": 4, "float64": 8}[dtype]
    least = 0.0
    for key, n in launches.items():
        entry, size = key.split(" S=")
        least += n * launch_bound_s(entry, int(size), esize, dtype)
    return 100.0 * least / device_s
