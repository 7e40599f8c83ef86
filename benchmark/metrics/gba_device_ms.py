"""gba_device_ms: the card's busy time (kernels, copies, fills) in the
traced window, per solve traced."""


def read(rec: dict, name: str):
    tr = rec.get("trace")
    if rec["unit"] != "solve" or not tr or not tr["units"]:
        return None
    return 1e3 * tr["busy_s"] / tr["units"]
