"""gba_s: the window's seconds over the solves completed in it; the window
closes at the end of the first solve that ends after --seconds, so the
closing solve counts whole."""


def read(rec: dict, name: str):
    if rec["unit"] != "solve" or not rec["units"]:
        return None
    return rec["window_s"] / len(rec["units"])
