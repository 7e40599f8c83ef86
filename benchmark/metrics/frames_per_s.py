"""frames_per_s: frames completed in the window over the window's seconds
(the window closes at the end of its last frame)."""


def read(rec: dict, name: str):
    if rec["unit"] != "frame" or not rec["units"] or rec["window_s"] <= 0:
        return None
    return len(rec["units"]) / rec["window_s"]
