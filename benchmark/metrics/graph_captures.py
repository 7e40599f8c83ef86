"""graph_captures: CUDA graphs captured during the window (the program's
`solver/graphs.counts()`): solves that met a new shape after set-up."""


def read(rec: dict, name: str):
    return float(rec["graphs"]["captures"]) if rec["unit"] == "frame" else None
