"""setup_s: process start to the first unit of the window (generation,
build, warm-up; compilation in a fresh checkout)."""


def read(rec: dict, name: str):
    return rec["setup_s"]
