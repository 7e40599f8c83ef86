"""What the benchmark reads from the program: its stage timer's spans, its
graph counters and the chain kernel's launches by entry and size. Read as
the program keeps them, differenced over the window; nothing is written
into the program. The program is imported here only when a run asks."""

from __future__ import annotations


def timer():
    from amcslam_tpu_torch.utils.timing import GLOBAL_TIMER

    return GLOBAL_TIMER


def snapshot() -> dict:
    from amcslam_tpu_torch.ops import interp_chain
    from amcslam_tpu_torch.solver import graphs

    return {"spans": {k: len(v) for k, v in timer().samples.items()},
            "graphs": dict(graphs.counts()), "chain_by_size": dict(interp_chain.BY_SIZE)}


def since(snap: dict) -> dict:
    """Spans recorded, graph counts and chain launches added since `snap`."""
    now = snapshot()
    samples = timer().samples
    spans = {k: list(v[snap["spans"].get(k, 0):]) for k, v in samples.items()}
    return {
        "spans": {k: v for k, v in spans.items() if v},
        "graphs": {k: now["graphs"][k] - snap["graphs"].get(k, 0)
                   for k in ("captures", "replays", "eager_steps")},
        "chain_by_size": {k: n - snap["chain_by_size"].get(k, 0)
                          for k, n in now["chain_by_size"].items()
                          if n != snap["chain_by_size"].get(k, 0)},
    }
