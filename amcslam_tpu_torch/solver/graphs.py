"""CUDA-graph replay of the solvers' in-place steps: the port's counterpart
of the reference's `jax.jit` around a solve.

The reference compiles each per-frame and per-keyframe solve (the pose
solve, MC-RANSAC, the local BA) into one XLA program. Run eagerly, the same
solve issues thousands of small launches, each costing more host time than
the card spends on it. Here a solve is a few named steps that read and write
static buffers in place (solver/lm.py's LM steps, and each user's own); a
`Program` runs every step eagerly on its first call, captures it as a
`torch.cuda.CUDAGraph` on its second and replays the graph from then on. The
host keeps the loop control and reads one small packet per LM trial.

A solve's static buffers and its program form an entry, cached per thread by
its signature (every input's shape, dtype and device, and the static flags),
so two threads (the tracker and the mapper) never share a graph or its
buffers. Each thread captures and replays on a stream of its own, joined to
the caller's stream on entry and exit. The graphs of one entry share one
memory pool and allocate only temporaries in it: every buffer that outlives
a step is allocated outside any capture. A thread keeps at most `MAX_ENTRIES`
entries of each kind and drops the least recently used one, so a shape
bucket that the extraction's high-water mark has left behind frees its
graphs and buffers.

CPU tensors, and CUDA tensors when the caller passes `eager=True` (the
comparison path of chip_smoke.py), run the same steps as plain calls. A
failed capture or replay raises; nothing falls back to the eager path.

A capture is a solve's first calls at a new signature. While one runs in
a thread, another thread must not synchronize the whole device
(`torch.cuda.synchronize()` fails then, the capturing stream being
unsynchronizable); synchronizing a stream is fine, and every solve's work
ends on its caller's stream.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Any, Callable

import torch

from ..ops import interp_chain
from ..utils.timing import GLOBAL_TIMER

MAX_ENTRIES = 3  # per kind and thread

# Process-wide counts: graphs captured, graph replays, steps run eagerly.
CAPTURES = 0
REPLAYS = 0
EAGER_STEPS = 0
_COUNT_LOCK = threading.Lock()


def _bump(captures: int = 0, replays: int = 0, eager: int = 0) -> None:
    global CAPTURES, REPLAYS, EAGER_STEPS
    with _COUNT_LOCK:
        CAPTURES += captures
        REPLAYS += replays
        EAGER_STEPS += eager


def counts() -> dict:
    """The process-wide counts: captures, replays, eager steps and the
    number of cached entries in the calling thread."""
    return {"captures": CAPTURES, "replays": REPLAYS, "eager_steps": EAGER_STEPS,
            "entries": len(_local().entries)}


def graphed(device, eager: bool) -> bool:
    """True where a solve replays graphs: a CUDA device, unless the caller
    asked for the eager path."""
    return torch.device(device).type == "cuda" and not eager


# ---------------------------------------------------------------------------
# trees of tensors (tensors, None, tuples, NamedTuples, dicts)
# ---------------------------------------------------------------------------


def leaves(x) -> list:
    """The tensors of a tree, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None:
        return []
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, tuple):
        return [t for a in x for t in leaves(a)]
    raise TypeError(f"not a tree of tensors: {type(x)}")


def rebuild(like, ts):
    """The tree `like` with its tensors replaced by `ts` (an iterator)."""
    if isinstance(like, torch.Tensor):
        return next(ts)
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: rebuild(like[k], ts) for k in sorted(like)}
    items = [rebuild(a, ts) for a in like]
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def clone(x):
    """A copy of a tree with fresh tensors."""
    return rebuild(x, iter([t.clone() for t in leaves(x)]))


def copy_(dst, src) -> None:
    """Copy the tensors of `src` into the tree `dst` of the same structure."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        d.copy_(s)


def store(buf, value, static: bool):
    """`value` kept in the static buffer `buf`: a copy made on the first
    (eager) call, then copies into it. Without static buffers (a plain
    eager run) the value itself."""
    if not static:
        return value
    if buf is None:
        return clone(value)
    copy_(buf, value)
    return buf


def signature(*trees) -> tuple:
    """Shape, dtype and device of every tensor of the trees; None marks an
    absent optional field."""
    def sig(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype, x.device)
        if x is None:
            return None
        if isinstance(x, dict):
            return tuple((k, sig(x[k])) for k in sorted(x))
        if isinstance(x, tuple):
            return tuple(sig(a) for a in x)
        raise TypeError(f"not a tree of tensors: {type(x)}")
    return tuple(sig(t) for t in trees)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


class Program:
    """Named in-place steps over static buffers.

    Eager (`graphed=False`): every call of `run` is a plain call. Graphed:
    the first call of a step is a plain call (the warm-up a capture needs:
    the library handles and workspaces, and the static buffers, which the
    steps allocate on their first call); the second captures the step on
    the current stream into a graph of the program's pool; every call from
    then on replays it. A capture records no work, so the capturing call
    replays the graph once to do its step. The chain kernel's launches
    inside a capture are held by the graph and counted at every replay.

    The warm-up and capture calls are spanned (`graph.warm`,
    `graph.capture`; `graph.recapture` for a program whose entry the
    thread had dropped before, see `entry`); the replays are not."""

    def __init__(self, graphed: bool, recapture: bool = False):
        self.graphed = graphed
        self.recapture = recapture
        self.pool = _new_pool() if graphed else None
        self.steps: dict[str, Any] = {}  # name -> None (warm) or (graph, chain launches)

    def run(self, name: str, fn: Callable[[], None]) -> None:
        if not self.graphed:
            fn()
            _bump(eager=1)
            return
        if name not in self.steps:
            with GLOBAL_TIMER.span("graph.warm"):
                fn()
            self.steps[name] = None
            _bump(eager=1)
            return
        step = self.steps[name]
        if step is None:
            step = self.steps[name] = self._capture(fn)
        graph, chain = step
        graph.replay()
        interp_chain.count_replay(chain)
        _bump(replays=1)

    def _capture(self, fn):
        span = "graph.recapture" if self.recapture else "graph.capture"
        with GLOBAL_TIMER.span(span), interp_chain.recording() as chain:
            graph = _capture_graph(fn, self.pool)
        _bump(captures=1)
        return graph, dict(chain)


def _new_pool():
    """A memory pool for the graphs of one program."""
    return torch.cuda.graph_pool_handle()


def _capture_graph(fn, pool) -> torch.cuda.CUDAGraph:
    """`fn`'s work on the current stream, captured (not run) into a graph
    of `pool`. The capture mode is the thread's own, so that another
    thread's work meanwhile does not invalidate it."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        fn()
    finally:
        graph.capture_end()
    return graph


# ---------------------------------------------------------------------------
# per-thread cache of entries
# ---------------------------------------------------------------------------


class _Local(threading.local):
    def __init__(self):
        self.entries: OrderedDict = OrderedDict()
        self.dropped: set = set()  # keys of the entries dropped past MAX_ENTRIES
        self.streams: dict = {}


_LOCAL = _Local()


def _local() -> _Local:
    return _LOCAL


def clear() -> None:
    """Drop the calling thread's cached entries (their graphs and buffers),
    and forget which entries it had dropped."""
    _local().entries.clear()
    _local().dropped.clear()


def _stream(device) -> torch.cuda.Stream:
    loc = _local()
    s = loc.streams.get(device)
    if s is None:
        s = loc.streams[device] = torch.cuda.Stream(device)
    return s


def entry(kind: str, key: tuple, make: Callable[[Program], Any], device, eager: bool):
    """The entry of (kind, key): cached per thread when graphed (made by
    `make(program)` on first use, the least recently used entry of the
    kind dropped past MAX_ENTRIES), made anew for an eager run. The key
    takes in whether deterministic algorithms are on: a graph keeps the
    kernels it was captured with (index_add_ with atomics or sorted). The
    thread remembers the keys it dropped: an entry made again for one of
    them spans its captures as `graph.recapture`."""
    if not graphed(device, eager):
        return make(Program(False))
    loc = _local()
    entries = loc.entries
    full = (kind, key, torch.are_deterministic_algorithms_enabled())
    e = entries.get(full)
    if e is None:
        same = [k for k in entries if k[0] == kind]
        for k in same[: max(0, len(same) - MAX_ENTRIES + 1)]:
            del entries[k]
            loc.dropped.add(k)
        e = entries[full] = make(Program(True, recapture=full in loc.dropped))
    entries.move_to_end(full)
    return e


@contextlib.contextmanager
def on_stream(device, eager: bool):
    """Run the body on the calling thread's own stream when graphed (it
    waits for the caller's stream first, and the caller's stream waits for
    it after); as it is otherwise."""
    if not graphed(device, eager):
        yield
        return
    device = torch.device(device)
    caller = torch.cuda.current_stream(device)
    s = _stream(device)
    s.wait_stream(caller)
    try:
        with torch.cuda.stream(s):
            yield
    finally:
        caller.wait_stream(s)
