"""The fused GP-interpolation chain: hand-written CUDA kernel + plain version.

Port of `amcslam_tpu/ops/pallas_chain.py` (`gp_interp_packs`, whose Pallas
body `_chain_kernel` becomes `amcslam_tpu_torch/csrc/interp_chain.cu`).
Per (pose-pair, camera-time) combo it computes `gp_pair_pack` followed by
`gp_interp_pack` (factors/reprojection.py) and returns
{"Twb" (S,4,4), "Tbw" (S,4,4), "Q" (S,6,24)} in the reference's layout.

Three entries differ only in where a combo's endpoint states come from; the
kernel reads them in place, so no gathered or expanded copies are made:
- `gp_interp_packs(T1, v1, T2, v2, t1, t2, t)`: one row per combo;
- `gp_interp_packs_indexed(T, v, times, i, j, t)`: rows `i[s]` and `j[s]` of
  one state table (the local BA's combos);
- `gp_interp_packs_pair(T, v, t1, t2, t)`: one pose pair (rows 0 and 1 of
  T and v) for every combo (the pose solver's table branch).
Each takes the kernel for CUDA tensors and its plain PyTorch version (the
`*_ref` of the same name: the gather or expand, then `gp_interp_packs_ref`)
for CPU tensors; there is no fallback between them. In the reference the
kernel is opt-in and the XLA op chain is the default; here the kernel is the
main path for every CUDA tensor, because in eager PyTorch the op chain costs
several hundred small launches per call.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from .. import _build
from ..factors import reprojection

# Launches of the CUDA kernel since import (or since `reset_launches`): lets
# a run show that the main path went through the kernel. `BY_SIZE` holds the
# same launches by entry and size ("indexed S=1024"). A launch inside a CUDA
# graph capture (solver/graphs.py) runs at every replay of the graph, not at
# the capture: the capture records it (`recording`) and each replay adds
# the graph's record (`count_replay`). The threaded pipeline launches from
# two threads, so the counts are taken under a lock.
LAUNCHES = 0
BY_SIZE: dict[str, int] = {}
_LAUNCHES_LOCK = threading.Lock()
_RECORD = threading.local()

_LIB_NAME = "interp_chain"
# per endpoint: T, v, times, rows (or NULL), step, table length
_END = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
_SIGNATURE = _END * 2 + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_FN = {torch.float32: "interp_chain_f32", torch.float64: "interp_chain_f64"}
_LIB = None
_LIB_LOCK = threading.Lock()


def gp_interp_packs_ref(T1, v1, T2, v2, t1, t2, t):
    """Plain PyTorch version: batched gp_pair_pack + gp_interp_pack."""
    pack = reprojection.gp_pair_pack(T1, v1, T2, v2)
    return reprojection.gp_interp_pack(pack, T1, v1, t1, t2, t)


def gp_interp_packs_indexed_ref(T, v, times, i, j, t):
    """Plain version of `gp_interp_packs_indexed`: gather, then the chain."""
    return gp_interp_packs_ref(T[i], v[i], T[j], v[j], times[i], times[j], t)


def gp_interp_packs_pair_ref(T, v, t1, t2, t):
    """Plain version of `gp_interp_packs_pair`: one row per combo, then the
    chain."""
    S = t.shape[0]
    T1, v1, T2, v2, t1, t2 = (a.expand(S, *a.shape).contiguous()
                              for a in (T[0], v[0], T[1], v[1], t1, t2))
    return gp_interp_packs_ref(T1, v1, T2, v2, t1, t2, t)


def _check(what: str, t, args) -> None:
    """(name, tensor, shape) triples: shapes, one float dtype and one device
    for every argument."""
    if t.dtype not in _FN:
        raise ValueError(f"{what} takes float32 or float64, got {t.dtype}")
    dev = t.device
    for k, a, shape in args:
        if a.shape != shape:
            raise ValueError(f"{what}: {k} must be {shape}, got {tuple(a.shape)}")
        if a.dtype is not t.dtype:
            raise ValueError(f"{what}: {k} has dtype {a.dtype}, t has {t.dtype}")
        if a.device != dev:
            raise ValueError(f"{what}: {k} is on {a.device}, t on {dev}")


def _check_rows(what: str, rows, n: int, device) -> None:
    """(name, index) pairs: int64 on the tables' device; on the CPU also in
    range (on the card the kernel stops with a device-side assert instead,
    which costs no device-to-host read)."""
    for k, r in rows:
        if r.dtype is not torch.int64:
            raise ValueError(f"{what}: {k} must be int64, got {r.dtype}")
        if r.device != device:
            raise ValueError(f"{what}: {k} is on {r.device}, the tables on {device}")
        if device.type == "cpu" and r.numel() and not (0 <= int(r.min()) and int(r.max()) < n):
            raise ValueError(f"{what}: {k} indexes outside the table of {n} rows")


def _library() -> ctypes.CDLL:
    """The kernel library, built, loaded and bound on first use."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = _build.load(_LIB_NAME)
                for fn in _FN.values():
                    f = getattr(lib, fn)
                    f.argtypes = _SIGNATURE
                    f.restype = ctypes.c_int
                lib.interp_chain_empty.argtypes = [ctypes.c_void_p]
                lib.interp_chain_empty.restype = ctypes.c_int
                _LIB = lib
    return _LIB


def _bind(end1, end2, t):
    """(kernel function, its arguments, the packs it writes) of one launch
    on the current stream. An endpoint is (T, v, times, rows or None, step,
    first): combo s reads row rows[s] of the tables, or first + s * step of
    T and v and s * step of times. The packs are views of one output
    buffer."""
    if t.device.type != "cuda":
        raise ValueError(f"the chain kernel runs on cuda, not {t.device}")
    S = t.shape[0]
    args = []
    for T, v, times, rows, step, first in (end1, end2):
        ins = (T, v, times) if rows is None else (T, v, times, rows)
        if not all(a.is_contiguous() for a in ins):
            raise ValueError("the chain kernel's inputs must be contiguous")
        size = T.element_size()
        args += [T.data_ptr() + 16 * size * first, v.data_ptr() + 6 * size * first,
                 times.data_ptr(), None if rows is None else rows.data_ptr(), step,
                 T.shape[0] - first]
    if not t.is_contiguous():
        raise ValueError("the chain kernel's inputs must be contiguous")
    out = torch.empty(176 * S, dtype=t.dtype, device=t.device)
    packs = {"Twb": out.as_strided((S, 4, 4), (16, 4, 1), 0),
             "Tbw": out.as_strided((S, 4, 4), (16, 4, 1), 16 * S),
             "Q": out.as_strided((S, 6, 24), (144, 24, 1), 32 * S)}
    args += [t.data_ptr(), out.data_ptr(), S, torch.cuda.current_stream(t.device).cuda_stream]
    return getattr(_library(), _FN[t.dtype]), args, packs


def reset_launches() -> None:
    """Set `LAUNCHES` to 0 and empty `BY_SIZE`."""
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES = 0
        BY_SIZE.clear()


def count_replay(record: dict) -> None:
    """Add one replay of a captured graph: `record` maps "entry S=n" to the
    launches the graph holds."""
    global LAUNCHES
    if not record:
        return
    with _LAUNCHES_LOCK:
        for key, n in record.items():
            LAUNCHES += n
            BY_SIZE[key] = BY_SIZE.get(key, 0) + n


@contextlib.contextmanager
def recording():
    """While the body runs (a CUDA graph capture in this thread), launches
    are recorded in the yielded dict instead of counted."""
    _RECORD.counts = rec = {}
    try:
        yield rec
    finally:
        _RECORD.counts = None


def _count(entry: str, S: int) -> None:
    rec = getattr(_RECORD, "counts", None)
    key = f"{entry} S={S}"
    if rec is not None:
        rec[key] = rec.get(key, 0) + 1
    else:
        count_replay({key: 1})


def _launch(end1, end2, t, entry="packs"):
    """One kernel launch (see `_bind`) for the named entry; returns the packs."""
    fn, args, packs = _bind(end1, end2, t)
    if t.shape[0] == 0:
        return packs
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"interp_chain kernel launch failed: CUDA error {rc}")
    _count(entry, t.shape[0])
    return packs


def gp_interp_packs(T1, v1, T2, v2, t1, t2, t):
    """Per-combo interp packs {"Twb", "Tbw", "Q"} from the endpoint states
    T1/T2 (S,4,4), v1/v2 (S,6) and times t1/t2/t (S,).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (inputs must be contiguous) or raise."""
    S = t.shape[0] if t.ndim == 1 else -1
    _check("gp_interp_packs", t,
           (("T1", T1, (S, 4, 4)), ("v1", v1, (S, 6)), ("T2", T2, (S, 4, 4)),
            ("v2", v2, (S, 6)), ("t1", t1, (S,)), ("t2", t2, (S,)), ("t", t, (S,))))
    if t.device.type == "cpu":
        return gp_interp_packs_ref(T1, v1, T2, v2, t1, t2, t)
    return _launch((T1, v1, t1, None, 1, 0), (T2, v2, t2, None, 1, 0), t)


def gp_interp_packs_indexed(T, v, times, i, j, t):
    """Interp packs of the combos (T[i[s]], T[j[s]], t[s]): T (N,4,4), v (N,6),
    times (N,) state tables, i/j (S,) int64 rows, t (S,) query times.

    CPU tensors run `gp_interp_packs_indexed_ref`; CUDA tensors launch the
    kernel, which reads the rows in place, or raise."""
    S = t.shape[0] if t.ndim == 1 else -1
    N = T.shape[0] if T.ndim == 3 else -1
    _check("gp_interp_packs_indexed", t,
           (("T", T, (N, 4, 4)), ("v", v, (N, 6)), ("times", times, (N,)), ("t", t, (S,))))
    for k, r in (("i", i), ("j", j)):
        if r.shape != (S,):
            raise ValueError(f"gp_interp_packs_indexed: {k} must be {(S,)}, got {tuple(r.shape)}")
    _check_rows("gp_interp_packs_indexed", (("i", i), ("j", j)), N, t.device)
    if t.device.type == "cpu":
        return gp_interp_packs_indexed_ref(T, v, times, i, j, t)
    return _launch((T, v, times, i, 0, 0), (T, v, times, j, 0, 0), t, "indexed")


def gp_interp_packs_pair(T, v, t1, t2, t):
    """Interp packs of one pose pair at S query times: T (2,4,4) and v (2,6)
    the pair's poses and twists (rows 0 and 1), t1/t2 () their times, t (S,).

    CPU tensors run `gp_interp_packs_pair_ref`; CUDA tensors launch the
    kernel, which reads the pair in place, or raise."""
    S = t.shape[0] if t.ndim == 1 else -1
    _check("gp_interp_packs_pair", t,
           (("T", T, (2, 4, 4)), ("v", v, (2, 6)), ("t1", t1, ()), ("t2", t2, ()),
            ("t", t, (S,))))
    if t.device.type == "cpu":
        return gp_interp_packs_pair_ref(T, v, t1, t2, t)
    return _launch((T, v, t1, None, 0, 0), (T, v, t2, None, 0, 1), t, "pair")
