"""The fused GP-interpolation chain: hand-written CUDA kernel + plain version.

Port of `amcslam_tpu/ops/pallas_chain.py` (`gp_interp_packs`, whose Pallas
body `_chain_kernel` becomes `amcslam_tpu_torch/csrc/interp_chain.cu`).
Per (pose-pair, camera-time) combo it computes `gp_pair_pack` followed by
`gp_interp_pack` (factors/reprojection.py) and returns
{"Twb" (S,4,4), "Tbw" (S,4,4), "Q" (S,6,24)} in the reference's layout.

`gp_interp_packs` takes the kernel for CUDA tensors and the plain PyTorch
version `gp_interp_packs_ref` for CPU tensors; there is no fallback between
them. In the reference the kernel is opt-in and the XLA op chain is the
default; here the kernel is the main path for every CUDA tensor, because in
eager PyTorch the op chain costs several hundred small launches per call.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build
from ..factors import reprojection

# Launches of the CUDA kernel since import (or since a caller reset it):
# lets a run show that the main path went through the kernel. The threaded
# pipeline launches from two threads, so the count is taken under a lock.
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

_LIB_NAME = "interp_chain"
_SIGNATURE = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
_FN = {torch.float32: "interp_chain_f32", torch.float64: "interp_chain_f64"}


def gp_interp_packs_ref(T1, v1, T2, v2, t1, t2, t):
    """Plain PyTorch version: batched gp_pair_pack + gp_interp_pack."""
    pack = reprojection.gp_pair_pack(T1, v1, T2, v2)
    return reprojection.gp_interp_pack(pack, T1, v1, t1, t2, t)


def _check(T1, v1, T2, v2, t1, t2, t) -> int:
    if T1.ndim != 3:
        raise ValueError(f"T1 must be (S,4,4), got {tuple(T1.shape)}")
    S = T1.shape[0]
    shapes = {"T1": (S, 4, 4), "v1": (S, 6), "T2": (S, 4, 4), "v2": (S, 6),
              "t1": (S,), "t2": (S,), "t": (S,)}
    args = {"T1": T1, "v1": v1, "T2": T2, "v2": v2, "t1": t1, "t2": t2, "t": t}
    for k, a in args.items():
        if tuple(a.shape) != shapes[k]:
            raise ValueError(f"{k} must be {shapes[k]}, got {tuple(a.shape)}")
        if a.dtype != T1.dtype:
            raise ValueError(f"{k} has dtype {a.dtype}, T1 has {T1.dtype}")
        if a.device != T1.device:
            raise ValueError(f"{k} is on {a.device}, T1 on {T1.device}")
    if T1.dtype not in _FN:
        raise ValueError(f"gp_interp_packs takes float32 or float64, got {T1.dtype}")
    return S


def _library() -> ctypes.CDLL:
    lib = _build.load(_LIB_NAME)
    for fn in _FN.values():
        f = getattr(lib, fn)
        f.argtypes = _SIGNATURE
        f.restype = ctypes.c_int
    return lib


def gp_interp_packs(T1, v1, T2, v2, t1, t2, t):
    """Per-combo interp packs {"Twb", "Tbw", "Q"} from the endpoint states
    T1/T2 (S,4,4), v1/v2 (S,6) and times t1/t2/t (S,).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (inputs must be contiguous) or raise."""
    global LAUNCHES
    S = _check(T1, v1, T2, v2, t1, t2, t)
    if T1.device.type == "cpu":
        return gp_interp_packs_ref(T1, v1, T2, v2, t1, t2, t)
    if T1.device.type != "cuda":
        raise ValueError(f"gp_interp_packs runs on cpu or cuda, not {T1.device}")
    ins = (T1, v1, T2, v2, t1, t2, t)
    if not all(a.is_contiguous() for a in ins):
        raise ValueError("gp_interp_packs: CUDA inputs must be contiguous")
    opts = {"dtype": T1.dtype, "device": T1.device}
    out = {"Twb": torch.empty((S, 4, 4), **opts),
           "Tbw": torch.empty((S, 4, 4), **opts),
           "Q": torch.empty((S, 6, 24), **opts)}
    if S == 0:
        return out
    fn = getattr(_library(), _FN[T1.dtype])
    stream = torch.cuda.current_stream(T1.device).cuda_stream
    rc = fn(*(a.data_ptr() for a in ins),
            out["Twb"].data_ptr(), out["Tbw"].data_ptr(), out["Q"].data_ptr(),
            S, stream)
    if rc != 0:
        raise RuntimeError(f"interp_chain kernel launch failed: CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out
