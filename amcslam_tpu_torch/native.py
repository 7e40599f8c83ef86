"""The reference's native (C++) matcher, graph builder and ORB extractor,
built for the port.

Port of `amcslam_tpu/native/__init__.py:20-162`. There are two C++ sources,
the port's own `csrc/graph_builder.cpp` and `csrc/orb_fast.cpp`: byte-for-byte
copies of the reference's `amcslam_tpu/native/graph_builder.cpp` and
`orb_fast.cpp` (tests/test_torch_guards.py pins them equal), so the port
builds nothing from the reference's tree. Each is compiled with g++ into
`build/native/` at the repository root, named by a hash of the source and
the interpreter's extension suffix, and imported as the extension module
`_<name>`.

`available(name)` is False only when there is no `g++` on the PATH; then the
matcher takes its torch bit-plane path (pipeline/matcher.py) and the host ORB
its numpy path (frontend/orb.py). A compiler that is present but fails raises
with its output: there is no silent fallback.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SOURCES = {name: PKG_DIR / "csrc" / f"{name}.cpp" for name in ("graph_builder", "orb_fast")}
SOURCE = SOURCES["graph_builder"]
BUILD_DIR = PKG_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
# orb_fast.cpp promises the numpy oracle's float64 arithmetic operation for
# operation (its header); g++ would otherwise fuse multiply-adds into FMAs
# under -march=native, and the pyramid's bilinear weights and the BRIEF
# rotation then round a few pixels and samples to the other integer
EXTRA_FLAGS = {"orb_fast": ("-ffp-contract=off",)}

_lock = threading.Lock()
_mods: dict = {}


def build(name: str = "graph_builder") -> Path:
    """Compile the source `name` into `build/native/` unless an up-to-date
    module is there already; returns its path. Raises RuntimeError if g++ is
    missing or fails."""
    source = SOURCES[name]
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native module is compiled from {source}")
    flags = CXX_FLAGS + EXTRA_FLAGS.get(name, ())
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = BUILD_DIR / f"_{name}_{tag}{suffix}"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a process-private name and rename into place (atomic in a
    # directory), so a concurrent process never imports a partial file
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, f"-I{sysconfig.get_paths()['include']}", str(source),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _require(name: str = "graph_builder"):
    """The extension module `name`, built and imported on first use."""
    with _lock:
        if name not in _mods:
            path = build(name)
            spec = importlib.util.spec_from_file_location(f"_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mods[name] = mod
    return _mods[name]


def available(name: str = "graph_builder") -> bool:
    """True when the module builds and loads; False only without g++."""
    if name not in _mods and shutil.which("g++") is None:
        return False
    _require(name)
    return True


def orb_extract(img: np.ndarray, n_levels: int, scale_factor: float,
                ini_th: int, min_th: int, budgets: np.ndarray,
                pattern: np.ndarray, patch_off: np.ndarray):
    """Native full-pyramid ORB extraction (csrc/orb_fast.cpp). Returns
    (xy (N,2) float64 level-0 px, octave (N,) int64, desc (N,32) uint8,
    angle (N,) float64)."""
    mod = _require("orb_fast")
    xy_b, oc_b, de_b, an_b = mod.extract(
        np.ascontiguousarray(img, np.uint8), int(n_levels),
        float(scale_factor), int(ini_th), int(min_th),
        np.ascontiguousarray(budgets, np.int32),
        np.ascontiguousarray(pattern, np.int32),
        np.ascontiguousarray(patch_off, np.int32),
    )
    xy = np.frombuffer(xy_b, np.float64).reshape(-1, 2).copy()
    oc = np.frombuffer(oc_b, np.int32).astype(np.int64)
    de = np.frombuffer(de_b, np.uint8).reshape(-1, 32).copy()
    an = np.frombuffer(an_b, np.float64).copy()
    return xy, oc, de, an


def build_obs_edges(matches, kf_of_kp, cam_of_kp, prev_slot,
                    lm_keys, lm_vals, stereo_cam: int):
    """Native observation-edge extraction. Returns (mono (Em,5), stereo (Es,3))
    float64 arrays with rows [i, j, lm, cam, kp_index] / [pose, lm, kp_index]."""
    mod = _require()
    mono_b, st_b = mod.build_obs_edges(
        np.ascontiguousarray(matches, np.int64),
        np.ascontiguousarray(kf_of_kp, np.int32),
        np.ascontiguousarray(cam_of_kp, np.int32),
        np.ascontiguousarray(prev_slot, np.int32),
        np.ascontiguousarray(lm_keys, np.int64),
        np.ascontiguousarray(lm_vals, np.int32),
        int(stereo_cam),
    )
    mono = np.frombuffer(mono_b, np.float64).reshape(-1, 5)
    st = np.frombuffer(st_b, np.float64).reshape(-1, 3)
    return mono, st


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Native popcount Hamming table for (N,32)x(M,32) uint8 descriptors."""
    mod = _require()
    out = mod.hamming_matrix(
        np.ascontiguousarray(a, np.uint8), np.ascontiguousarray(b, np.uint8)
    )
    return np.frombuffer(out, np.int32).reshape(len(a), len(b)).copy()


def match_window(u, v, valid, r_pt, lvl_lo, lvl_hi, ur_pred, mp_desc,
                 kp_u, kp_v, kp_oct, kp_r, kp_ur, kp_desc,
                 max_dist: int, ratio: float = 0.0,
                 use_pt_radius: bool = True, use_ur: bool = False):
    """Projection-window descriptor matching over a sorted-u keypoint index
    (the native form of the ORBmatcher SearchByProjection window walks).
    Returns (best_j (M,) int64 with -1 for none, best_d (M,) int32)."""
    mod = _require()
    f32c = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    i32c = lambda x: np.ascontiguousarray(x, np.int32)  # noqa: E731
    bj_b, bd_b = mod.match_window(
        f32c(u), f32c(v), np.ascontiguousarray(valid, np.uint8), f32c(r_pt),
        i32c(lvl_lo), i32c(lvl_hi), f32c(ur_pred),
        np.ascontiguousarray(mp_desc, np.uint8),
        f32c(kp_u), f32c(kp_v), i32c(kp_oct), f32c(kp_r), f32c(kp_ur),
        np.ascontiguousarray(kp_desc, np.uint8),
        int(max_dist), float(ratio), int(use_pt_radius), int(use_ur),
    )
    bj = np.frombuffer(bj_b, np.int32).astype(np.int64)
    bd = np.frombuffer(bd_b, np.int32).copy()
    return bj, bd


def hamming_best(a: np.ndarray, b: np.ndarray):
    """Fused nearest/second-nearest Hamming reduction: for each row of `a`,
    the index + distance of its closest descriptor in `b` and the
    second-closest distance — O(N+M) memory, threaded over rows, never
    materializing the (N,M) table. Returns (best_j, best_d, second_d)."""
    mod = _require()
    bj_b, bd_b, sd_b = mod.hamming_best(
        np.ascontiguousarray(a, np.uint8), np.ascontiguousarray(b, np.uint8)
    )
    bj = np.frombuffer(bj_b, np.int32).astype(np.int64)
    bd = np.frombuffer(bd_b, np.int32).copy()
    sd = np.frombuffer(sd_b, np.int32).copy()
    return bj, bd, sd
