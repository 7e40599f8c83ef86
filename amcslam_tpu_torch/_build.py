"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one `csrc/<name>.cu` with a plain C interface,
compiled by `nvcc` for Hopper (sm_90a) into a shared library and loaded with
`ctypes` (no PyTorch headers: the build takes seconds, not minutes).
Libraries go to `build/kernels/` at the repository root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused. There is no fallback: a missing `nvcc`, a failed build or a failed
load raises with the compiler's or loader's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_LIBS: dict[str, ctypes.CDLL] = {}


class BuildResult(NamedTuple):
    path: Path       # the shared library
    seconds: float   # compile time (0.0 when an existing build was reused)
    log: str         # nvcc's output, including the -Xptxas -v report


def _find_nvcc() -> str | None:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    return None


def _sources(name: str) -> list[Path]:
    main = CSRC_DIR / f"{name}.cu"
    if not main.is_file():
        raise FileNotFoundError(f"no kernel source {main}")
    return [main, *sorted(CSRC_DIR.glob("*.cuh"))]


def build(name: str) -> BuildResult:
    """Compile `csrc/<name>.cu` into `build/kernels/` unless an up-to-date
    library is there already. Raises RuntimeError if nvcc is missing or
    fails."""
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found: the CUDA kernel '{name}' is compiled from "
            f"{CSRC_DIR} with nvcc (CUDA toolkit for sm_90a); set CUDA_HOME "
            "or put nvcc on PATH"
        )
    srcs = _sources(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return BuildResult(out, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)
    log_path.write_text(log)
    return BuildResult(out, seconds, log)


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        res = build(name)
        try:
            lib = ctypes.CDLL(str(res.path))
        except OSError as e:
            raise RuntimeError(f"loading {res.path} failed: {e}") from e
        _LIBS[name] = lib
    return lib
