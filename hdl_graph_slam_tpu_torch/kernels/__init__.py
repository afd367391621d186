"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, under ``hdl_graph_slam_tpu_torch/_build/``
(git-ignored), keyed by the hash of the sources. The library is loaded with
``ctypes``; every pointer and the stream are passed as ``c_void_p``.

There is no fallback here: a missing ``nvcc`` or a failed build raises.
Callers reach this module only for CUDA tensors (ops/knn.py); CPU tensors
take the plain PyTorch versions beside the wrappers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
# name -> {"seconds": build time (0.0 when the cached library was reused),
#          "ptxas": the compiler's register/shared-memory report}
build_info: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of hdl_graph_slam_tpu_torch need the CUDA toolkit")
    return found


def _build(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD / f"lib{name}_{digest}.so"
    if out.exists():
        build_info[name] = {"seconds": 0.0, "ptxas": "cached"}
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    build_info[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr.strip()}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "knn":
        lib.hgs_nn1.argtypes = [p, i, p, i, p, p, p]
        lib.hgs_nn1.restype = i
        lib.hgs_knn_select.argtypes = [p, i, p, i, i, p, p, p]
        lib.hgs_knn_select.restype = i
        lib.hgs_nn1_batched.argtypes = [p, i, i, p, i, p, p, p]
        lib.hgs_nn1_batched.restype = i
        lib.hgs_knn_select_batched.argtypes = [p, i, i, p, i, i, p, p, p]
        lib.hgs_knn_select_batched.restype = i
        lib.hgs_radius_count.argtypes = [p, i, p, i, ctypes.c_float, p, p]
        lib.hgs_radius_count.restype = i
        lib.hgs_knn_launch_info_batched.argtypes = [i, i, i, i, i, p]
        lib.hgs_knn_launch_info_batched.restype = i


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
