"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, under ``hdl_graph_slam_tpu_torch/_build/``
(git-ignored), keyed by the hash of the sources. The library is loaded with
``ctypes``; every pointer and the stream are passed as ``c_void_p``.

There is no fallback here: a missing ``nvcc`` or a failed build raises.
Callers reach this module only for CUDA tensors (ops/knn.py,
registration/ndt.py, registration/gicp.py); CPU tensors take the plain
PyTorch versions beside the wrappers.
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

SOURCES = ("knn", "ndt", "gicp")  # csrc/<name>.cu

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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library of these sources is
    already built; the library's path. Safe to run for different sources
    at the same time (each writes its own file, renamed into place)."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD / f"lib{name}_{digest}.so"
    if out.exists():
        build_info.setdefault(name, {"seconds": 0.0, "ptxas": "cached"})
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
    lib = _libs.get(name)  # loaded: no lock on the launch path
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
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
        lib.hgs_radius_count.argtypes = [p, i, p, i, ctypes.c_float, p, p, ctypes.c_uint, i, p, p, p]
        lib.hgs_radius_count.restype = i
        lib.hgs_radius_count_launch_info.argtypes = [i, i, p]
        lib.hgs_radius_count_launch_info.restype = i
        lib.hgs_knn_launch_info_batched.argtypes = [i, i, i, i, i, p]
        lib.hgs_knn_launch_info_batched.restype = i
    elif name == "ndt":
        f = ctypes.c_float
        lib.hgs_ndt_associate.argtypes = [p, p, p, i, i, i, p, f, p, i, p, p, i, p, p, p]
        lib.hgs_ndt_associate.restype = i
        lib.hgs_ndt_derivatives.argtypes = [p, p, p, i, i, i, p, p, p, f, f, i, p, p, p, p]
        lib.hgs_ndt_derivatives.restype = i
        lib.hgs_ndt_score.argtypes = [p, p, p, i, i, i, i, p, p, p, f, f, i, p, p, p, p]
        lib.hgs_ndt_score.restype = i
    elif name == "gicp":
        lib.hgs_gicp_step.argtypes = [p, p]  # a GicpArgs (registration/gicp.py), the stream
        lib.hgs_gicp_step.restype = i


def stream(x) -> int:
    """The current CUDA stream of tensor x's device, as the raw pointer the C
    entry points take (without building a torch.cuda.Stream per launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(x.device.index)


# (kind, device index, raw stream) -> (counters, scratch): a kernel's int32
# counters and float32 scratch, zeroed once here and left as the kernel's
# contract says by every launch. Launches on one stream run one after
# another, so every caller on that stream (the overlapped backend's thread
# included) can share them; a buffer is replaced only to grow.
workspaces: dict = {}


def workspace(x, stream: int, kind: str, ints: int, floats: int):
    """(counters, scratch) of ``kind`` for a launch on ``stream`` of x's
    device: at least ``ints`` int32 counters and ``floats`` float32 values."""
    import torch

    key = (kind, x.device.index, stream)
    counters, scratch = ws = workspaces.get(key, (None, None))
    if counters is None or counters.numel() < ints:
        counters = torch.zeros(max(ints, 64), dtype=torch.int32, device=x.device)
    if scratch is None or scratch.numel() < floats:
        scratch = torch.zeros(max(floats, 1 << 16), dtype=torch.float32, device=x.device)
    if ws[0] is not counters or ws[1] is not scratch:
        workspaces[key] = (counters, scratch)
    return counters, scratch


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
