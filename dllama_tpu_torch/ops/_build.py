"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. `build_all` starts one ``nvcc`` per source at once and waits for
all of them.

Every C entry takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; `check` raises on a
non-zero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = (
    "q40_matmul", "q40i4_matmul", "i8_matmul", "flash_attention", "flash_decode", "moe_active",
    "moe_grouped",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-lineinfo", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry of each source (same name) and its argument types
SIGNATURES = {
    "q40_matmul": [_P] * 4 + [_I] * 4 + [_P],
    "q40i4_matmul": [_P] * 4 + [_I] * 4 + [_P],
    "i8_matmul": [_P] * 5 + [_I] * 4 + [_P],
    "flash_attention": [_P] * 4 + [_I] + [_P] * 3 + [_I] * 6 + [_F, _I, _P],
    "flash_decode": [_P] * 4 + [_I, _P] + [_I] * 5 + [_F, _I, _P],
    "moe_active": [_P] * 11 + [_I] * 6 + [_P],
    "moe_grouped": [_P] * 13 + [_I] * 5 + [_P],
}
ENTRY = {"flash_attention": "flash_attention_stats"}

_libs: dict = {}  # source name -> loaded C entry
_lock = threading.Lock()
# ptxas report (registers, shared memory, spills) of each fresh build
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Popen of the nvcc build for ``name``, or None if it is built."""
    src, so = _target(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, started) -> None:
    proc, tmp, so = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    ptxas_log[name] = out
    os.replace(tmp, so)


def build_all() -> None:
    """Compile every kernel source in parallel (one nvcc each)."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)


def load(name: str):
    """The C entry of csrc/<name>.cu with its argument types set, building
    the library if needed."""
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(_target(name)[1])
            fn = getattr(lib, ENTRY.get(name, name))
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
