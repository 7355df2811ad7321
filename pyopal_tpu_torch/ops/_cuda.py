"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C entry point, loaded with `ctypes` (no PyTorch headers, so a
build takes seconds).  Libraries go to `pyopal_tpu_torch._build.build_dir`
(``build/pyopal_tpu_torch/`` in a writable checkout).  They are
named by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads as it is.  Nothing builds at import: the
first CUDA tensor that reaches a kernel builds it, and `build_all`
builds every kernel at once, one ``nvcc`` process per source, all
started together.
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

import torch

from .._build import build_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = build_dir()
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: kernel name -> (C entry point, argument types after the pointers)
KERNELS = {
    "ragged": ("pyopal_ragged_launch", [_P] * 9 + [_I] * 12 + [_P]),
    "q8": ("pyopal_q8_launch", [_P] * 9 + [_I] * 12 + [_P]),
    "ragged_long": ("pyopal_ragged_long_launch", [_P] * 13 + [_I] * 11 + [_P]),
    "group": ("pyopal_group_launch", [_P] * 7 + [_I] * 12 + [_P]),
    "ragged_v1": ("pyopal_ragged_v1_launch", [_P] * 9 + [_I] * 12 + [_P]),
    "ragged_strip": ("pyopal_ragged_strip_launch", [_P] * 9 + [_I] * 12 + [_P]),
    "q8_narrow": ("pyopal_q8_narrow_launch", [_P] * 9 + [_I] * 13 + [_P]),
    "ragged_packed": ("pyopal_ragged_packed_launch", [_P] * 9 + [_I] * 13 + [_P]),
    "traceback_dirs": ("pyopal_traceback_dirs_launch", [_P] * 5 + [_I] * 9 + [_P]),
    "traceback_walk": ("pyopal_traceback_walk_launch", [_P] * 6 + [_I] * 7 + [_P]),
}

_LOCK = threading.Lock()
_FUNCS: dict = {}
#: seconds each kernel's build took in this process (0.0 = cached)
build_seconds: dict = {}
#: compiler output of each build in this process
build_logs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit"
        )
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one kernel; returns (process, tmp, lib) or
    None when the library is already built."""
    lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def _finish_build(name, started, t0):
    if started is None:
        build_seconds.setdefault(name, 0.0)
        return
    proc, tmp, lib = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0


def build_all(names=None) -> dict:
    """Build every kernel (or ``names``) in parallel; returns the
    seconds each build took (0.0 for a library already built)."""
    names = list(names or KERNELS)
    with _LOCK:
        t0 = time.perf_counter()
        started = {n: _start_build(n) for n in names}
        for n in names:
            _finish_build(n, started[n], t0)
    return {n: build_seconds[n] for n in names}


def _function(name: str):
    fn = _FUNCS.get(name)
    if fn is not None:
        return fn
    build_all([name])
    with _LOCK:
        symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(_library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream of its tensors'
    device.  Tensor arguments pass as device pointers, ints as ints;
    raises if the launch is refused (``cudaGetLastError``)."""
    fn = _function(name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_args = [
        a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args
    ]
    with torch.cuda.device(dev):
        err = fn(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
