"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by its own
``nvcc`` process (all started together) into a shared library for Hopper
(``sm_90a``), then loaded with ``ctypes``. Libraries go to
``csrc/build/`` (listed in .gitignore) under a name that carries a hash of
the sources and flags, so an unchanged source is built once per checkout
and an edited one is rebuilt. Nothing is built when a module is imported:
the first kernel launch, or ``build_all()``, does it.

Every C entry point returns ``cudaGetLastError()`` after its launch;
the function ``entry`` gives for it raises when that is not 0.
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
from typing import Callable, Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], Callable[..., None]] = {}
# ptxas register / shared-memory / spill report of each build, by source.
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source not built yet, in parallel; load them all.
    Returns the seconds spent. Raises with nvcc's output on failure."""
    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in _sources():
            if src.stem in _libs:
                continue
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, p in procs:
            log, _ = p.communicate()
            build_log[src.stem] = log
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for src in _sources():
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(_lib_path(src)))
        return time.perf_counter() - t0


def _load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    if stem not in _libs:
        build_all()
    return _libs[stem]


def entry(stem: str, name: str, argtypes) -> Callable[..., None]:
    """C entry point ``name`` of ``csrc/<stem>.cu``, built and loaded on
    first use, as a function that raises when the entry point reports a
    CUDA error (a refused launch never runs, and a later synchronize would
    not report it). ``argtypes`` should give c_void_p for every pointer and
    the stream, so none is cut to 32 bits."""
    key = (stem, name)
    if key not in _entries:
        lib = _load(stem)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.tf_error_string.argtypes = [ctypes.c_int]
        lib.tf_error_string.restype = ctypes.c_char_p

        def call(*args) -> None:
            err = fn(*args)
            if err != 0:
                msg = lib.tf_error_string(err).decode()
                raise RuntimeError(f"{name}: CUDA error {err} ({msg})")

        _entries[key] = call
    return _entries[key]


def dtype_code(dtype) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]
