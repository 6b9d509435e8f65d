"""The host runtime's C++ library, loaded with ctypes (port of
tinyfusers_tpu/native/__init__.py).

``libtfnative.so`` holds the BPE merge loop (tokenizer/native.py), the
continuous-batching scheduler core (serve/engine.py) and the record
loader, from the repository's ``native/bpe.cpp``, ``scheduler.cpp`` and
``loader.cpp``. It is built at first use with ``g++`` into
``native/build/`` beside this file (listed in .gitignore), under a name
that carries a hash of the sources and flags, so an edited source is
rebuilt; ``native/Makefile`` is not used, since it writes into the JAX
package. Nothing is built when the module is imported.

``get_lib()`` is None when the library cannot be built or loaded (no
compiler): every consumer then takes its pure-Python core, which holds the
reference semantics.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent.parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("bpe.cpp", "scheduler.cpp", "loader.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtfnative_{h.hexdigest()[:12]}.so"


def _build() -> Path:
    """Compile libtfnative.so from native/*.cpp unless it is built already;
    its path. Raises when a source or the compiler is missing or g++
    fails."""
    out = _lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build libtfnative.so")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(SRC_DIR / n) for n in SOURCES)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"building libtfnative.so failed:\n{done.stdout}{done.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each write their own tmp file
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded libtfnative, built on first use; None if it cannot be."""
    global _lib, _load_failed
    with _lock:
        if _lib is None and not _load_failed:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except (OSError, RuntimeError, subprocess.TimeoutExpired):
                _load_failed = True
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare restype / argtypes for every exported symbol."""
    # BPE
    lib.tf_bpe_create.restype = ctypes.c_void_p
    lib.tf_bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.tf_bpe_encode_words.restype = ctypes.c_int
    lib.tf_bpe_encode_words.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.tf_bpe_destroy.argtypes = [ctypes.c_void_p]
    # scheduler
    lib.tf_sched_create.restype = ctypes.c_void_p
    lib.tf_sched_create.argtypes = [ctypes.c_int]
    lib.tf_sched_submit.restype = ctypes.c_long
    lib.tf_sched_submit.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
    lib.tf_sched_assign.restype = ctypes.c_int
    lib.tf_sched_assign.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.tf_sched_tick.restype = ctypes.c_int
    lib.tf_sched_tick.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.tf_sched_active.restype = ctypes.c_int
    lib.tf_sched_active.argtypes = [ctypes.c_void_p]
    lib.tf_sched_pending.restype = ctypes.c_int
    lib.tf_sched_pending.argtypes = [ctypes.c_void_p]
    lib.tf_sched_slot_steps_remaining.restype = ctypes.c_int
    lib.tf_sched_slot_steps_remaining.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tf_sched_destroy.argtypes = [ctypes.c_void_p]
    # record loader
    lib.tf_loader_open.restype = ctypes.c_void_p
    lib.tf_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
    ]
    lib.tf_loader_num_arrays.restype = ctypes.c_int
    lib.tf_loader_num_arrays.argtypes = [ctypes.c_void_p]
    lib.tf_loader_num_records.restype = ctypes.c_long
    lib.tf_loader_num_records.argtypes = [ctypes.c_void_p]
    lib.tf_loader_ndim.restype = ctypes.c_int
    lib.tf_loader_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tf_loader_dims.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_ulong)]
    lib.tf_loader_dtype.restype = ctypes.c_int
    lib.tf_loader_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tf_loader_next.restype = ctypes.c_int
    lib.tf_loader_next.argtypes = [ctypes.c_void_p]
    lib.tf_loader_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.tf_loader_close.argtypes = [ctypes.c_void_p]
    return lib
