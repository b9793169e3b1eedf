"""Loader for the native data-loader core, ``native/dataload.cpp``
(counterpart of :mod:`tpudist._native`).

The C++ source is shared with the JAX package and used unchanged: it has
no framework in it.  It is compiled with ``g++`` at first use into
``tpudist_torch/_build/`` (git-ignored), under a file name keyed by a
hash of the source and flags, never into ``native/build/``, so the two
packages never race on one library.  The ``tdl_*`` symbols are bound
with the signatures tpudist gives them.

Callers tolerate ``load() is None`` (no compiler on the host): every
native path has a numpy version beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "dataload.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtpudist_dataload_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a process-unique name, then rename: a concurrent process
    # never loads a half-written library
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                              str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            return False
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)
    return True


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    sigs = {
        "tdl_pool_create": ([c.c_int], c.c_void_p),
        "tdl_submit": ([c.c_void_p, c.c_int, c.POINTER(c.c_void_p),
                        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong),
                        c.c_longlong, c.POINTER(c.c_void_p)], c.c_longlong),
        "tdl_wait": ([c.c_void_p, c.c_longlong, c.c_int], c.c_int),
        "tdl_pool_destroy": ([c.c_void_p], None),
        "tdl_idx_info": ([c.c_char_p, c.POINTER(c.c_int), c.POINTER(c.c_int),
                          c.POINTER(c.c_longlong)], c.c_int),
        "tdl_idx_read": ([c.c_char_p, c.c_void_p, c.c_longlong],
                         c.c_longlong),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def load() -> ctypes.CDLL | None:
    """The bound library, built first if needed; None when it cannot be
    built or loaded on this host."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        out = lib_path()
        if not out.exists() and not _build(out):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
            _bind(lib)
        except OSError:
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
