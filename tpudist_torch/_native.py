"""Loader for the native host-side libraries (counterpart of
:mod:`tpudist._native`): the data-loader core ``native/dataload.cpp``
and the coordination store ``native/coord.cpp``.

The C++ sources are shared with the JAX package and used unchanged: they
have no framework in them.  Each is compiled with ``g++`` at first use
into ``tpudist_torch/_build/`` (git-ignored), under a file name keyed by
a hash of the source and flags, never into ``native/build/``, so the two
packages never race on one library.  The ``tdl_*`` and ``tcs_*`` symbols
are bound with the signatures tpudist gives them.

The data loader tolerates ``load() is None`` (no compiler on the host):
its gathers have a numpy version beside them.  The coordination store has
no Python stand-in: :mod:`tpudist_torch.runtime.coord` raises
``NativeUnavailable`` when ``load_coord()`` is None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "dataload.cpp"
COORD_SOURCE = _REPO / "native" / "coord.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_c = ctypes
_SIGNATURES = {
    "dataload": {
        "tdl_pool_create": ([_c.c_int], _c.c_void_p),
        "tdl_submit": ([_c.c_void_p, _c.c_int, _c.POINTER(_c.c_void_p),
                        _c.POINTER(_c.c_longlong), _c.POINTER(_c.c_longlong),
                        _c.c_longlong, _c.POINTER(_c.c_void_p)],
                       _c.c_longlong),
        "tdl_wait": ([_c.c_void_p, _c.c_longlong, _c.c_int], _c.c_int),
        "tdl_pool_destroy": ([_c.c_void_p], None),
        "tdl_idx_info": ([_c.c_char_p, _c.POINTER(_c.c_int),
                          _c.POINTER(_c.c_int), _c.POINTER(_c.c_longlong)],
                         _c.c_int),
        "tdl_idx_read": ([_c.c_char_p, _c.c_void_p, _c.c_longlong],
                         _c.c_longlong),
    },
    "coord": {
        "tcs_server_start": ([_c.c_uint16], _c.c_void_p),
        "tcs_server_port": ([_c.c_void_p], _c.c_int),
        "tcs_server_stop": ([_c.c_void_p], None),
        "tcs_connect": ([_c.c_char_p, _c.c_uint16, _c.c_int], _c.c_void_p),
        "tcs_set": ([_c.c_void_p, _c.c_char_p, _c.c_void_p, _c.c_uint32],
                    _c.c_int),
        "tcs_get": ([_c.c_void_p, _c.c_char_p, _c.c_void_p, _c.c_uint32,
                     _c.POINTER(_c.c_uint32)], _c.c_int),
        "tcs_add": ([_c.c_void_p, _c.c_char_p, _c.c_longlong],
                    _c.c_longlong),
        "tcs_wait": ([_c.c_void_p, _c.c_char_p, _c.c_int], _c.c_int),
        "tcs_barrier": ([_c.c_void_p, _c.c_char_p, _c.c_int, _c.c_int],
                        _c.c_int),
        "tcs_heartbeat": ([_c.c_void_p, _c.c_char_p, _c.c_int], _c.c_int),
        "tcs_live": ([_c.c_void_p, _c.c_char_p, _c.c_uint32,
                      _c.POINTER(_c.c_uint32)], _c.c_int),
        "tcs_keys": ([_c.c_void_p, _c.c_char_p, _c.c_char_p, _c.c_uint32,
                      _c.POINTER(_c.c_uint32)], _c.c_int),
        "tcs_del": ([_c.c_void_p, _c.c_char_p], _c.c_int),
        "tcs_close": ([_c.c_void_p], None),
    },
}
_SOURCES = {"dataload": SOURCE, "coord": COORD_SOURCE}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def lib_path(name: str = "dataload") -> Path:
    src = _SOURCES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libtpudist_{name}_{h.hexdigest()[:16]}.so"


def _build(src: Path, out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a process-unique name, then rename: a concurrent process
    # never loads a half-written library
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            return False
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)
    return True


def _load(name: str) -> ctypes.CDLL | None:
    """The bound library ``name``, built first if needed; None when it
    cannot be built or loaded on this host (remembered: no retry)."""
    built_s = None
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        try:
            out = lib_path(name)
            ok = out.exists()
            if not ok:
                t0 = time.perf_counter()
                ok = _build(_SOURCES[name], out)
                built_s = time.perf_counter() - t0 if ok else None
            if ok:
                lib = ctypes.CDLL(str(out))
                for fn, (argtypes, restype) in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
        except OSError:  # no source, or a library that does not load
            lib = None
        _libs[name] = lib
    if built_s is not None:   # outside the lock: obs may load libraries
        from tpudist_torch.obs import xla as obs_xla

        obs_xla.note_compile(built_s, source="g++")
    return lib


def load() -> ctypes.CDLL | None:
    """The data-loader library (``tdl_*``), or None."""
    return _load("dataload")


def load_coord() -> ctypes.CDLL | None:
    """The coordination-store library (``tcs_*``), or None."""
    return _load("coord")


def available() -> bool:
    return load() is not None
