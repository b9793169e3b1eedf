"""ctypes bindings for the native data-loader core (counterpart of
:mod:`tpudist.data.native`): :class:`GatherPool`, an asynchronous
multi-threaded row gather (``dst[i] = src[idx[i]]``) so batch assembly
runs on C++ worker threads beside the card's work, and a native IDX-file
reader.  The library is built by :mod:`tpudist_torch._native`; numpy
versions stand beside every call site.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from tpudist_torch import _native

_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32,
               0x0D: np.float32, 0x0E: np.float64}


def available() -> bool:
    return _native.available()


class GatherPool:
    """Asynchronous gather on a C++ thread pool.

    ``submit`` queues ``out[k][i] = arrays[k][idx[i]]`` for every array
    and returns a job id; ``wait`` blocks until that job's buffers are
    filled.  Sources and destinations must be C-contiguous and stay alive
    until ``wait`` returns (submit keeps references to them)."""

    def __init__(self, threads: int = 4) -> None:
        lib = _native.load()
        if lib is None:
            raise RuntimeError("native data-loader library unavailable")
        self._lib = lib
        self._h = lib.tdl_pool_create(threads)
        self._pending: dict[int, tuple] = {}  # job id -> kept-alive buffers
        self.jobs = 0                         # jobs submitted, ever

    def submit(self, arrays: list[np.ndarray], idx: np.ndarray,
               out: list[np.ndarray]) -> int:
        n = len(arrays)
        if n == 0 or n != len(out):
            raise ValueError(f"arrays/out length mismatch: {n} vs {len(out)}")
        idx64 = np.ascontiguousarray(idx, dtype=np.int64)
        srcs = (ctypes.c_void_p * n)()
        dsts = (ctypes.c_void_p * n)()
        row_bytes = (ctypes.c_longlong * n)()
        for k, (a, o) in enumerate(zip(arrays, out)):
            if not (a.flags.c_contiguous and o.flags.c_contiguous):
                raise ValueError(
                    "GatherPool requires C-contiguous arrays (the C++ "
                    "gather computes row offsets from shape, not strides); "
                    "pass np.ascontiguousarray(...)")
            if o.shape[0] != len(idx64) or o.dtype != a.dtype or \
                    o.shape[1:] != a.shape[1:]:
                raise ValueError(f"out[{k}] shape/dtype mismatch")
            if len(idx64) and (idx64.min() < 0 or idx64.max() >= len(a)):
                raise IndexError(f"gather index out of range for "
                                 f"{len(a)} rows")
            srcs[k] = a.ctypes.data
            dsts[k] = o.ctypes.data
            row_bytes[k] = a.dtype.itemsize * int(
                np.prod(a.shape[1:], dtype=np.int64))
        job = self._lib.tdl_submit(
            self._h, n, srcs, row_bytes,
            idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(idx64), dsts)
        if job < 0:
            raise RuntimeError("tdl_submit failed")
        self._pending[job] = (arrays, idx64, out)
        self.jobs += 1
        return int(job)

    def wait(self, job: int, timeout_s: float = 60.0) -> list[np.ndarray]:
        rc = self._lib.tdl_wait(self._h, job, int(timeout_s * 1000))
        if rc == 1:
            raise TimeoutError(f"gather job {job} timed out")
        if rc != 0:
            raise RuntimeError(f"gather job {job} unknown/failed")
        return list(self._pending.pop(job)[2])

    def gather(self, arrays: list[np.ndarray],
               idx: np.ndarray) -> list[np.ndarray]:
        """Synchronous convenience: allocate outputs, submit, wait."""
        out = [np.empty((len(idx),) + a.shape[1:], a.dtype) for a in arrays]
        return self.wait(self.submit(arrays, idx, out))

    def close(self) -> None:
        if self._h:
            self._lib.tdl_pool_destroy(self._h)
            self._h = None
            self._pending.clear()

    def __del__(self) -> None:  # best-effort; explicit close preferred
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def read_idx_native(path: str | Path) -> np.ndarray | None:
    """Parse a raw (not gzipped) IDX file with the native parser; None
    when the native library is unavailable (the caller reads it with
    numpy)."""
    lib = _native.load()
    if lib is None:
        return None
    dtype = ctypes.c_int()
    ndim = ctypes.c_int()
    dims = (ctypes.c_longlong * 8)()
    if lib.tdl_idx_info(str(path).encode(), ctypes.byref(dtype),
                        ctypes.byref(ndim), dims) != 0:
        raise ValueError(f"{path}: not a valid IDX file")
    shape = tuple(int(dims[i]) for i in range(ndim.value))
    if dtype.value not in _IDX_DTYPES:
        raise ValueError(f"{path}: unsupported IDX dtype code "
                         f"{dtype.value:#x}")
    out = np.empty(shape, np.dtype(_IDX_DTYPES[dtype.value]))
    got = lib.tdl_idx_read(str(path).encode(), out.ctypes.data, out.nbytes)
    if got != out.nbytes:
        raise ValueError(f"{path}: truncated IDX payload")
    return out
