"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes.  Builds happen at
first use, into ``tpudist_torch/_build/`` (git-ignored), keyed by a hash of
the sources and flags, so editing a kernel rebuilds it and nothing else
needs a build step.  All sources are compiled together, one ``nvcc`` each,
started at once.

Nothing here runs at import: the CPU tests import every module on hosts
that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "tpudist_torch's kernels (set CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every kernel source whose library is missing — all ``nvcc``
    processes started together — and return ``{stem: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    want = {src.stem: (src, _lib_path(src)) for src in _sources()}
    todo = {k: v for k, v in want.items() if not v[1].exists()}
    if todo:
        from tpudist_torch.obs import xla as obs_xla

        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for stem, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = out.with_suffix(".log").open("w")
            procs[stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(src)], stdout=log, stderr=subprocess.STDOUT),
                tmp, out, log)
        # each build's seconds run from the common start to the first
        # poll that sees its nvcc exit, whatever order they finish in
        seconds: dict[str, float] = {}
        while len(seconds) < len(procs):
            for stem, (proc, *_rest) in procs.items():
                if stem not in seconds and proc.poll() is not None:
                    seconds[stem] = time.perf_counter() - t0
            time.sleep(0.01)
        failed = []
        for stem, (proc, tmp, out, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"{stem}: nvcc exited {rc}\n"
                              + out.with_suffix(".log").read_text()[-4000:])
            else:
                os.replace(tmp, out)   # atomic: concurrent builds agree
                obs_xla.note_compile(seconds[stem], source="nvcc")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {k: v[1] for k, v in want.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<stem>.cu``, built on demand."""
    lib = _libs.get(stem)
    if lib is None:
        paths = build()
        for name, path in paths.items():
            _libs.setdefault(name, ctypes.CDLL(str(path)))
        lib = _libs[stem]
    return lib


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


class Kernel:
    """One exported C entry point of a kernel library, with the count of
    its launches.  ``launches`` goes up by one per successful launch and
    nowhere else; callers (``chip_smoke.py``) reset it to 0 around a run
    to prove the run went through the kernel."""

    def __init__(self, stem: str, symbol: str, argtypes: list) -> None:
        self.stem, self.symbol, self.argtypes = stem, symbol, argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.stem), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            err = library(self.stem).tpudist_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            raise RuntimeError(
                f"{self.symbol} failed to launch: CUDA error {rc} "
                f"({err(rc).decode()})")
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      device: torch.device, ndim: int) -> None:
    """The common argument checks of a kernel wrapper: device, dtype,
    rank, a unit stride on the last dim and 16-byte-aligned rows (the
    kernels load 16 bytes a thread)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    es = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride on its last dim, "
                         f"got strides {t.stride()}")
    if t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:-1]) \
            or (t.shape[-1] * es) % 16:
        raise ValueError(
            f"{name} rows must be 16-byte aligned (shape {tuple(t.shape)}, "
            f"strides {t.stride()}, dtype {t.dtype})")
