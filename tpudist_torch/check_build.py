"""Installation sanity check — the ``horovodrun --check-build`` twin
(counterpart of :mod:`tpudist.check_build`).

``python -m tpudist_torch.check_build`` reports which subsystems are
usable in this environment and exits non-zero if a required one is
broken.

Checked, in dependency order:
* torch + backend: the torch version and CUDA build, the cards' names and
  count (or the CPU); a card must be compute capability 9.0, since the
  kernels are built for ``sm_90a``,
* collectives: one all-reduce of ones over every local device — one
  spawned NCCL process a card (a card holds one NCCL rank), or one gloo
  rank on a host without a card,
* the kernels (required when a card is present): every CUDA library
  under ``tpudist_torch/csrc`` built through ``ops/_cuda.py``, then the
  flash-attention forward (K1) run on the card against the plain
  reference, counted by its wrapper's ``launches``,
* the native (C++) runtime library: builds/loads, coordination server
  round-trip, threaded gather round-trip,
* multi-host bootstrap configuration (reported only).
"""

from __future__ import annotations

import sys
import traceback

# the kernel probe's shape and bound, tpudist's: one causal bf16 call
PROBE_SHAPE = (1, 256, 2, 128)
PROBE_MAX_ERR = 0.05
COLLECTIVE_TIMEOUT_S = 120.0


def _check(name: str, fn, required: bool, results: list) -> None:
    try:
        detail = fn()
        results.append((name, True, detail or "ok", required))
    except Exception as e:  # noqa: BLE001 - report, don't crash
        tb = traceback.format_exc().strip().rsplit("\n", 1)[-1]
        results.append((name, False, f"{type(e).__name__}: {e or tb}",
                        required))


def _cuda_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _torch_backend() -> str:
    import torch

    n = _cuda_count()
    build = f"torch {torch.__version__}, CUDA build {torch.version.cuda}"
    if n == 0:
        return f"1 x cpu ({build})"
    names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
    caps = {torch.cuda.get_device_capability(i) for i in range(n)}
    if caps != {(9, 0)}:
        raise RuntimeError(
            f"compute capability {sorted(caps)}: the kernels are built "
            f"for sm_90a and need 9.0 ({build})")
    return f"{n} x {', '.join(names)} (sm_90, {build})"


def _allreduce_rank(rank: int, world: int) -> None:
    """One rank of the collectives probe: all-reduce a ones vector and
    check every element equals the world size."""
    import torch
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    x = torch.ones(world, device=device)
    dist.all_reduce(x)
    got = x.cpu().tolist()
    if got != [float(world)] * world:
        raise RuntimeError(f"all_reduce gave {got}, want {world}s")


def _collectives() -> str:
    from tpudist_torch.runtime.distributed import spawn_ranks

    n = _cuda_count()
    world, device = (n, "cuda") if n else (1, "cpu")
    spawn_ranks(_allreduce_rank, world, device=device,
                timeout=COLLECTIVE_TIMEOUT_S)
    if n:
        return f"all_reduce over {world} cuda device(s) (nccl)"
    return "all_reduce over 1 cpu rank (gloo)"


def _kernels() -> str:
    if _cuda_count() == 0:
        raise RuntimeError("the kernel probe needs a CUDA device; this "
                           "host has none")
    import torch

    from tpudist_torch.models.transformer import sdpa
    from tpudist_torch.ops import _cuda
    from tpudist_torch.ops import flash_attention as fa

    libs = _cuda.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(PROBE_SHAPE, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    before = fa.FLASH_FORWARD.launches
    got = fa.flash_attention(q, k, v, causal=True)
    launched = fa.FLASH_FORWARD.launches - before
    want = sdpa(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    if launched != 1:
        raise RuntimeError(f"the flash forward launched {launched} times, "
                           f"want 1")
    if not err < PROBE_MAX_ERR:
        raise RuntimeError(f"flash kernel numerics off: max err {err}")
    return (f"{len(libs)} libraries built; flash kernel (K1) runs on "
            f"{torch.cuda.get_device_name(0)}, {launched} launch, max err "
            f"{err:.4f} vs reference")


def _native_lib() -> str:
    from tpudist_torch import _native

    if _native.load() is None or _native.load_coord() is None:
        raise RuntimeError("the native libraries failed to build/load")
    return "built + loaded"


def _native_coord() -> str:
    from tpudist_torch.runtime.coord import CoordClient, CoordServer

    with CoordServer(0) as s, CoordClient("127.0.0.1", s.port) as c:
        c.set("k", b"v")
        assert c.get("k") == b"v"
        assert c.add("n", 2) == 2
    return "kv round-trip on localhost"


def _native_gather() -> str:
    import numpy as np

    from tpudist_torch.data.native import GatherPool

    pool = GatherPool(2)
    try:
        data = np.arange(100, dtype=np.float32).reshape(20, 5)
        idx = np.asarray([3, 1, 4, 1, 5])
        (got,) = pool.gather([data], idx)
        np.testing.assert_array_equal(got, data[idx])
    finally:
        pool.close()
    return "threaded gather round-trip"


def _multihost() -> str:
    from tpudist_torch.runtime.distributed import world_info

    w = world_info()
    return (f"process {w.process_index}/{w.process_count}, "
            f"{w.local_device_count} local / {w.global_device_count} "
            f"global devices")


def main(argv: list[str] | None = None) -> int:
    del argv
    results: list = []
    _check("torch backend", _torch_backend, True, results)
    _check("collectives", _collectives, True, results)
    try:
        on_card = _cuda_count() > 0
    except Exception:  # noqa: BLE001 - backend failure already reported
        on_card = False
    # With a card present, a broken kernel stack must FAIL the build check.
    _check("kernels", _kernels, on_card, results)
    _check("native library", _native_lib, False, results)
    if any(n == "native library" and ok for n, ok, *_ in results):
        _check("native coordination service", _native_coord, False,
               results)
        _check("native data loader", _native_gather, False, results)
    _check("multi-host bootstrap", _multihost, False, results)

    width = max(len(n) for n, *_ in results)
    failed_required = False
    for name, ok, detail, required in results:
        mark = "OK  " if ok else ("FAIL" if required else "WARN")
        print(f"[{mark}] {name:<{width}}  {detail}")
        failed_required |= required and not ok
    print()
    if failed_required:
        print("tpudist check-build: FAILED (required subsystem broken)")
        return 1
    print("tpudist check-build: all required subsystems available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
