"""Host-side collectives over the native coordination store (counterpart
of :mod:`tpudist.runtime.collectives`).

The reference's elastic paths lean on CPU collective backends — Gloo for DDP
(`mnist_ddp_elastic.py:26`) and Horovod's controller for the elastic driver
(`horovod_mnist_elastic.py:35,55`) — whose defining property is that the
*membership* of a collective is renegotiable at run time.  A process
group (NCCL, gloo) is formed for a fixed world; this module provides
the complementary control-plane collectives with DYNAMIC membership,
built on the C++ TCP store (``native/coord.cpp``): allreduce / broadcast
/ barrier whose participant set is whatever the current rendezvous round
agreed on.

That property is what makes in-process elastic resize possible
(:mod:`tpudist_torch.elastic.worker`): when a worker dies mid-allreduce, the
surviving participants' waits time out against the TTL-expired live set and
surface :class:`~tpudist_torch.elastic.loop.WorldChanged` — they re-rendezvous
smaller and the next round's collectives simply have fewer participants.
No process group needs to re-form, because these collectives live
outside one.

Allreduce is BANDWIDTH-OPTIMAL, not naive (the Horovod-core trio the
reference gets for free from ``hvd.DistributedOptimizer``,
`mnist_horovod.py:53`):

* **bucket fusion** — the tree is flattened into fused flat buffers of
  at most ``bucket_bytes`` (leaves grouped by dtype, concatenated in a
  deterministic order), so wire cost is per-bucket, not per-leaf;
* **ring reduce-scatter** — each fused bucket is split into ``world``
  chunks; chunk ``c`` travels the ring ``c → c+1 → … → c-1``, each hop
  adding its own contribution, so every rank uploads/downloads
  ``(world-1)/world`` of the payload instead of ``world×`` of it.  The
  all-gather half uses the store's star topology directly: the rank that
  finishes chunk ``c`` posts it ONCE and every peer fetches it — ring
  forwarding would double store traffic for nothing.  Net wire bytes per
  rank: ``2·(world−1)/world × size`` fetched (vs ``(world−1) × size``
  flat), ``~1 × size`` posted;
* **wire compression** — float32 payloads optionally travel as bf16
  (default) or fp16 with float32 accumulation at every hop
  (``compress_ratio`` reports the saving); every other dtype rides
  raw;
* **hierarchical topology** (``algorithm="hier"``) — ranks are grouped
  into ``hosts`` contiguous host groups; each bucket is reduce-scattered
  WITHIN the host (over an injected intra-host plane, or through the
  store in lossless accum-dtype bytes), then each shard runs the chunked ring
  across ONE representative rank per host, then the finished shards
  all-gather back within the host.  Cross-host wire bytes drop from
  ``2·(world−1)/world × size`` per RANK to ``2·(H−1)/H × size`` per
  HOST (H = host count) — the bytes the slow DCN link actually carries;
* **top-k sparsification** (``compress="topk"``) — every lossy message
  keeps only the ``topk_frac`` largest-magnitude elements (int32 index +
  f32 value per survivor, so wire ≈ ``2·frac ×`` dense), re-sparsified
  at every ring hop; what an encode drops is accumulated in a per-bucket
  ERROR-FEEDBACK residual owned by :class:`HostCollectives` and folded
  into this rank's next contribution, so dropped mass is delayed, never
  lost.  Residuals die with the instance — one instance per rendezvous
  round means a membership change drops them rather than replaying them
  into a differently-shaped world;
* **async overlap** — :meth:`HostCollectives.allreduce_sum_async` returns
  a :class:`Handle` and runs post/fetch/reduce on a background worker, so
  the caller's next microbatch overlaps the previous one's wire time
  (``hvd.DistributedOptimizer`` semantics — see
  :class:`tpudist_torch.elastic.worker.OverlappedGradSync`).

DETERMINISM CONTRACT: after any allreduce, every participant holds a
bitwise-identical result.  Ring: each chunk is reduced exactly once, by one
rank per hop in fixed ring order, and the finished chunk's *encoded bytes*
are what every rank decodes — no rank re-does a reduction another rank
already did.  Flat: every rank reduces in rank order over the *posted*
(wire-encoded) payloads, including its own, so compression rounding is
identical everywhere.  Hier: intra-host reduction runs in fixed
local-rank order, each cross-host shard ring is ring-fixed, and the
intra all-gather re-posts the (identical) decoded shard bytes raw.  The
algorithms may differ from each other in ULPs (different addition
order), and topk additionally drops mass into residuals — but for every
algorithm × compression combination, replicas never differ from each
other.

Wire format: flat posts one fused blob per rank under
``{ns}/{round}/{op}/{rank}``; ring posts chunk partials under
``{ns}/{round}/{op}/rs/{bucket}/{step}/{rank}`` and finished chunks under
``{ns}/{round}/{op}/ag/{bucket}/{chunk}``; hier adds intra-host posts
under ``.../hrs/{bucket}/{dest}/{src}`` + ``.../hag/{bucket}/{owner}``
and per-shard cross-host rings under ``.../xrs/{bucket}.{shard}/...`` +
``.../xag/{bucket}.{shard}/...``.  Chunk payloads are raw bytes of
the wire dtype — both sides derive shapes/offsets from the (identical)
fusion plan, so no per-message header is needed.  Key GC: a participant
deletes every key it posted for ``op - 2`` (and earlier) when starting
``op`` — by then every peer has consumed them (finishing ``op`` requires
the whole ring to have finished ``op - 1``), so the store stays O(ring
keys × 2) per round; a barrier collects nothing (see
``HostCollectives._begin_op``: the one place the port departs from
tpudist's schedule).

Trees and tensors: a tree is nested mappings (keys sorted, as jax
flattens them), lists and tuples whose leaves are numpy arrays, numbers,
or torch tensors on any device.  Each leaf comes back as its own kind: a
tensor on its device and in its dtype (contiguous), anything else as a
numpy array, as tpudist returns it.  The wire is tpudist's byte for byte
(keys, fusion plans, codecs, the top-k index order), so a gang may mix
the two packages.  numpy has no bfloat16 and the port does not use
``ml-dtypes``: bf16 values live on the host as 2-byte bit patterns
(``np.dtype("V2")``, tpudist's ``"<V2"`` token) and are rounded from
f32 to nearest-even by torch, which is what ``ml-dtypes`` does.  CUDA
leaves are staged through pinned host memory: one device-to-host copy
per (device, dtype) and one wait per call, the results copied back with
one non-blocking host-to-device copy each (``stage_d2h_s``,
``stage_h2d_s`` time them).  The reduction itself runs on the host in
numpy, as tpudist's does, so a port rank and a tpudist rank compute the
same bits.

Calls, bytes and times go to the obs registry under tpudist's ``coll/*``
names, at tpudist's sites, and to plain counters on each
:class:`HostCollectives` (``calls``, ``bytes_posted``, ``bytes_fetched``,
``allreduce_s``, ``fetch_wait_s``).
"""

from __future__ import annotations

import dataclasses
import io
import os
import queue
import threading
import time
from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch

from tpudist_torch import obs
from tpudist_torch.runtime.coord import CoordClient

class PeerLost(RuntimeError):
    """A collective wait exceeded its deadline; membership likely changed."""


# ---------------------------------------------------------------------------
# configuration


ALGORITHMS = ("auto", "flat", "ring", "hier")
COMPRESSIONS = ("none", "bf16", "fp16", "topk")


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    """Knobs for the host allreduce (Horovod's fusion-buffer/compression
    trio, `HOROVOD_FUSION_THRESHOLD` analog).

    * ``algorithm`` — ``auto`` (flat for tiny payloads or ``world <= 2``,
      ring otherwise), or force ``flat`` / ``ring`` / ``hier``
      (hierarchical: intra-host reduce-scatter, cross-host ring over one
      representative rank per host, intra-host all-gather — needs
      ``hosts`` to divide the world, falls back to ``ring`` otherwise).
    * ``bucket_bytes`` — fused-buffer cap; one ring runs per bucket, so
      smaller buckets start their wire time earlier but cost more store
      round-trips.
    * ``compress`` — ``bf16`` (default) / ``fp16`` / ``none`` / ``topk``
      (top-k magnitude sparsification with error-feedback residuals);
      applies to float32 payloads only, accumulation stays float32.
      Under ``hier`` compression applies to the CROSS-HOST wire; the
      intra-host phases ride lossless accumulation-dtype bytes.
    * ``flat_max_bytes`` — ``auto`` switches to ring above this payload
      size (the flat gather's one-post/one-fetch-per-peer latency beats
      the ring's ``2·world`` round-trips for small trees).
    * ``topk_frac`` — fraction of each compressed message's elements kept
      by ``topk`` (wire bytes ≈ ``2·frac`` of dense: int32 index + f32
      value per survivor).
    * ``hosts`` — host-group count for ``hier``; ranks are grouped
      contiguously (host = ``rank // (world/hosts)``), matching how the
      launcher numbers a gang.

    Every field has a ``TPUDIST_COLL_*`` environment override (read by
    :meth:`from_env`, the default for :class:`HostCollectives`), so the
    elastic worker and the launcher-spawned gang pick the same plan
    without plumbing.
    """

    algorithm: str = "auto"
    bucket_bytes: int = 4 << 20
    compress: str = "bf16"
    flat_max_bytes: int = 64 << 10
    topk_frac: float = 0.25
    hosts: int = 1

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Reject out-of-range knobs with the allowed values in the
        message — a typo'd ``TPUDIST_COLL_*`` override must fail at
        config construction, not surface as dispatch-time weirdness."""
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r} "
                f"(TPUDIST_COLL_ALGO); allowed: {', '.join(ALGORITHMS)}")
        if self.compress not in COMPRESSIONS:
            raise ValueError(
                f"unknown compress {self.compress!r} "
                f"(TPUDIST_COLL_COMPRESS); allowed: "
                f"{', '.join(COMPRESSIONS)}")
        if self.bucket_bytes < 64:
            raise ValueError(f"bucket_bytes too small: {self.bucket_bytes}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac} "
                f"(TPUDIST_COLL_TOPK_FRAC)")
        if self.hosts < 1:
            raise ValueError(
                f"hosts must be >= 1, got {self.hosts} "
                f"(TPUDIST_COLL_HOSTS)")

    @classmethod
    def from_env(cls) -> "CollectiveConfig":
        return cls(
            algorithm=os.environ.get("TPUDIST_COLL_ALGO", cls.algorithm),
            bucket_bytes=int(os.environ.get("TPUDIST_COLL_BUCKET_BYTES",
                                            cls.bucket_bytes)),
            compress=os.environ.get("TPUDIST_COLL_COMPRESS", cls.compress),
            flat_max_bytes=int(os.environ.get("TPUDIST_COLL_FLAT_MAX_BYTES",
                                              cls.flat_max_bytes)),
            topk_frac=float(os.environ.get("TPUDIST_COLL_TOPK_FRAC",
                                           cls.topk_frac)),
            hosts=int(os.environ.get("TPUDIST_COLL_HOSTS", cls.hosts)),
        )


# ---------------------------------------------------------------------------
# wire codecs + bucket fusion


# ---------------------------------------------------------------------------
# wire codecs + bucket fusion

# bf16 on the host: 2-byte bit patterns; "<V2" is ml-dtypes' bfloat16 token,
# which orders tpudist's dtype groups, so the port sorts by the same string
_BF16 = np.dtype("V2")
_BF16_TOKEN = "<V2"


def _token(dtype: np.dtype) -> str:
    return _BF16_TOKEN if dtype == _BF16 else dtype.str


def _from_token(token: str) -> np.dtype:
    return _BF16 if token == _BF16_TOKEN else np.dtype(token)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 (or anything castable) to bf16 bit patterns, rounded to
    nearest-even by torch (``ml-dtypes``' rounding)."""
    t = torch.from_numpy(np.asarray(x, dtype=np.float32, order="C"))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(_BF16)


def _bf16_float(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns to f32 (exact)."""
    return (np.asarray(bits, order="C").view(np.uint16).astype(np.uint32)
            << 16).view(np.float32)


def _astype(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """``arr.astype(dtype, copy=False)`` that knows :data:`_BF16`."""
    if arr.dtype == dtype:
        return arr
    if dtype == _BF16:
        return _bf16_bits(arr)
    if arr.dtype == _BF16:
        return _bf16_float(arr).astype(dtype, copy=False)
    return arr.astype(dtype, copy=False)


def _wire_dtype(native: np.dtype, compress: str) -> np.dtype:
    """The dtype a group's bytes travel as: float32 compresses to
    bf16/fp16 when asked; everything else (ints, bool, f64, and already-
    half floats) rides raw.  ``topk`` payloads are sparse, not a dtype
    cast — their wire dtype stays the native one and the sparse codec
    below owns the byte layout."""
    if native == np.float32 and compress in ("bf16", "fp16"):
        return _BF16 if compress == "bf16" else np.dtype(np.float16)
    return native


def _topk_k(n: int, frac: float) -> int:
    """Survivor count for a ``topk`` message of ``n`` elements: fixed
    and derived from the (identical) config on every rank, so message
    sizes need no header and byte accounting is exact."""
    if n == 0:
        return 0
    return max(1, min(n, int(np.ceil(n * frac))))


def _encode_topk(arr: np.ndarray, frac: float) -> bytes:
    """Top-k magnitude sparsification: keep the ``k`` largest-|x|
    elements, wire format ``k × int32 index (sorted ascending) + k ×
    f32 value``.  Sorted indices make the encoding a pure function of
    the input values, so every rank re-encoding the same array posts
    the same bytes."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    n = arr.size
    k = _topk_k(n, frac)
    if k >= n:
        idx = np.arange(n, dtype=np.int32)
    else:
        idx = np.sort(np.argpartition(np.abs(arr), n - k)[n - k:]) \
            .astype(np.int32)
    return idx.tobytes() + arr[idx].tobytes()


def _decode_topk(raw: bytes, n: int) -> np.ndarray:
    """Densify a topk payload back to length ``n`` (zeros off-support).
    ``k`` is implied by the payload length — both halves are 4 bytes per
    survivor."""
    k = len(raw) // 8
    out = np.zeros(n, dtype=np.float32)
    if k:
        idx = np.frombuffer(raw[:4 * k], dtype=np.int32)
        out[idx] = np.frombuffer(raw[4 * k:], dtype=np.float32)
    return out


def _accum_dtype(native: np.dtype) -> np.dtype:
    """float32 accumulation for <= 16-bit floats (the fp32-master-copy
    rule of mixed-precision allreduce); everything else accumulates in
    its own dtype (ints must stay exact, f64 must not narrow)."""
    if native == np.float16 or native == _BF16:
        return np.dtype(np.float32)
    return native


def _encode(arr: np.ndarray, wire: np.dtype) -> bytes:
    return np.ascontiguousarray(_astype(arr, wire)).tobytes()


def _decode(raw: bytes, wire: np.dtype, accum: np.dtype) -> np.ndarray:
    # frombuffer is zero-copy (read-only); the cast to the accumulation
    # dtype copies exactly when it has to
    return _astype(np.frombuffer(raw, dtype=wire), accum)


@dataclasses.dataclass
class _Bucket:
    group: str            # dtype token of the owning group
    data: np.ndarray      # 1-D accum-dtype slice of the group's fused vector
    wire: np.dtype
    accum: np.dtype
    # the compression slot: ``frac`` set means this bucket's lossy
    # messages ride the sparse topk codec instead of a dtype cast;
    # ``residual`` (when error feedback is live) collects what each of
    # THIS rank's encodes dropped, at bucket-global offsets
    frac: float | None = None
    residual: np.ndarray | None = None

    @property
    def wire_nbytes(self) -> int:
        if self.frac is not None:
            return 8 * _topk_k(len(self.data), self.frac)
        return len(self.data) * self.wire.itemsize


def _bucket_encode(b: _Bucket, arr: np.ndarray, off: int = 0) -> bytes:
    """Encode one wire message for bucket ``b`` (``arr`` lives at
    bucket-global offset ``off``).  For topk buckets the encode is where
    gradient mass is lost, so the error-feedback residual is written
    HERE: each region a rank encodes gets its drop recorded exactly once
    per op (ring/hier topology guarantees the regions don't overlap),
    and the next op re-injects it."""
    if b.frac is None:
        return _encode(arr, b.wire)
    raw = _encode_topk(arr, b.frac)
    if b.residual is not None and arr.size:
        b.residual[off:off + arr.size] = arr - _decode_topk(raw, arr.size)
    return raw


def _bucket_decode(b: _Bucket, raw: bytes, n: int) -> np.ndarray:
    if b.frac is None:
        return _decode(raw, b.wire, b.accum)
    return _decode_topk(raw, n)


def _fuse(np_leaves: list[np.ndarray], cfg: CollectiveConfig,
          prefused: dict[str, tuple[list[int], np.ndarray]] | None = None
          ) -> tuple[list[_Bucket], dict]:
    """Horovod-style tensor fusion: group leaves by dtype (sorted dtype
    token, leaf order within a group — deterministic on every rank),
    concatenate each group into one flat accumulation-dtype vector, and
    slice it into buckets of at most ``bucket_bytes`` wire bytes.
    ``prefused`` maps a token to ``(leaf indices, vector)`` where the
    group's leaves already lie back to back in one vector (the pinned
    staging buffer of a CUDA group), which is then used as it is.

    Returns ``(buckets, plan)`` where ``plan`` maps group token ->
    ``(leaf_indices, native_dtype)`` for :func:`_defuse`.
    """
    groups: dict[str, list[int]] = {}
    for i, leaf in enumerate(np_leaves):
        groups.setdefault(_token(leaf.dtype), []).append(i)
    buckets: list[_Bucket] = []
    plan: dict[str, tuple] = {}
    for token in sorted(groups):
        idxs = groups[token]
        native = _from_token(token)
        accum = _accum_dtype(native)
        wire = _wire_dtype(native, cfg.compress)
        pre = (prefused or {}).get(token)
        if pre is not None and pre[0] == idxs:
            fused = pre[1]
        else:
            parts = [np_leaves[i].ravel() for i in idxs]
            fused = np.concatenate(parts) if len(parts) > 1 else parts[0]
        fused = _astype(fused, accum)
        frac = (cfg.topk_frac if cfg.compress == "topk"
                and native == np.float32 else None)
        per_bucket = max(1, cfg.bucket_bytes // wire.itemsize)
        group_buckets = [
            _Bucket(token, fused[lo:lo + per_bucket], wire, accum, frac)
            for lo in range(0, len(fused), per_bucket)
        ] or ([_Bucket(token, fused, wire, accum, frac)]
              if fused.size == 0 else [])
        buckets.extend(b for b in group_buckets if b.data.size)
        plan[token] = (idxs, native)
    return buckets, plan


def _defuse(reduced: dict[str, list[np.ndarray]], plan: dict,
            np_leaves: list[np.ndarray]) -> list[np.ndarray]:
    """Inverse of :func:`_fuse`: concatenate each group's reduced bucket
    vectors, cast back to the native dtype, and split into leaf shapes."""
    out: list[np.ndarray | None] = [None] * len(np_leaves)
    for token, (idxs, native) in plan.items():
        vecs = reduced.get(token, [])
        vec = (np.concatenate(vecs) if len(vecs) > 1
               else vecs[0] if vecs
               else np.empty(0, _accum_dtype(native)))
        vec = _astype(vec, native)
        off = 0
        for i in idxs:
            n = np_leaves[i].size
            out[i] = vec[off:off + n].reshape(np_leaves[i].shape)
            off += n
    return out  # type: ignore[return-value]


def _chunk_bounds(n: int, world: int) -> list[tuple[int, int]]:
    """Ring chunk boundaries: ``world`` near-equal slices of ``[0, n)``
    (first ``n % world`` chunks one element larger) — identical on every
    rank, tolerating ``n < world`` via empty chunks."""
    base, rem = divmod(n, world)
    bounds, lo = [], 0
    for c in range(world):
        hi = lo + base + (1 if c < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _dumps(leaves: list[np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, *leaves)
    return buf.getvalue()


def _loads(raw: bytes) -> list[np.ndarray]:
    with np.load(io.BytesIO(raw)) as z:
        # index by position, not z.files order (lexicographic would put
        # arr_10 before arr_2)
        return [z[f"arr_{i}"] for i in range(len(z.files))]


# ---------------------------------------------------------------------------
# async plumbing


# ---------------------------------------------------------------------------
# trees and device staging


def _flatten(tree: Any) -> tuple[list[Any], Callable[[list[Any]], Any]]:
    """``(leaves, rebuild)`` in ``jax.tree.flatten``'s order: mapping keys
    sorted, sequences in order, ``None`` an empty subtree.  ``rebuild``
    puts a list of new leaves back into the structure (mappings as dicts,
    lists and tuples as their own type)."""
    leaves: list[Any] = []

    def walk(node: Any) -> Callable[[Any], Any]:
        if node is None:
            return lambda it: None
        if isinstance(node, Mapping):
            keys = sorted(node)
            subs = [walk(node[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(node, (list, tuple)):
            subs = [walk(v) for v in node]
            kind = type(node)
            return lambda it: kind([s(it) for s in subs])
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        return _BF16
    return torch.empty((), dtype=dtype).numpy().dtype


def _tensor_host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's values as a numpy array (bf16 as bit patterns)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16)
    return t.numpy()


def _pinned(n: int, dtype: torch.dtype) -> tuple[torch.Tensor, np.ndarray]:
    """A pinned host buffer of ``n`` elements and its numpy view."""
    buf = torch.empty(n, dtype=dtype, pin_memory=True)
    return buf, _tensor_host(buf)


@dataclasses.dataclass
class _Staged:
    """A flattened tree on the host: ``host[i]`` is leaf ``i``'s values;
    ``prefused`` the CUDA groups whose leaves lie back to back in one
    pinned buffer (token -> (leaf indices, vector)); ``events`` the
    device-to-host copies still in flight."""

    leaves: list[Any]
    rebuild: Callable[[list[Any]], Any]
    host: list[np.ndarray | None]
    prefused: dict[str, tuple[list[int], np.ndarray]]
    events: list[Any]
    t0: float

    def wait(self) -> float:
        """Wait for the copies; the seconds from staging to their end."""
        for ev in self.events:
            ev.synchronize()
        self.events = []
        return time.perf_counter() - self.t0


def _stage(tree: Any) -> _Staged:
    """Flatten ``tree`` and start its host copy (see the module
    docstring): every CUDA leaf of one (device, dtype) is gathered on
    its device into one flat tensor (which also snapshots it: later
    in-place updates by the caller cannot reach the copy) and copied by
    one non-blocking copy into one pinned buffer."""
    t0 = time.perf_counter()
    leaves, rebuild = _flatten(tree)
    host: list[np.ndarray | None] = [None] * len(leaves)
    cuda: dict[tuple[torch.device, torch.dtype], list[int]] = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                cuda.setdefault((leaf.device, leaf.dtype), []).append(i)
            else:
                host[i] = _tensor_host(leaf)
        else:
            host[i] = np.asarray(leaf)
    prefused: dict[str, tuple[list[int], np.ndarray]] = {}
    events = []
    devices_of: dict[np.dtype, set] = {}
    for (dev, dtype), idxs in cuda.items():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idxs])
        buf, view = _pinned(flat.numel(), dtype)
        buf.copy_(flat, non_blocking=True)
        events.append(torch.cuda.current_stream(dev).record_event())
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            host[i] = view[off:off + n].reshape(tuple(leaves[i].shape))
            off += n
        prefused[_token(view.dtype)] = (idxs, view)
        devices_of.setdefault(view.dtype, set()).add(dev)
    for dt, devs in devices_of.items():
        if len(devs) > 1:  # one dtype on two cards: no single vector
            prefused.pop(_token(dt), None)
    return _Staged(leaves, rebuild, host, prefused, events, t0)


def _unstage(staged: _Staged, results: list[np.ndarray]) -> Any:
    """Rebuild the tree with each leaf's result as the leaf's own kind:
    a tensor on its device in its dtype (CUDA groups back through one
    pinned buffer and one non-blocking copy each), else numpy."""
    out: list[Any] = list(results)
    cuda: dict[tuple[torch.device, torch.dtype], list[int]] = {}
    for i, leaf in enumerate(staged.leaves):
        if not isinstance(leaf, torch.Tensor):
            continue
        if leaf.device.type == "cuda":
            cuda.setdefault((leaf.device, leaf.dtype), []).append(i)
            continue
        res = np.asarray(results[i], order="C")  # keeps a 0-d leaf 0-d
        if leaf.dtype == torch.bfloat16:
            out[i] = torch.from_numpy(
                _astype(res, _BF16).view(np.int16)).view(torch.bfloat16)
        else:
            out[i] = torch.from_numpy(res)
    for (dev, dtype), idxs in cuda.items():
        if not torch.empty((), dtype=dtype).is_floating_point() and \
                results[idxs[0]].dtype.kind == "f":
            dtype = torch.float64  # an integer mean, as numpy returns it
        n = sum(results[i].size for i in idxs)
        buf, view = _pinned(n, dtype)
        off = 0
        for i in idxs:
            m = results[i].size
            view[off:off + m] = _astype(results[i], view.dtype).ravel()
            off += m
        flat = buf.to(dev, non_blocking=True)
        off = 0
        for i in idxs:
            m = results[i].size
            out[i] = flat[off:off + m].view(tuple(staged.leaves[i].shape))
            off += m
    return staged.rebuild(out)


def _divide(arr: np.ndarray, world: int) -> np.ndarray:
    """``arr / world`` as numpy (and ``ml-dtypes`` for bf16) compute it."""
    if arr.dtype == _BF16:
        return _bf16_bits(_bf16_float(arr) / world)
    return arr / world


class Handle:
    """Result of an async collective: :meth:`wait` blocks until the
    background worker finishes and returns the reduced tree — or re-raises
    whatever the worker thread raised (``PeerLost``, ``WorldChanged`` from
    the elastic ``on_wait`` probe, a store ``ConnectionError``), so the
    caller's recovery path sees exactly what the synchronous call would
    have thrown."""

    __slots__ = ("_event", "_result", "_exc")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: Any = None
        self._exc: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout_s: float | None = None) -> Any:
        if not self._event.wait(timeout_s):
            raise PeerLost(f"async collective not done within {timeout_s}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _finish(self, result: Any = None,
                exc: BaseException | None = None) -> None:
        self._result, self._exc = result, exc
        self._event.set()


class _Prefetcher:
    """Background fetcher over its own store connection: the ring's
    next-chunk wait overlaps the current chunk's local reduction (and the
    all-gather's world-1 fetches stream while earlier chunks are being
    placed).  ``submit`` enqueues a key; the owning collective picks the
    bytes up with ``take`` on ITS thread — the elastic ``on_wait`` probe
    (which may raise ``WorldChanged``) always runs on the collective's
    thread, never here."""

    def __init__(self, base_client: CoordClient,
                 abort: threading.Event) -> None:
        self._client = base_client.clone()
        self._q: queue.Queue = queue.Queue()
        self._res: dict[str, bytes | BaseException] = {}
        self._cond = threading.Condition()
        self._abort = abort
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="tpudist-coll-prefetch")
        self._thread.start()

    def submit(self, key: str, deadline: float) -> None:
        self._q.put((key, deadline))

    def _loop(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                key, deadline = item
                try:
                    val: bytes | BaseException = self._fetch(key, deadline)
                except BaseException as e:  # noqa: BLE001 - delivered at take()
                    val = e
                with self._cond:
                    self._res[key] = val
                    self._cond.notify_all()
        finally:
            self._client.close()

    def _fetch(self, key: str, deadline: float) -> bytes:
        while True:
            raw = self._client.get(key)
            if raw is not None:
                return raw
            if self._abort.is_set():
                raise PeerLost(f"collective aborted waiting for {key}")
            if time.monotonic() > deadline:
                raise PeerLost(
                    f"peer never posted {key} within the collective's "
                    f"shared deadline")
            self._client.wait(key, timeout_s=0.2)

    def take(self, key: str, deadline: float,
             on_wait: Callable[[], None] | None) -> bytes:
        with self._cond:
            while key not in self._res:
                if on_wait is not None:
                    on_wait()  # may raise WorldChanged — caller's thread
                if self._abort.is_set():
                    raise PeerLost(f"collective aborted waiting for {key}")
                if time.monotonic() > deadline:
                    raise PeerLost(
                        f"peer never posted {key} within the collective's "
                        f"shared deadline")
                self._cond.wait(0.05)
            val = self._res.pop(key)
        if isinstance(val, BaseException):
            raise val
        return val

    def close(self) -> None:
        self._q.put(None)


# ---------------------------------------------------------------------------


class HostCollectives:
    """Fixed-membership collectives for one rendezvous round.

    Args:
      client: store connection (the caller's thread uses it; background
        workers clone their own — do not share with a concurrently-beating
        monitor, it clones its own too).
      rank / world: this participant's dense rank and the round's size
        (from :meth:`tpudist_torch.runtime.coord.Rendezvous.join_live`).
      round_id: rendezvous round; namespaces all keys so a new round never
        sees a dead round's leftovers.
      on_wait: optional callback invoked between wait polls — the elastic
        hook: pass ``ElasticMonitor.check`` so a TTL-expired peer turns a
        hung allreduce into ``WorldChanged`` instead of a timeout.  Always
        invoked on the thread running the collective (the caller for sync
        ops, the async worker for ``*_async`` ops — re-raised from
        :meth:`Handle.wait`).
      timeout_s: per-collective deadline before :class:`PeerLost`.  The
        deadline is SHARED by every chunk of one collective: a peer dying
        mid-ring surfaces once, after ``timeout_s``, not once per
        remaining chunk.  For ``hier`` the SAME deadline covers all
        three phases — a rank dying between the intra-host and
        cross-host phases still surfaces within one ``timeout_s``.
      config: algorithm/fusion/compression knobs; defaults to
        :meth:`CollectiveConfig.from_env`.
      intra: optional intra-host plane for ``algorithm="hier"``
        (:class:`~tpudist_torch.runtime.ici.IciIntraHost` over the host's
        process group).  Must expose ``local_world`` / ``local_index`` /
        ``bounds(n)`` / ``reduce_scatter(vec)`` / ``all_gather(shard,
        n)`` and span exactly this rank's host group (``local_world ==
        world // config.hosts``).  When absent, the intra phases ride
        the coord store (the path the tests and chip_smoke drive) —
        lossless accumulation-dtype bytes either way.

    Error-feedback state (``compress="topk"``) is OWNED by the instance
    and keyed by bucket: dropped gradient mass re-enters this rank's
    next contribution.  A membership change means a new instance per
    round (the elastic worker's structure), so residuals are DROPPED —
    never replayed into a world they weren't accumulated against.

    Threading contract: collectives must be issued from one thread (SPMD
    programs issue them in lockstep anyway).  ``*_async`` submissions are
    executed in submission order on one background worker; a synchronous
    collective first drains the async queue, so operation ids stay agreed
    across ranks.
    """

    def __init__(
        self,
        client: CoordClient,
        rank: int,
        world: int,
        round_id: int = 0,
        namespace: str = "coll",
        on_wait: Callable[[], None] | None = None,
        timeout_s: float = 60.0,
        config: CollectiveConfig | None = None,
        intra: Any | None = None,
    ) -> None:
        self.client = client
        self.rank = rank
        self.world = world
        self.round_id = round_id
        self.ns = namespace
        self.on_wait = on_wait
        self.timeout_s = timeout_s
        self.config = config if config is not None \
            else CollectiveConfig.from_env()
        self.intra = intra
        self._op = 0
        self._posted: dict[int, list[str]] = {}  # op -> keys (for GC)
        self.bytes_posted = 0     # per-instance wire accounting (the
        self.bytes_fetched = 0    # tests and chip_smoke read these)
        self.bytes_posted_cross = 0   # hier: cross-host ring bytes only —
        self.bytes_fetched_cross = 0  # the wire the 2(H-1)/H bound is about
        self._in_cross = False
        # tpudist's obs counters, also as plain per-instance attributes:
        # calls by kind (``allreduce~algo=ring~compress=bf16``, ...),
        # seconds in allreduces and in fetch waits, the last compression
        # ratio, and the device<->host staging seconds of tensor leaves
        self.calls: dict[str, int] = {}
        self.allreduce_s = 0.0
        self.fetch_wait_s = 0.0
        self.compress_ratio: float | None = None
        self.stage_d2h_s = 0.0
        self.stage_h2d_s = 0.0
        # topk error feedback: (bucket index, length) -> residual vector;
        # replaced wholesale each op, so a tree-structure change simply
        # starts fresh, and instance-per-round drops it on resize
        self._residuals: dict[tuple[int, int], np.ndarray] = {}
        self._abort = threading.Event()
        self._io: _Prefetcher | None = None        # sync-path prefetcher
        self._async_io: _Prefetcher | None = None  # worker-path prefetcher
        self._async_client: CoordClient | None = None
        self._async_q: queue.Queue | None = None
        self._async_thread: threading.Thread | None = None
        self._pending: list[Handle] = []
        self._closed = False

    # -- keys, GC, raw post/fetch ------------------------------------------

    def _key(self, op: int, rank: int) -> str:
        return f"{self.ns}/{self.round_id}/{op}/{rank}"

    def _ring_key(self, op: int, phase: str, bucket: int,
                  idx: int, rank: int | None = None) -> str:
        tail = f"/{rank}" if rank is not None else ""
        return f"{self.ns}/{self.round_id}/{op}/{phase}/{bucket}/{idx}{tail}"

    def _begin_op(self, client: CoordClient, gc: bool = True) -> int:
        """Allocate the next operation id and GC everything this rank
        posted for ops ``<= op - 2`` (every peer consumed those before
        posting ``op - 1`` — see the module docstring's induction).

        A barrier (``gc=False``) deletes nothing.  The induction needs
        ``op - 1`` to have read every peer's post, and a broadcast's does
        not: its root reads nothing and the others read the root's post
        alone.  tpudist also collects at the barrier that closes a
        broadcast, so a rank still fetching an earlier allreduce's posts
        can find them deleted and wait out its deadline (ROADMAP Queue
        C 9).  The first op after the barrier, which every rank has
        passed, collects them instead."""
        op = self._op
        self._op += 1
        if gc:
            for old in [o for o in self._posted if o <= op - 2]:
                for key in self._posted.pop(old):
                    client.delete(key)
        return op

    def _count(self, kind: str) -> None:
        """One call of ``kind``: the plain tally and ``coll/{kind}``."""
        self.calls[kind] = self.calls.get(kind, 0) + 1
        obs.counter(f"coll/{kind}", unit="calls").inc()

    def _post(self, client: CoordClient, op: int, key: str,
              payload: bytes) -> None:
        obs.counter("coll/bytes_posted", unit="bytes").inc(len(payload))
        self.bytes_posted += len(payload)
        if self._in_cross:
            self.bytes_posted_cross += len(payload)
        client.set(key, payload)
        self._posted.setdefault(op, []).append(key)

    def _account_fetch(self, raw: bytes, waited_s: float) -> bytes:
        obs.counter("coll/bytes_fetched", unit="bytes").inc(len(raw))
        obs.histogram("coll/fetch_wait_s", unit="s").record(waited_s)
        self.fetch_wait_s += waited_s
        self.bytes_fetched += len(raw)
        if self._in_cross:
            self.bytes_fetched_cross += len(raw)
        return raw

    def _fetch(self, client: CoordClient, key: str, deadline: float,
               on_wait: Callable[[], None] | None) -> bytes:
        """Inline blocking fetch (flat + broadcast paths)."""
        t0 = time.perf_counter()
        while True:
            raw = client.get(key)
            if raw is not None:
                return self._account_fetch(raw, time.perf_counter() - t0)
            if on_wait is not None:
                on_wait()
            if self._abort.is_set():
                raise PeerLost(f"collective aborted waiting for {key}")
            if time.monotonic() > deadline:
                raise PeerLost(
                    f"peer never posted {key} within the collective's "
                    f"shared deadline ({self.timeout_s}s)")
            client.wait(key, timeout_s=0.2)

    def _take(self, io: _Prefetcher, key: str, deadline: float,
              on_wait: Callable[[], None] | None) -> bytes:
        t0 = time.perf_counter()
        raw = io.take(key, deadline, on_wait)
        return self._account_fetch(raw, time.perf_counter() - t0)

    def _peer_order(self) -> list[int]:
        """Every rank's fetch sequence starts at its RIGHT neighbor and
        wraps — rank-identical sequences would hot-spot rank 0's keys on
        the store with ``world`` simultaneous reads (the reduction order
        stays rank-/ring-fixed regardless; only the FETCH order
        staggers)."""
        return [(self.rank + i) % self.world for i in range(1, self.world)]

    # -- allreduce ----------------------------------------------------------

    def allreduce_sum(self, tree: Any) -> Any:
        """Sum a tree of arrays or tensors across all ranks.

        Dispatches on payload size and ``config.algorithm``: a flat
        post-everything/fetch-everyone gather for tiny trees, the chunked
        ring for everything else.  Either way every rank returns a
        bitwise-identical tree (see the module determinism contract) —
        the invariant the elastic grow test's checksum relies on."""
        self._drain_async()
        return self._run_allreduce(
            _stage(tree), self.client, on_wait=self.on_wait)

    def allreduce_mean(self, tree: Any) -> Any:
        """The sum divided by the world size, on the host as tpudist
        divides (an integer leaf's mean is float64, as numpy's)."""
        self._drain_async()
        return self._run_allreduce(
            _stage(tree), self.client, on_wait=self.on_wait, mean=True)

    def allreduce_sum_async(self, tree: Any) -> Handle:
        """Start an allreduce on the background worker; returns a
        :class:`Handle` whose :meth:`~Handle.wait` yields exactly what
        :meth:`allreduce_sum` would have returned (or re-raises the
        worker-side error).  Submissions run in order; a subsequent sync
        collective drains them first, so op ids stay SPMD-agreed.  A
        tensor leaf's device-to-host copy starts here, on the caller's
        stream, so the caller may update its tensors in place once this
        returns."""
        return self._submit("sum", tree)

    def allreduce_mean_async(self, tree: Any) -> Handle:
        return self._submit("mean", tree)

    def _submit(self, kind: str, tree: Any) -> Handle:
        if self._closed:
            raise PeerLost("collectives closed (round over)")
        self._count("allreduce_async")
        self._ensure_async_worker()
        handle = Handle()
        self._pending.append(handle)
        assert self._async_q is not None
        self._async_q.put((kind, _stage(tree), handle))
        return handle

    def _ensure_async_worker(self) -> None:
        if self._async_thread is None:
            # clone on the caller's thread so connection failures surface
            # here, not silently inside the worker
            self._async_client = self.client.clone()
            self._async_q = queue.Queue()
            self._async_thread = threading.Thread(
                target=self._async_loop, daemon=True,
                name="tpudist-coll-async")
            self._async_thread.start()

    def _async_loop(self) -> None:
        assert self._async_client is not None and self._async_q is not None
        try:
            while True:
                item = self._async_q.get()
                if item is None:
                    return
                kind, staged, handle = item
                try:
                    out = self._run_allreduce(
                        staged, self._async_client, on_wait=self.on_wait,
                        async_path=True, mean=kind == "mean")
                    handle._finish(result=out)
                except BaseException as e:  # noqa: BLE001 - re-raised at wait()
                    handle._finish(exc=e)
        finally:
            self._async_client.close()

    def _drain_async(self) -> None:
        """Wait for every outstanding async collective to complete (their
        errors stay with their handles).  Keeps sync and async ops
        totally ordered, so operation ids agree across ranks."""
        pending, self._pending = self._pending, []
        for h in pending:
            h._event.wait()

    # -- the allreduce engine ----------------------------------------------

    def _run_allreduce(self, staged: _Staged, client: CoordClient,
                       on_wait: Callable[[], None] | None,
                       async_path: bool = False, mean: bool = False) -> Any:
        self._count("allreduce")
        t_start = time.perf_counter()
        self.stage_d2h_s += staged.wait()
        np_leaves: list[np.ndarray] = staged.host  # type: ignore[assignment]
        total_bytes = sum(l.nbytes for l in np_leaves)
        if self.world == 1 or not np_leaves or total_bytes == 0:
            return self._finish(staged, [np.array(l, copy=True)
                                         for l in np_leaves], mean)
        buckets, plan = _fuse(np_leaves, self.config, staged.prefused)
        if self.config.compress == "topk":
            self._inject_residuals(buckets)
        wire_bytes = sum(b.wire_nbytes for b in buckets)
        algo = self.config.algorithm
        if algo == "auto":
            algo = ("flat" if self.world <= 2
                    or total_bytes <= self.config.flat_max_bytes else "ring")
        if algo == "hier":
            # viable only when hosts >= 2 contiguous groups of equal size
            # > 1 exist; the check is a pure function of (world, config),
            # so every rank falls back to the same plain ring — an
            # elastic shrink to a non-divisible world must not wedge
            L = self.world // max(self.config.hosts, 1)
            if (self.config.hosts < 2 or L < 2
                    or self.world % self.config.hosts):
                self._count("hier_fallback")
                algo = "ring"
        tag = f"~algo={algo}~compress={self.config.compress}"
        # tpudist counts coll/allreduce again here, so an allreduce past
        # the world-1 shortcut ticks it twice; the registry keeps that
        obs.counter("coll/allreduce", unit="calls").inc()
        self._count(f"allreduce{tag}")
        if wire_bytes:
            self.compress_ratio = total_bytes / wire_bytes
            obs.gauge("coll/compress_ratio").set(self.compress_ratio)
            obs.gauge(f"coll/compress_ratio{tag}").set(self.compress_ratio)
        p0, f0 = self.bytes_posted, self.bytes_fetched
        xp0, xf0 = self.bytes_posted_cross, self.bytes_fetched_cross
        op = self._begin_op(client)
        deadline = time.monotonic() + self.timeout_s
        io: _Prefetcher | None = None
        if algo in ("ring", "hier"):
            io = self._prefetcher(async_path)
        reducer = {"ring": self._ring, "hier": self._hier,
                   "flat": self._flat}[algo]
        reduced_buckets = reducer(buckets, op, client, io, deadline, on_wait)
        reduced: dict[str, list[np.ndarray]] = {}
        for b, vec in zip(buckets, reduced_buckets):
            reduced.setdefault(b.group, []).append(vec)
        out = self._finish(staged, _defuse(reduced, plan, np_leaves), mean)
        obs.counter(f"coll/bytes_posted{tag}", unit="bytes").inc(
            self.bytes_posted - p0)
        obs.counter(f"coll/bytes_fetched{tag}", unit="bytes").inc(
            self.bytes_fetched - f0)
        if algo == "hier":
            obs.counter(f"coll/cross_bytes_posted{tag}", unit="bytes").inc(
                self.bytes_posted_cross - xp0)
            obs.counter(f"coll/cross_bytes_fetched{tag}", unit="bytes").inc(
                self.bytes_fetched_cross - xf0)
        dt = time.perf_counter() - t_start
        self.allreduce_s += dt
        obs.histogram("coll/allreduce_s", unit="s").record(dt)
        obs.histogram(f"coll/allreduce_s{tag}", unit="s").record(dt)
        return out

    def _finish(self, staged: _Staged, results: list[np.ndarray],
                mean: bool) -> Any:
        """Divide for a mean (on the host, as tpudist), then rebuild the
        tree with each leaf as its own kind (the host-to-device copies
        timed into ``stage_h2d_s``)."""
        if mean:
            results = [_divide(r, self.world) for r in results]
        t0 = time.perf_counter()
        out = _unstage(staged, results)
        self.stage_h2d_s += time.perf_counter() - t0
        return out

    def _inject_residuals(self, buckets: list[_Bucket]) -> None:
        """Error feedback: fold the previous op's dropped mass into this
        rank's contribution, then arm fresh residual buffers for the
        drops the coming encodes will record.  Replacing the dict
        wholesale retires any bucket key the current tree no longer
        produces (a changed tree structure must not replay stale
        residuals into unrelated offsets)."""
        fresh: dict[tuple[int, int], np.ndarray] = {}
        for i, b in enumerate(buckets):
            if b.frac is None:
                continue
            prev = self._residuals.get((i, b.data.size))
            if prev is not None:
                # new array on purpose: b.data may alias the caller's
                # leaf (single-leaf groups fuse copy-free)
                b.data = b.data + prev
            b.residual = np.zeros(b.data.size, dtype=b.accum)
            fresh[(i, b.data.size)] = b.residual
        self._residuals = fresh

    def _prefetcher(self, async_path: bool) -> _Prefetcher:
        if async_path:
            if self._async_io is None:
                assert self._async_client is not None
                self._async_io = _Prefetcher(self._async_client, self._abort)
            return self._async_io
        if self._io is None:
            self._io = _Prefetcher(self.client, self._abort)
        return self._io

    def _flat(self, buckets: list[_Bucket], op: int, client: CoordClient,
              io: _Prefetcher | None, deadline: float,
              on_wait: Callable[[], None] | None) -> list[np.ndarray]:
        """All-gather + rank-ordered local reduce: one posted blob, one
        fetch per peer (staggered start — see :meth:`_peer_order`).  Best
        for tiny trees where ring round-trips dominate; O(world × size)
        fetch bytes otherwise."""
        payload = b"".join(_bucket_encode(b, b.data) for b in buckets)
        self._post(client, op, self._key(op, self.rank), payload)
        raws: dict[int, bytes] = {self.rank: payload}
        for r in self._peer_order():
            raws[r] = self._fetch(client, self._key(op, r), deadline, on_wait)
        out: list[np.ndarray] = []
        off = 0
        for b in buckets:
            blen = b.wire_nbytes
            acc: np.ndarray | None = None
            # reduction in RANK ORDER on every participant, over the
            # POSTED (wire-encoded) payloads — own contribution included,
            # so compression rounding is identical on every rank and
            # float non-associativity cannot diverge replicas
            for r in range(self.world):
                contrib = _bucket_decode(b, raws[r][off:off + blen],
                                         len(b.data))
                if acc is None:
                    acc = np.array(contrib, copy=True)
                else:
                    acc += contrib
            out.append(acc if acc is not None
                       else np.empty(0, b.accum))
            off += blen
        return out

    def _ring(self, buckets: list[_Bucket], op: int, client: CoordClient,
              io: _Prefetcher | None, deadline: float,
              on_wait: Callable[[], None] | None) -> list[np.ndarray]:
        """Chunked ring reduce-scatter + star all-gather over ALL ranks
        (see module docstring)."""
        jobs = [(str(bi), b, b.data, 0) for bi, b in enumerate(buckets)]
        return self._ring_pass(op, client, io, deadline, on_wait, jobs,
                               members=list(range(self.world)),
                               pos=self.rank)

    def _ring_pass(self, op: int, client: CoordClient,
                   io: _Prefetcher | None, deadline: float,
                   on_wait: Callable[[], None] | None,
                   jobs: list[tuple[str, _Bucket, np.ndarray, int]],
                   members: list[int], pos: int,
                   phase_rs: str = "rs",
                   phase_ag: str = "ag") -> list[np.ndarray]:
        """Chunked ring reduce-scatter + star all-gather over the ranks
        in ``members`` (this rank at position ``pos``) — the engine
        behind both the flat-world ring and each of hier's per-shard
        cross-host rings.  ``jobs`` carries ``(key token, bucket, vector,
        bucket-global base offset)`` per reduction; the base offset is
        where topk error-feedback drops land in the bucket's residual.
        The prefetcher keeps the NEXT hop's store wait in flight while
        this hop's chunk is being reduced."""
        assert io is not None
        ring = len(members)
        left = members[(pos - 1) % ring]
        own_final = (pos + 1) % ring  # ring position this rank finishes
        bounds = [_chunk_bounds(len(vec), ring) for _, _, vec, _ in jobs]
        # post every job's step-0 chunk up front: peers' prefetchers
        # find their first hop immediately, and bucket k+1's ring can
        # absorb store latency while bucket k reduces
        for ji, (tok, b, vec, base) in enumerate(jobs):
            lo, hi = bounds[ji][pos]
            self._post(client, op, self._ring_key(op, phase_rs, tok, 0,
                                                  members[pos]),
                       _bucket_encode(b, vec[lo:hi], base + lo))
        out: list[np.ndarray] = []
        for ji, (tok, b, vec, base) in enumerate(jobs):
            io.submit(self._ring_key(op, phase_rs, tok, 0, left), deadline)
            final_enc: bytes | None = None
            acc: np.ndarray | None = None
            for s in range(ring - 1):
                if s + 1 < ring - 1:
                    # pipeline: next hop's fetch rides the prefetcher
                    # while this hop decodes + reduces
                    io.submit(self._ring_key(op, phase_rs, tok, s + 1, left),
                              deadline)
                t0 = time.perf_counter()
                raw = self._take(
                    io, self._ring_key(op, phase_rs, tok, s, left), deadline,
                    on_wait)
                c = (pos - 1 - s) % ring
                lo, hi = bounds[ji][c]
                # fp32 (accum-dtype) add of the decoded partial and this
                # rank's own chunk; exactly ONE rank performs each hop,
                # so the per-chunk reduction order is ring-fixed
                acc = _bucket_decode(b, raw, hi - lo) + vec[lo:hi]
                if s + 1 < ring - 1:
                    self._post(
                        client, op,
                        self._ring_key(op, phase_rs, tok, s + 1,
                                       members[pos]),
                        _bucket_encode(b, acc, base + lo))
                else:
                    final_enc = _bucket_encode(b, acc, base + lo)
                obs.histogram("coll/ring_chunk_s", unit="s").record(
                    time.perf_counter() - t0)
            # all-gather over the store's star topology: post the finished
            # chunk ONCE; every peer fetches the owner's single post (ring
            # forwarding would re-upload each chunk world-2 more times)
            assert final_enc is not None
            self._post(client, op,
                       self._ring_key(op, phase_ag, tok, own_final),
                       final_enc)
            order = [(own_final + i) % ring for i in range(1, ring)]
            for c in order:
                io.submit(self._ring_key(op, phase_ag, tok, c), deadline)
            flo, fhi = bounds[ji][own_final]
            pieces: dict[int, np.ndarray] = {
                # decode own ENCODED bytes, not the raw accumulator: with
                # compression on, peers decode the posted wire payload —
                # bitwise agreement requires this rank to do the same
                own_final: _bucket_decode(b, final_enc, fhi - flo)}
            for c in order:
                raw = self._take(io, self._ring_key(op, phase_ag, tok, c),
                                 deadline, on_wait)
                lo, hi = bounds[ji][c]
                pieces[c] = _bucket_decode(b, raw, hi - lo)
            vec_out = np.empty(len(vec), b.accum)
            for c in range(ring):
                lo, hi = bounds[ji][c]
                vec_out[lo:hi] = pieces[c]
            out.append(vec_out)
        return out

    def _hier(self, buckets: list[_Bucket], op: int, client: CoordClient,
              io: _Prefetcher | None, deadline: float,
              on_wait: Callable[[], None] | None) -> list[np.ndarray]:
        """Hierarchical allreduce: (1) reduce-scatter each bucket within
        the host group — over the injected intra-host plane when present,
        else over the store in lossless accum-dtype bytes; (2) for
        shard ``j``, run the chunked cross-host ring among the H ranks
        holding shard ``j`` — ONE representative per host, so the
        cross-host wire carries ``2·(H-1)/H × size`` per HOST instead of
        per rank, and compression (bf16/topk) applies exactly here;
        (3) all-gather the finished shards back within the host.

        Determinism: each final shard has exactly one computation path
        (local-rank-ordered intra reduce, then ring-fixed hops), its
        ring all-gather bytes are decoded identically by all H holders,
        and the intra all-gather re-posts those identical arrays as raw
        bytes — so all ``world`` ranks agree bitwise.  All three phases
        share one deadline: a rank dying between phases surfaces as
        :class:`PeerLost` within one ``timeout_s``."""
        from tpudist_torch.runtime import faults

        H = self.config.hosts
        L = self.world // H
        host, j = divmod(self.rank, L)
        locals_ = [host * L + i for i in range(L)]
        plane = self.intra
        if plane is not None and (plane.local_world != L
                                  or plane.local_index != j):
            raise ValueError(
                f"intra plane spans {plane.local_world} ranks at index "
                f"{plane.local_index}; hier expects host groups of {L} "
                f"with this rank at local index {j}")
        # tpudist's compiled ICI path carries f32/int32 exactly; wider
        # dtypes (f64, int64) ride the lossless store path even when a
        # plane is present — a pure function of the bucket dtype, so
        # every replica agrees
        on_plane = [plane is not None
                    and b.accum in (np.float32, np.int32)
                    for b in buckets]
        sbounds = [plane.bounds(len(b.data)) if on_plane[bi]
                   else _chunk_bounds(len(b.data), L)
                   for bi, b in enumerate(buckets)]
        faults.on_coll_phase("hier_intra", self.rank)
        # -- phase 1: intra-host reduce-scatter (lossless) ------------------
        shards: list[np.ndarray] = []
        for bi, b in enumerate(buckets):
            if not on_plane[bi]:
                for i in range(L):
                    if i == j:
                        continue
                    lo, hi = sbounds[bi][i]
                    self._post(
                        client, op,
                        self._ring_key(op, "hrs", bi, locals_[i], self.rank),
                        np.ascontiguousarray(b.data[lo:hi]).tobytes())
        for bi, b in enumerate(buckets):
            if on_plane[bi]:
                shards.append(np.asarray(plane.reduce_scatter(b.data),
                                         dtype=b.accum))
                continue
            lo, hi = sbounds[bi][j]
            acc: np.ndarray | None = None
            # fixed LOCAL-RANK order — the hier leg of the topology-
            # derived reduction-order contract
            for i in range(L):
                if locals_[i] == self.rank:
                    contrib: np.ndarray = b.data[lo:hi]
                else:
                    raw = self._fetch(
                        client,
                        self._ring_key(op, "hrs", bi, self.rank,
                                       locals_[i]),
                        deadline, on_wait)
                    contrib = np.frombuffer(raw, dtype=b.accum)
                acc = (np.array(contrib, copy=True) if acc is None
                       else acc + contrib)
            shards.append(acc if acc is not None
                          else np.empty(0, b.accum))
        # -- phase 2: cross-host ring, one representative per host ----------
        faults.on_coll_phase("hier_cross", self.rank)
        ring_members = [g * L + j for g in range(H)]
        jobs = [(f"{bi}.{j}", b, svec, sbounds[bi][j][0])
                for bi, (b, svec) in enumerate(zip(buckets, shards))]
        self._in_cross = True
        try:
            reduced_shards = self._ring_pass(
                op, client, io, deadline, on_wait, jobs,
                members=ring_members, pos=host,
                phase_rs="xrs", phase_ag="xag")
        finally:
            self._in_cross = False
        # -- phase 3: intra-host all-gather of finished shards --------------
        faults.on_coll_phase("hier_ag", self.rank)
        for bi, rvec in enumerate(reduced_shards):
            if not on_plane[bi]:
                self._post(client, op,
                           self._ring_key(op, "hag", bi, self.rank),
                           np.ascontiguousarray(rvec).tobytes())
        out: list[np.ndarray] = []
        for bi, (b, rvec) in enumerate(zip(buckets, reduced_shards)):
            if on_plane[bi]:
                out.append(np.asarray(plane.all_gather(rvec, len(b.data)),
                                      dtype=b.accum))
                continue
            vec = np.empty(len(b.data), b.accum)
            lo, hi = sbounds[bi][j]
            vec[lo:hi] = rvec
            for i in range(L):
                if i == j:
                    continue
                raw = self._fetch(
                    client, self._ring_key(op, "hag", bi, locals_[i]),
                    deadline, on_wait)
                lo, hi = sbounds[bi][i]
                vec[lo:hi] = np.frombuffer(raw, dtype=b.accum)
            out.append(vec)
        return out

    # -- broadcast / barrier ------------------------------------------------

    def broadcast(self, tree: Any, root: int = 0) -> Any:
        """Every rank returns root's tree (``hvd.broadcast_parameters``
        role, `mnist_horovod.py:56` — state agreement after a resize).
        Payload rides uncompressed npz: state agreement must be EXACT,
        unlike gradient sync there is no accumulation to absorb rounding.
        The root returns ``tree`` itself; every other rank returns the
        root's values in its own tree's kinds (a tensor leaf on its
        device and in its dtype), the shapes the root's.

        Synchronizing: a trailing barrier guarantees every peer consumed
        the payload before anyone proceeds — without it, the root's op-2
        key GC could delete a broadcast a slow peer hasn't read yet
        (allreduce doesn't need this: posting op N implies having read
        every peer's op N-1)."""
        self._drain_async()
        self._count("broadcast")
        staged = _stage(tree)
        op = self._begin_op(self.client)
        if self.rank == root:
            staged.wait()
            self._post(self.client, op, self._key(op, root),
                       _dumps(staged.host))  # type: ignore[arg-type]
            out_tree = tree
        else:
            deadline = time.monotonic() + self.timeout_s
            out_tree = _unstage(staged, _loads(self._fetch(
                self.client, self._key(op, root), deadline, self.on_wait)))
        self.barrier()
        return out_tree

    def barrier(self, timeout_s: float | None = None) -> None:
        """All-ranks barrier for this round (native store barrier)."""
        self._drain_async()
        self._count("barrier")
        op = self._begin_op(self.client, gc=False)
        ok = self.client.barrier(
            f"{self.ns}/{self.round_id}/bar/{op}", self.world,
            timeout_s or self.timeout_s)
        if not ok:
            raise PeerLost(f"barrier {op} timed out at world {self.world}")

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Stop background workers (async executor + prefetchers) and
        abort any in-flight waits with :class:`PeerLost`.  Idempotent;
        does NOT close the caller-owned ``client``."""
        if self._closed:
            return
        self._closed = True
        self._abort.set()
        if self._async_q is not None:
            self._async_q.put(None)
        for io in (self._io, self._async_io):
            if io is not None:
                io.close()

    def close_round(self) -> None:
        """Delete every key this round left in the store (called before
        re-rendezvous so dead rounds cannot accumulate; idempotent —
        every survivor may call it).  Also tears down this instance's
        background workers: a dead round's async op must not keep
        fetching."""
        self.close()
        for key in self.client.keys(f"{self.ns}/{self.round_id}/"):
            try:
                self.client.delete(key)
            except ConnectionError:
                return
