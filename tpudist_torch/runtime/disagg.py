"""KV-page migration for disaggregated prefill/decode serving
(counterpart of :mod:`tpudist.runtime.disagg`).

The fleet's two request phases have opposite compute shapes: prefill is
compute-bound and bursty (one big attention pass over the whole prompt),
decode is memory-bound and steady (one token per step against a growing
KV cache).  A unified replica runs both, so a long prompt's prefill
chunks steal step time from every decoding lane behind it.
Disaggregation splits the fleet — ``ServeLoop(role="prefill")`` replicas
run chunked prefill to completion and HAND the finished KV state to
``ServeLoop(role="decode")`` replicas, which adopt the pages and decode
without ever re-running the prompt.

This module is the transport between them.  One payload per handoff::

    {"key":        router request key (the handoff's identity),
     "rid":        caller-visible request id,
     "prompt":     [token ids],          # re-prefill fallback needs it
     "max_new_tokens": int,              # post-degrade-clamp budget
     "first":      int,                  # token sampled at prefill end
     "true_len":   int,                  # prompt length in tokens
     "block_size": int,                  # exporter's KV page size
     "chain":      [ints],               # prefix-hash chain over the
                                         #   prompt's FULL blocks — the
                                         #   adopter recomputes and
                                         #   compares before trusting
                                         #   the pages
     "published_at": float,              # wall clock at publish; the
                                         #   adopter's handoff_wait_s
     "layers":     [{"k": ndarray, "v": ndarray}, ...]}
                                         # per paged layer, cache-walk
                                         #   order, [used_blocks, bs, F]

Two OPTIONAL riders extend the same schema to mid-decode migration
(priority preemption, hot/cold rebalancing, fast drain):

    {"generated":  [token ids],          # tokens already emitted by the
                                         #   exporter, EXCLUDING "first";
                                         #   the adopter seeds its output
                                         #   with them, the chain covers
                                         #   prompt+generated, and
                                         #   true_len = len(prompt) +
                                         #   len(generated)
     "version":    int}                  # exporter's weights_version;
                                         #   an adopter on different
                                         #   weights refuses the pages
                                         #   and re-prefills (a roll in
                                         #   flight must not mix KV
                                         #   across versions)

Two transports implement one interface:

* :class:`CoordKVTransport` — the baseline path: the payload crosses the
  coord KV store at ``{ns}/kv/{key}`` as a checksummed
  ``kind="kv_migration"`` frame (:mod:`tpudist_torch.runtime.wire`), arrays
  base64-packed with dtype/shape.  Works across any process/host pair
  that shares the store; a corrupt or missing payload surfaces as
  ``fetch() -> None`` and the decode side re-prefills from the prompt.
* :class:`IciKVTransport` — the fast path: page tensors move through an
  in-process registry, optionally copied onto the decode replica's
  device with ``.to(device, non_blocking=True)`` (a real device-to-device
  copy on multi-card hosts) — zero serialization for the page bytes.
  Cross-HOST device transport would ride a formed
  :class:`~tpudist_torch.runtime.ici.IciDataPlane` world the same way
  gradients do; the registry keeps the interface identical so that
  extension swaps in behind ``fetch``/``publish`` untouched.

Loss anywhere is survivable by construction: the payload is an
OPTIMIZATION, never the source of truth.  The request (with its prompt)
rides the router's journal; a decode replica whose ``fetch`` misses —
dropped payload (``TPUDIST_FAULT_HANDOFF_DROP``), checksum mismatch,
exporter SIGKILLed pre-commit (``TPUDIST_FAULT_KILL_AT_HANDOFF``) —
falls back to an ordinary prefill of the same prompt, and greedy
decoding over fleet-identical weights makes the fallback output
byte-identical to the migrated path.  See docs/DESIGN.md
"Disaggregated serving" for the two-stage scheduler and the
exactly-once ordering around the handoff commit.
"""

from __future__ import annotations

import base64
import time

import numpy as np
import torch

from tpudist_torch import obs
from tpudist_torch.runtime import faults, wire
from tpudist_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["KVTransport", "CoordKVTransport", "IciKVTransport",
           "make_transport", "encode_payload", "decode_payload",
           "payload_nbytes"]


# -- payload codec ---------------------------------------------------------

def _raw_words(a) -> tuple[bytes, str, list]:
    """``(bytes, dtype tag, shape)`` of one page array.  numpy arrays
    keep tpudist's ``str(a.dtype)`` tag; a bf16 CPU tensor (numpy has no
    bf16 without ``ml_dtypes``), like a numpy bf16 array, is tagged
    ``"bfloat16"`` and carries its raw 2-byte words."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), "bfloat16",
                    list(t.shape))
        a = t.numpy()
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype.name == "bfloat16"):
        return a.view(np.int16).tobytes(), "bfloat16", list(a.shape)
    return a.tobytes(), str(a.dtype), list(a.shape)


def _pack_array(a) -> dict:
    raw, dtype, shape = _raw_words(a)
    return {"b64": base64.b64encode(raw).decode("ascii"),
            "dtype": dtype, "shape": shape}


def _unpack_array(d: dict):
    """numpy for every tag numpy knows; a bf16 CPU tensor for
    ``"bfloat16"``."""
    raw = base64.b64decode(d["b64"])
    if d["dtype"] == "bfloat16":
        words = torch.frombuffer(bytearray(raw), dtype=torch.int16)
        return words.view(torch.bfloat16).reshape(d["shape"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def encode_payload(payload: dict) -> dict:
    """JSON-safe document from a handoff payload (arrays base64-packed
    with dtype/shape so the decode side rebuilds them bit-exact)."""
    doc = {k: v for k, v in payload.items() if k != "layers"}
    doc["prompt"] = [int(t) for t in payload["prompt"]]
    doc["chain"] = [int(h) for h in payload["chain"]]
    if "generated" in payload:
        doc["generated"] = [int(t) for t in payload["generated"]]
    doc["layers"] = [{"k": _pack_array(l["k"]), "v": _pack_array(l["v"])}
                     for l in payload["layers"]]
    return doc


def decode_payload(doc: dict) -> dict:
    """Inverse of :func:`encode_payload`; raises ``KeyError`` /
    ``ValueError`` on a structurally broken document (callers treat
    that like a lost payload and re-prefill)."""
    out = {k: v for k, v in doc.items() if k != "layers"}
    out["prompt"] = [int(t) for t in doc["prompt"]]
    out["chain"] = [int(h) for h in doc["chain"]]
    if "generated" in doc:
        out["generated"] = [int(t) for t in doc["generated"]]
    out["layers"] = [{"k": _unpack_array(l["k"]),
                      "v": _unpack_array(l["v"])}
                     for l in doc["layers"]]
    return out


def payload_nbytes(payload: dict) -> int:
    """KV bytes a payload carries (the page arrays; the metadata is
    noise next to them)."""
    return int(sum(_nbytes(l["k"]) + _nbytes(l["v"])
                   for l in payload.get("layers", ())))


# -- the transport interface -----------------------------------------------

class KVTransport:
    """One KV handoff channel: prefill side publishes, decode side
    fetches, the ROUTER deletes (payload lifecycle belongs to the
    request's owner, so an exporter death cannot leak it).

    Both implementations tick ``serve/handoffs`` and
    ``serve/handoff_bytes`` at publish and record ``serve/handoff_wait_s``
    (publish -> adoption wall time) at fetch, so the observability rows
    are transport-independent.
    """

    def __init__(self) -> None:
        self._obs_handoffs = obs.counter("serve/handoffs", unit="reqs")
        self._obs_bytes = obs.counter("serve/handoff_bytes", unit="bytes")
        self._obs_wait = obs.histogram("serve/handoff_wait_s", unit="s")

    def publish(self, key: str, payload: dict, *,
                kind: str = "handoff") -> tuple[str, int]:
        """Ship one payload; returns ``(ref, nbytes)``.  ``ref`` is the
        opaque token the decode side fetches by (it rides the router's
        dispatch doc and journal record).  ``kind`` selects which fault
        knob can swallow the publish: ``"handoff"`` (prefill→decode
        seam, ``HANDOFF_DROP``) or ``"migrate"`` (mid-decode
        preemption/rebalance/drain, ``MIGRATE_DROP``)."""
        raise NotImplementedError

    def fetch(self, ref: str) -> dict | None:
        """The payload behind ``ref``, or ``None`` when it is missing
        or fails verification — the caller's signal to re-prefill."""
        raise NotImplementedError

    def delete(self, ref: str) -> None:
        """Drop the payload (terminal consumption or redispatch).
        Idempotent; never raises on a missing ref."""
        raise NotImplementedError

    # shared metric tails -------------------------------------------------

    def _published(self, n: int) -> None:
        self._obs_handoffs.inc()
        self._obs_bytes.inc(n)

    def _fetched(self, payload: dict) -> dict:
        at = payload.get("published_at")
        if at is not None:
            self._obs_wait.record(max(0.0, time.time() - float(at)))
        return payload


class CoordKVTransport(KVTransport):
    """Baseline path: checksummed ``kv_migration`` frames in the coord
    KV store at ``{ns}/kv/{key}``.  Crosses any boundary the store does;
    costs one serialize + one round-trip each way."""

    def __init__(self, client, *, namespace: str = "fleet") -> None:
        super().__init__()
        self.client = client
        self.ns = namespace

    def publish(self, key: str, payload: dict, *,
                kind: str = "handoff") -> tuple[str, int]:
        ref = f"{self.ns}/kv/{key}"
        raw = wire.encode_record("kv_migration", encode_payload(payload))
        dropped = (faults.drop_migrate() if kind == "migrate"
                   else faults.drop_handoff())
        if dropped:
            # injected in-flight loss: the exporter believes the publish
            # landed (ref returned, done committed) but the payload
            # never reaches the store — the adopting side MUST fall back
            log.warning("disagg: %s_DROP injected; payload %s "
                        "lost in flight", kind.upper(), key)
        else:
            self.client.set(ref, raw)
        self._published(len(raw))
        return ref, len(raw)

    def fetch(self, ref: str) -> dict | None:
        try:
            raw = self.client.get(ref)
        except ConnectionError:
            return None
        if raw is None:
            return None
        try:
            doc = wire.decode_record(raw, expect="kv_migration",
                                     namespace=self.ns, key=ref)
            return self._fetched(decode_payload(doc))
        except (wire.WireError, KeyError, ValueError, TypeError) as e:
            # corrupt migration payload: never adopt it — count, drop,
            # and let the re-prefill fallback produce the exact output
            obs.counter("integrity/checksum_mismatch",
                        unit="payloads").inc()
            log.warning("disagg: undecodable KV payload %s (%s); "
                        "forcing re-prefill", ref, e)
            self.delete(ref)
            return None

    def delete(self, ref: str) -> None:
        try:
            self.client.delete(ref)
        except ConnectionError:
            pass


def _on_device(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, non_blocking=True)


class IciKVTransport(KVTransport):
    """Fast path: payloads move by reference through an in-process
    registry, page arrays optionally copied onto the decode side's device
    (``.to(device, non_blocking=True)``) — the intra-host shape of
    device-to-device migration.
    Share ONE instance between the prefill and decode loops (the bench's
    colocated-fleet mode); a cross-host fleet uses the coord path or a
    formed ICI world behind this same interface."""

    def __init__(self, *, device=None) -> None:
        super().__init__()
        self.device = device
        self._store: dict[str, dict] = {}

    def publish(self, key: str, payload: dict, *,
                kind: str = "handoff") -> tuple[str, int]:
        ref = f"ici://{key}"
        n = payload_nbytes(payload)
        dropped = (faults.drop_migrate() if kind == "migrate"
                   else faults.drop_handoff())
        if dropped:
            log.warning("disagg: %s_DROP injected; payload %s "
                        "lost in flight", kind.upper(), key)
        else:
            if self.device is not None:
                payload = dict(payload)
                payload["layers"] = [
                    {"k": _on_device(l["k"], self.device),
                     "v": _on_device(l["v"], self.device)}
                    for l in payload["layers"]]
            self._store[ref] = payload
        self._published(n)
        return ref, n

    def fetch(self, ref: str) -> dict | None:
        payload = self._store.get(ref)
        return None if payload is None else self._fetched(payload)

    def delete(self, ref: str) -> None:
        self._store.pop(ref, None)


def make_transport(kind: str, *, client=None, namespace: str = "fleet",
                   device=None) -> KVTransport:
    """``"coord"`` (baseline, needs ``client``) or ``"ici"`` (in-process
    fast path)."""
    if kind == "coord":
        if client is None:
            raise ValueError("coord transport needs a CoordClient")
        return CoordKVTransport(client, namespace=namespace)
    if kind == "ici":
        return IciKVTransport(device=device)
    raise ValueError(f"unknown KV transport {kind!r} "
                     f"(known: 'coord', 'ici')")
