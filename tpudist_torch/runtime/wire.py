"""Checksummed wire format for coord KV payloads
(counterpart of :mod:`tpudist.runtime.wire`).

The fleet's coordination traffic (requests, completions, journal
records, probe/exit reports) crosses process and machine boundaries as
raw bytes in the coord KV store.  The router's failure handling makes
the fleet robust to payloads that *vanish* (dead replicas, killed
routers, brownouts); this module is the defense against payloads that
*arrive wrong* — a
bit-flipped buffer from flaky HBM, a truncated write, a replica
speaking a schema the router does not.

Every framed payload is::

    b"TPW1" | crc32c (4 bytes, big-endian) | kind tag (1 byte) | body

where the checksum covers the kind tag AND the JSON body, so a flip
anywhere past the magic is caught at decode.  The magic prefix keeps
framed and legacy payloads distinguishable: :func:`decode_record`
accepts UNFRAMED plain-JSON payloads (pre-integrity writers, the
offline simulator's fakes, tests that plant done keys by hand) without
a checksum — integrity is opt-in per writer, never a flag-day.

Checksum choice: CRC32C (Castagnoli), the polynomial storage and
transport stacks (iSCSI, ext4, gRPC) standardized on for exactly this
silent-corruption class — and computable with a 256-entry table in
pure Python, because the container may not grow new dependencies.  A
large payload (a KV page handoff runs to tens of MB) is checksummed
column-parallel with numpy: 4096 equal slices advance together one byte
a step, and their registers are folded with the linear operator "feed a
slice's length of zero bytes", which gives the very same CRC as the
byte loop.
This is an INTEGRITY check, not authentication: it catches flipped
bits, not an adversary (who could recompute it).

Decode failures raise :class:`WireError` — one typed error carrying
``reason`` (``checksum`` / ``truncated`` / ``schema`` / ``json`` /
``kind``) plus the namespace/key/replica attribution the router needs
to count the mismatch against the offending replica and redispatch the
request instead of crashing the poll loop (or worse, delivering the
corruption).
"""

from __future__ import annotations

import functools
import json
import struct

import numpy as np

__all__ = ["WIRE_MAGIC", "WIRE_KINDS", "WireError", "crc32c",
           "encode_record", "decode_record"]

WIRE_MAGIC = b"TPW1"

# kind -> tag byte.  The tag is covered by the checksum, so a flipped
# tag surfaces as reason="checksum", not as a bogus schema verdict.
WIRE_KINDS = {
    "request": 1,      # router -> replica inbox dispatch (golden
    #                    probes ride this kind too: to a replica a
    #                    probe IS a request)
    "completion": 2,   # replica -> router done commit
    "journal": 3,      # router crash-recovery lifecycle record
    "heartbeat": 4,    # liveness/exit report payloads
    "prefix": 5,       # replica -> router prefix-cache affinity summary
    "kv_migration": 6,  # prefill replica -> decode replica KV handoff
    #                     (ordered pages + lengths + prefix-hash chain;
    #                     see tpudist_torch.runtime.disagg)
    "pullreq": 7,      # router -> owner replica: export a prefix run
    #                    from HBM/host tier for a peer (pull-mode KV)
    "pulldone": 8,     # owner replica -> router: export finished, the
    #                    payload's transport ref (or null on a miss)
}
_TAG_TO_KIND = {tag: kind for kind, tag in WIRE_KINDS.items()}

_HEADER = struct.Struct(">4sIB")   # magic, crc32c, kind tag


class WireError(RuntimeError):
    """A coord KV payload that failed integrity verification.

    Attributes:
      reason: ``checksum`` (crc mismatch), ``truncated`` (shorter than
        its header), ``schema`` (unknown kind tag), ``json`` (body or
        legacy payload is not valid JSON), or ``kind`` (valid frame of
        the wrong record type for this decode site).
      kind: the record kind, when the frame was readable enough to know.
      namespace / key / replica: attribution filled in by the decode
        site so the router can count the strike against the replica
        that produced the bytes.
    """

    def __init__(self, reason: str, *, kind: str | None = None,
                 namespace: str = "", key: str = "",
                 replica: str = "") -> None:
        self.reason = str(reason)
        self.kind = kind
        self.namespace = str(namespace)
        self.key = str(key)
        self.replica = str(replica)
        where = "/".join(p for p in (self.namespace, self.key) if p)
        who = f" from replica {self.replica}" if self.replica else ""
        super().__init__(
            f"wire integrity failure ({self.reason})"
            f"{f' decoding {where}' if where else ''}{who}")


# -- crc32c
# (Castagnoli, reflected 0x82F63B78; table-driven, stdlib-only) -----

_CRC32C_POLY = 0x82F63B78


def _build_table() -> tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C_TABLE = _build_table()


_CRC32C_NP = np.asarray(_CRC32C_TABLE, np.uint32)

# payloads from this size on take the column-parallel path
_PARALLEL_MIN = 1 << 16
_LANES = 4096


def _feed(data, reg: int) -> int:
    """The CRC register after ``data`` (no pre/post inversion)."""
    for b in data:
        reg = _CRC32C_TABLE[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


@functools.lru_cache(maxsize=8)
def _zeros_operator(n: int) -> tuple[tuple[int, ...], ...]:
    """Four byte tables of the linear map "feed ``n`` zero bytes" on the
    register: the image of ``reg`` is the XOR of ``tabs[b][byte b]``."""
    img = np.asarray([1 << i for i in range(32)], np.uint32)
    for _ in range(n):
        img = _CRC32C_NP[img & 0xFF] ^ (img >> 8)
    tabs = []
    for b in range(4):
        cols = img[8 * b:8 * b + 8].tolist()
        tab = [0] * 256
        for v in range(1, 256):
            low = v & -v
            tab[v] = tab[v ^ low] ^ cols[low.bit_length() - 1]
        tabs.append(tuple(tab))
    return tuple(tabs)


def _feed_parallel(data: bytes, reg: int) -> int:
    """:func:`_feed` over ``_LANES`` equal slices at once: each slice's
    register from zero, folded in order as ``reg = Z(reg) ^ r_i`` (``Z``
    feeds a slice's length of zeros; the register map is affine)."""
    n = len(data) // _LANES
    cols = np.ascontiguousarray(np.frombuffer(
        data, np.uint8, count=_LANES * n).reshape(_LANES, n).T)
    regs = np.zeros(_LANES, np.uint32)
    for j in range(n):
        regs = _CRC32C_NP[(regs ^ cols[j]) & 0xFF] ^ (regs >> 8)
    t0, t1, t2, t3 = _zeros_operator(n)
    for r in regs.tolist():
        reg = (t0[reg & 0xFF] ^ t1[(reg >> 8) & 0xFF]
               ^ t2[(reg >> 16) & 0xFF] ^ t3[reg >> 24] ^ r)
    return _feed(memoryview(data)[_LANES * n:], reg)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data``; pass a previous result as ``crc`` to
    checksum a stream incrementally."""
    reg = crc ^ 0xFFFFFFFF
    if len(data) >= _PARALLEL_MIN:
        reg = _feed_parallel(bytes(data), reg)
    else:
        reg = _feed(data, reg)
    return reg ^ 0xFFFFFFFF


# -- framing ---------------------------------------------------------------

def encode_record(kind: str, doc: dict) -> bytes:
    """Frame ``doc`` as a checksummed ``kind`` payload."""
    tag = WIRE_KINDS.get(kind)
    if tag is None:
        raise ValueError(f"unknown wire record kind {kind!r} "
                         f"(known: {sorted(WIRE_KINDS)})")
    body = bytes([tag]) + json.dumps(doc).encode()
    return WIRE_MAGIC + struct.pack(">I", crc32c(body)) + body


def decode_record(payload: bytes, *, expect: str | None = None,
                  namespace: str = "", key: str = "",
                  replica: str = "") -> dict:
    """Verify and decode one payload; returns the JSON document.

    Framed payloads (magic prefix) are checksum-verified and, when
    ``expect`` is given, kind-checked.  Unframed payloads fall back to
    plain JSON — the pre-integrity wire — with no checksum to verify
    (``expect`` is not enforced either: legacy writers carry no kind).
    Any failure raises :class:`WireError` carrying the attribution
    kwargs verbatim.
    """
    def err(reason: str, kind: str | None = None) -> WireError:
        return WireError(reason, kind=kind, namespace=namespace,
                         key=key, replica=replica)

    if not payload.startswith(WIRE_MAGIC):
        try:
            doc = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            raise err("json") from None
        if not isinstance(doc, dict):
            raise err("json")
        return doc
    if len(payload) < _HEADER.size:
        raise err("truncated")
    _, want_crc, tag = _HEADER.unpack_from(payload)
    body = payload[len(WIRE_MAGIC) + 4:]
    if crc32c(body) != want_crc:
        raise err("checksum")
    kind = _TAG_TO_KIND.get(tag)
    if kind is None:
        # unreachable via corruption (the tag is checksummed) — this is
        # a WRITER from a future schema this reader does not know
        raise err("schema")
    if expect is not None and kind != expect:
        raise err("kind", kind=kind)
    try:
        doc = json.loads(body[1:].decode())
    except (ValueError, UnicodeDecodeError):
        raise err("json", kind=kind) from None
    if not isinstance(doc, dict):
        raise err("json", kind=kind)
    return doc
