"""tpudist_torch.runtime.wire against the JAX package's
``tpudist.runtime.wire``: the same document frames to the same bytes in
both packages, each decodes the other's frames, and every single flipped
bit past the magic raises ``WireError`` in both.  The router's request and
completion frames are byte-identical too."""

import importlib

import numpy as np
import pytest

from tpudist_torch.runtime import wire as twire

KINDS = ["request", "completion", "journal", "heartbeat", "prefix",
         "kv_migration", "pullreq", "pulldone"]


@pytest.fixture(scope="module")
def ref():
    return importlib.import_module("tpudist.runtime.wire")


def _doc(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"key": f"{int(rng.integers(0, 1 << 30)):08d}",
            "prompt": rng.integers(0, 32000, int(rng.integers(1, 40)))
            .tolist(),
            "max_new_tokens": int(rng.integers(1, 64)),
            "deadline_s": (None if rng.random() < 0.5
                           else float(rng.uniform(0, 1e9))),
            "nested": {"a": [1.5, None, "xé"], "b": True}}


def test_tables_and_crc(ref):
    assert twire.WIRE_KINDS == ref.WIRE_KINDS
    assert twire.WIRE_MAGIC == ref.WIRE_MAGIC
    assert twire.crc32c(b"123456789") == 0xE3069283 == \
        ref.crc32c(b"123456789")
    data = np.random.default_rng(0).bytes(4096)
    assert twire.crc32c(data) == ref.crc32c(data)
    assert twire.crc32c(data[100:], twire.crc32c(data[:100])) == \
        ref.crc32c(data)


@pytest.mark.parametrize("n", [65535, 65536, 65537, 4096 * 50 + 17,
                               300_001])
def test_parallel_crc_equals_the_byte_loop(ref, n):
    """Payloads past 64 KiB take the column-parallel path: the same CRC
    as tpudist's byte loop, incremental seeds included."""
    data = np.random.default_rng(n).bytes(n)
    assert twire.crc32c(data) == ref.crc32c(data)
    assert twire.crc32c(data, 0xDEADBEEF) == ref.crc32c(data, 0xDEADBEEF)
    frame = twire.encode_record("kv_migration", {"b64": data.hex()})
    assert frame == ref.encode_record("kv_migration", {"b64": data.hex()})


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_frames_byte_identical_and_cross_decode(ref, kind, seed):
    doc = _doc(seed)
    mine, theirs = twire.encode_record(kind, doc), ref.encode_record(kind,
                                                                     doc)
    assert mine == theirs
    assert ref.decode_record(mine, expect=kind) == doc
    assert twire.decode_record(theirs, expect=kind) == doc


def test_every_flipped_bit_raises_in_both(ref):
    frame = twire.encode_record("completion", {"key": "q1",
                                               "tokens": [1, 2, 3]})
    n = 0
    for byte in range(4, len(frame)):
        for bit in range(8):
            bad = bytearray(frame)
            bad[byte] ^= 1 << bit
            bad = bytes(bad)
            with pytest.raises(twire.WireError) as mine:
                twire.decode_record(bad, expect="completion",
                                    namespace="ns", key="k", replica="r1")
            with pytest.raises(ref.WireError) as theirs:
                ref.decode_record(bad, expect="completion")
            assert mine.value.reason == theirs.value.reason == "checksum"
            assert (mine.value.namespace, mine.value.key,
                    mine.value.replica) == ("ns", "k", "r1")
            n += 1
    assert n == 8 * (len(frame) - 4)


@pytest.mark.parametrize("payload,reason", [
    (b"TPW1\x00", "truncated"), (b"not json", "json"), (b"[1, 2]", "json")])
def test_malformed_payloads_same_reason(ref, payload, reason):
    with pytest.raises(twire.WireError) as mine:
        twire.decode_record(payload)
    with pytest.raises(ref.WireError) as theirs:
        ref.decode_record(payload)
    assert mine.value.reason == theirs.value.reason == reason


def test_kind_mismatch_legacy_json_and_unknown_kind(ref):
    frame = twire.encode_record("journal", {"a": 1})
    with pytest.raises(twire.WireError) as e:
        twire.decode_record(frame, expect="request")
    assert e.value.reason == "kind" and e.value.kind == "journal"
    assert twire.decode_record(b'{"legacy": 1}', expect="request") == \
        ref.decode_record(b'{"legacy": 1}', expect="request")
    with pytest.raises(ValueError):
        twire.encode_record("nope", {})


def test_router_frames_byte_identical(ref):
    """The router's request (trace, prefix hash, refs) and completion
    frames from the port equal tpudist's."""
    jr = importlib.import_module("tpudist.runtime.router")
    jserv = importlib.import_module("tpudist.models.serving")
    jev = importlib.import_module("tpudist.obs.events")
    from tpudist_torch.models.serving import Completion, Request
    from tpudist_torch.obs.events import TraceContext
    from tpudist_torch.runtime import router as tr

    prompt = np.arange(3, 11, dtype=np.int32)
    wire_trace = {"id": "00000001-abc", "parent": None, "enq": 12.5}
    mine = Request(prompt, 9, rid="k1", deadline_s=3.0, priority=2,
                   trace=TraceContext.from_wire(wire_trace),
                   prefix_hash=77)
    theirs = jserv.Request(prompt, 9, rid="k1", deadline_s=3.0,
                           priority=2,
                           trace=jev.TraceContext.from_wire(wire_trace),
                           prefix_hash=77)
    for kw in ({}, {"handoff_ref": "fleet/kv/k1"},
               {"prefix_ref": "fleet/kv/pull-k1"}):
        a = tr._encode_request("00000001", mine, **kw)
        assert a == jr._encode_request("00000001", theirs, **kw)
        back = tr._decode_request(a, namespace="fleet", key="00000001")
        assert back.trace == mine.trace and back.prefix_hash == 77
        assert (back.prefix_ref, back.kv_handoff) == (
            kw.get("prefix_ref"),
            {"handoff_ref": kw["handoff_ref"]} if "handoff_ref" in kw
            else None)
    comp = Completion("00000001", prompt, np.asarray([5, 6], np.int32),
                      "length")
    jcomp = jserv.Completion("00000001", prompt,
                             np.asarray([5, 6], np.int32), "length")
    for kw in ({}, {"handoff_ref": "r", "adopt_fallback": True}):
        assert tr._encode_completion("r0", comp, **kw) == \
            jr._encode_completion("r0", jcomp, **kw)
    with pytest.raises(twire.WireError) as e:
        tr._decode_request(twire.encode_record("request", {"key": "x"}))
    assert e.value.reason == "schema"
