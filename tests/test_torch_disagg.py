"""tpudist_torch.runtime.disagg (KV-migration payloads and transports)
against the JAX package's ``tpudist.runtime.disagg``.

f32 payload frames are byte-identical in both packages.  bf16 pages, which
the port keeps as CPU tensors (numpy has no bf16 without ``ml_dtypes``),
travel as ``"bfloat16"`` raw 2-byte words: a tpudist bf16 payload decodes
in the port to the same bits, and the port's bf16 frame equals tpudist's.
A handoff exported by tpudist's prefill loop and fetched over the coord
transport is adopted by the port's decode loop, token-identical to
tpudist's unified loop."""

import importlib
import json

import numpy as np
import pytest
import torch

from tpudist_torch import obs as tobs
from tpudist_torch.runtime import disagg as td
from tpudist_torch.runtime import faults as tfaults
from tpudist_torch.runtime import wire as twire


@pytest.fixture(scope="module")
def ref():
    return (importlib.import_module("tpudist.runtime.disagg"),
            importlib.import_module("tpudist.runtime.wire"))


@pytest.fixture(autouse=True)
def _clean_plan():
    tfaults.reset()
    yield
    tfaults.reset()


class Store:
    def __init__(self):
        self.kv: dict[str, bytes] = {}

    def set(self, k, v):
        self.kv[k] = v

    def get(self, k):
        return self.kv.get(k)

    def delete(self, k):
        self.kv.pop(k, None)

    def keys(self, prefix=""):
        return [k for k in self.kv if k.startswith(prefix)]


def _payload(seed: int, dtype=np.float32, generated=False) -> dict:
    rng = np.random.default_rng(seed)
    n_blk, bs, f = int(rng.integers(1, 4)), 8, 4
    p = {"key": f"k{seed}", "rid": "caller",
         "prompt": rng.integers(0, 64, 5).tolist(), "max_new_tokens": 7,
         "first": int(rng.integers(0, 64)), "true_len": 5,
         "block_size": bs, "chain": rng.integers(0, 1 << 62, 2).tolist(),
         "published_at": 12.5, "version": 0,
         "layers": [{"k": rng.standard_normal((n_blk, bs, f)).astype(dtype),
                     "v": rng.standard_normal((n_blk, bs, f)).astype(dtype)}
                    for _ in range(2)]}
    if generated:
        p["generated"] = [1, 2, 3]
    return p


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("generated", [False, True])
def test_f32_frames_byte_identical(ref, seed, generated):
    jd, jw = ref
    p = _payload(seed, generated=generated)
    mine = twire.encode_record("kv_migration", td.encode_payload(p))
    theirs = jw.encode_record("kv_migration", jd.encode_payload(p))
    assert mine == theirs
    back = td.decode_payload(twire.decode_record(theirs,
                                                 expect="kv_migration"))
    for a, b in zip(back["layers"], p["layers"]):
        assert a["k"].dtype == np.float32
        np.testing.assert_array_equal(a["k"], b["k"])
        np.testing.assert_array_equal(a["v"], b["v"])
    assert td.payload_nbytes(p) == jd.payload_nbytes(p)


def test_coord_transport_publish_bytes_identical(ref):
    jd, _ = ref
    s1, s2 = Store(), Store()
    p = _payload(5)
    r1 = jd.CoordKVTransport(s1, namespace="ns").publish("k5", p)
    r2 = td.CoordKVTransport(s2, namespace="ns").publish("k5", p)
    assert r1 == r2 and s1.kv == s2.kv
    got = td.CoordKVTransport(s2, namespace="ns").fetch(r2[0])
    assert got["chain"] == p["chain"]
    c0 = tobs.snapshot()["counters"]["integrity/checksum_mismatch"][
        "value"] if "integrity/checksum_mismatch" in \
        tobs.snapshot()["counters"] else 0.0
    raw = s2.kv[r2[0]]
    s2.kv[r2[0]] = raw[:-2] + bytes([raw[-2] ^ 4]) + raw[-1:]
    assert td.CoordKVTransport(s2, namespace="ns").fetch(r2[0]) is None
    assert r2[0] not in s2.kv     # a corrupt payload is swept
    c1 = tobs.snapshot()["counters"]["integrity/checksum_mismatch"]["value"]
    assert c1 - c0 == 1


def test_tpudist_bf16_payload_decodes_to_the_same_bits(ref):
    """tpudist tags an ml_dtypes bf16 array "bfloat16"; the port reads it
    into a bf16 CPU tensor with the same 2-byte words, and a port payload
    of bf16 tensors frames to tpudist's exact bytes."""
    import ml_dtypes

    jd, jw = ref
    p = _payload(7)
    jp = dict(p, layers=[{k: v.astype(ml_dtypes.bfloat16)
                          for k, v in l.items()} for l in p["layers"]])
    theirs = jw.encode_record("kv_migration", jd.encode_payload(jp))
    back = td.decode_payload(twire.decode_record(theirs))
    for a, b in zip(back["layers"], jp["layers"]):
        for key in ("k", "v"):
            assert isinstance(a[key], torch.Tensor)
            assert a[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(a[key].view(torch.int16).numpy(),
                                          b[key].view(np.int16))
    tp = dict(p, layers=[{k: torch.from_numpy(v).to(torch.bfloat16)
                          for k, v in l.items()} for l in p["layers"]])
    mine = twire.encode_record("kv_migration", td.encode_payload(tp))
    assert mine == theirs
    assert td.payload_nbytes(tp) == jd.payload_nbytes(jp)
    # and tpudist reads the port's frame back to its bf16 bits
    jback = jd.decode_payload(jw.decode_record(mine))
    np.testing.assert_array_equal(
        jback["layers"][0]["k"].view(np.int16),
        jp["layers"][0]["k"].view(np.int16))


def test_ici_transport_moves_pages_to_the_device():
    t = td.IciKVTransport(device=torch.device("cpu"))
    p = _payload(1)
    ref_, n = t.publish("k1", p)
    assert ref_ == "ici://k1" and n == td.payload_nbytes(p)
    got = t.fetch(ref_)
    assert isinstance(got["layers"][0]["k"], torch.Tensor)
    np.testing.assert_array_equal(got["layers"][0]["k"].numpy(),
                                  p["layers"][0]["k"])
    t.delete(ref_)
    assert t.fetch(ref_) is None
    t.delete(ref_)   # idempotent


def test_drop_knob_and_make_transport():
    tfaults.install(tfaults.FaultPlan(handoff_drop=1))
    s = Store()
    ref_, _ = td.CoordKVTransport(s, namespace="ns").publish("k", _payload(0))
    assert s.kv == {} and ref_ == "ns/kv/k"
    with pytest.raises(ValueError, match="needs a CoordClient"):
        td.make_transport("coord")
    with pytest.raises(ValueError, match="unknown KV transport"):
        td.make_transport("dcn")
    assert isinstance(td.make_transport("ici"), td.IciKVTransport)
    assert isinstance(td.make_transport("coord", client=s),
                      td.CoordKVTransport)


def test_broken_documents_raise():
    doc = json.loads(json.dumps(td.encode_payload(_payload(2))))
    for broken in ({k: v for k, v in doc.items() if k != "layers"},
                   dict(doc, layers=[{"k": {"b64": "!!", "dtype": "float32",
                                            "shape": [1]}}])):
        with pytest.raises((KeyError, ValueError)):
            td.decode_payload(broken)


def test_tpudist_handoff_adopted_by_the_port_decode_loop(ref):
    """tpudist's prefill loop exports; the payload crosses tpudist's coord
    transport; the port's transport fetches it and the port's decode loop
    adopts it (no prefill) — tokens equal tpudist's unified loop."""
    import jax
    import jax.numpy as jnp

    from tpudist.models.serving import Request as JReq
    from tpudist.models.serving import ServeLoop as JLoop
    from tpudist.models.transformer import TransformerConfig as JCfg
    from tpudist.models.transformer import TransformerLM as JLM
    from tpudist_torch.models.convert import from_flax_params
    from tpudist_torch.models.serving import Request, ServeLoop
    from tpudist_torch.models.transformer import TransformerConfig

    jd, _ = ref
    kw = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
              embed_dim=64, max_seq_len=96)
    params = JLM(JCfg(**kw)).init(jax.random.key(0),
                                  jnp.zeros((1, 2), jnp.int32))["params"]
    loop_kw = dict(num_slots=2, steps_per_sync=4, prefill_chunk=8,
                   cache_layout="paged", kv_block_size=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, size=5 + 7 * i).astype(np.int32)
               for i in range(3)]
    unified = {c.rid: c.tokens.tolist() for c in JLoop(
        JCfg(**kw), params, pipeline_depth=1, **loop_kw).run(
            [JReq(p, 12, rid=i) for i, p in enumerate(prompts)])}
    handoffs = JLoop(JCfg(**kw), params, role="prefill", pipeline_depth=1,
                     **loop_kw).run(
        [JReq(p, 12, rid=i) for i, p in enumerate(prompts)])
    store = Store()
    jt = jd.CoordKVTransport(store, namespace="h")
    tt = td.CoordKVTransport(store, namespace="h")
    reqs = []
    for c in handoffs:
        assert c.reason == "handoff"
        ref_, _ = jt.publish(str(c.rid), dict(c.handoff, key=str(c.rid)))
        reqs.append(Request(c.prompt, 12, rid=c.rid,
                            kv_handoff=tt.fetch(ref_)))
    sd = from_flax_params(jax.tree.map(np.asarray, params),
                          TransformerConfig(**kw))
    loop = ServeLoop(TransformerConfig(**kw), sd, role="decode",
                     device="cpu", **loop_kw)
    got = {c.rid: c.tokens.tolist() for c in loop.run(reqs)}
    assert loop.stats.adoptions == 3 and loop.stats.handoff_fallbacks == 0
    assert got == unified
