"""tpudist_torch's KV handoff (prefill/decode roles) and live migration
(``preempt="migrate"``, evacuation) against tpudist's.

The models and workloads of tpudist's ``tests/test_disagg.py`` (the split
exactness cases) and ``tests/test_migration.py`` (preemption, evacuation,
the version gate), in process: every completion must be token-identical to
the unified loop and to tpudist's, on the adopt path and on every fallback,
payloads must cross between the two packages in both directions, and every
pool must end drained and ``check()``-clean.  tpudist runs its own tests'
``decode_attention="flash"`` (Pallas in interpret mode) with its host tier
off (``TPUDIST_KV_HOST_TIER_BYTES=0``, the port's too:
``tests/test_torch_kv_tier.py`` runs both with it), at depth 1 where its
schedule is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpudist import obs
from tpudist.models.serving import Request as JaxRequest
from tpudist.models.serving import ServeLoop as JaxServeLoop
from tpudist.models.transformer import TransformerConfig as JaxConfig
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.serving import Request, ServeLoop
from tpudist_torch.models.transformer import TransformerConfig

KW = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
          embed_dim=64, max_seq_len=96)
JCFG, CFG = JaxConfig(**KW), TransformerConfig(**KW)
# tests/test_disagg.py's split: block 8, chunk 8, prefix sharing off
SPLIT = dict(num_slots=2, steps_per_sync=4, prefill_chunk=8,
             cache_layout="paged", kv_block_size=8, chunked_prefill=True,
             prefix_sharing=False)
# tests/test_migration.py's loops
MIG = dict(num_slots=2, steps_per_sync=4, cache_layout="paged",
           kv_block_size=16)


@pytest.fixture(autouse=True)
def _no_host_tier(monkeypatch):
    monkeypatch.setenv("TPUDIST_KV_HOST_TIER_BYTES", "0")


@pytest.fixture(scope="module")
def weights():
    """tpudist's fleet model (``build_tiny_lm(seed=0)``'s init), flax and
    converted."""
    params = JaxLM(JCFG).init(jax.random.key(0),
                              jnp.zeros((1, 2), jnp.int32))["params"]
    return params, from_flax_params(jax.tree.map(np.asarray, params), CFG)


def _port(weights, **kw):
    return ServeLoop(CFG, weights[1], device="cpu", **kw)


def _jax(weights, **kw):
    return JaxServeLoop(JCFG, weights[0], decode_attention="flash", **kw)


def _counter(name):
    return obs.snapshot()["counters"].get(name, {}).get("value", 0)


def _split_reqs(cls, payloads=None):
    """Lengths straddle the block size: multi-block, sub-block and
    partial-tail prompts."""
    out = []
    for i, n in enumerate((40, 5, 23, 11)):
        prompt = np.asarray(jax.random.randint(jax.random.key(100 + i),
                                               (n,), 0, 64))
        out.append(cls(prompt, 9, rid=i, kv_handoff=(
            None if payloads is None else payloads.get(i))))
    return out


def _tokens(comps):
    return {c.rid: [int(t) for t in c.tokens] for c in comps}


def _drained(loop):
    loop.pool.check()
    return loop.pool.free_blocks == loop.pool.num_blocks


@pytest.fixture(scope="module")
def split(weights):
    """The unified loops' tokens and both packages' handoff payloads."""
    pre = _port(weights, role="prefill", **SPLIT)
    port_h = pre.run(_split_reqs(Request))
    assert all(c.reason == "handoff" and not c.tokens.size for c in port_h)
    assert _drained(pre)
    jpre = _jax(weights, role="prefill", **SPLIT)
    jax_h = jpre.run(_split_reqs(JaxRequest))
    return {"unified": _tokens(_port(weights, **SPLIT).run(
                _split_reqs(Request))),
            "jax_unified": _tokens(_jax(weights, **SPLIT).run(
                _split_reqs(JaxRequest))),
            "port": {c.rid: c.handoff for c in port_h},
            "jax": {c.rid: c.handoff for c in jax_h}}


def _bad(payload, case):
    p = dict(payload)
    if case == "chain":
        p["chain"] = [1, 2, 3]
    elif case == "shape":
        p["layers"] = [{"k": l["k"][:, :4], "v": l["v"][:, :4]}
                       for l in p["layers"]]
    elif case == "version":
        p["version"] = 5
    elif case == "layers":
        p["layers"] = p["layers"][:1]
    elif case == "structure":
        del p["first"]
    return p


def test_prefill_payload_matches_jax(split):
    """The port's handoff payloads carry tpudist's keys, first tokens,
    lengths, chains and page bytes (within f32 rounding of the two
    prefills)."""
    for rid, want in split["jax"].items():
        got = split["port"][rid]
        assert set(got) == set(want)
        for key in ("rid", "prompt", "max_new_tokens", "first", "true_len",
                    "block_size", "chain"):
            assert got[key] == want[key], key
        assert len(got["layers"]) == len(want["layers"]) == 2
        for gl, wl in zip(got["layers"], want["layers"]):
            for name in ("k", "v"):
                np.testing.assert_allclose(gl[name], np.asarray(wl[name]),
                                           atol=1e-5, rtol=1e-5)
    assert split["unified"] == split["jax_unified"]


@pytest.mark.parametrize("depth", [1, 2])
def test_decode_role_adopts_exactly(weights, split, depth):
    dec = _port(weights, role="decode", pipeline_depth=depth, **SPLIT)
    out = _tokens(dec.run(_split_reqs(Request, split["port"])))
    assert out == split["unified"]
    assert (dec.stats.adoptions, dec.stats.handoff_fallbacks) == (4, 0)
    assert dec.stats.prefill_seconds == 0.0
    assert _drained(dec)


@pytest.mark.parametrize("case", ["none", "chain", "shape", "version",
                                  "layers", "structure"])
def test_decode_role_fallbacks_exact(weights, split, case):
    """No payload, a bad chain, a wrong page shape, a foreign version, a
    missing layer, a missing key: each re-prefills the prompt, exactly,
    as tpudist's decode loop does with the same payload."""
    if case == "none":
        payloads, fallbacks = None, 0
    else:
        payloads = {0: _bad(split["port"][0], case)}
        fallbacks = 1
    dec = _port(weights, role="decode", **SPLIT)
    got = _tokens(dec.run(_split_reqs(Request, payloads)))
    assert got == split["unified"]
    assert (dec.stats.adoptions, dec.stats.handoff_fallbacks) == (0,
                                                                  fallbacks)
    assert _drained(dec)
    if case in ("chain", "version"):
        a0, f0 = (_counter("serve/adoptions"),
                  _counter("serve/handoff_fallbacks"))
        jdec = _jax(weights, role="decode", **SPLIT)
        jpay = {0: _bad(split["jax"][0], case)}
        assert _tokens(jdec.run(_split_reqs(JaxRequest, jpay))) == got
        assert _counter("serve/adoptions") - a0 == 0
        assert _counter("serve/handoff_fallbacks") - f0 == 1


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_handoff(weights, split, direction):
    """A tpudist prefill payload adopted by the port's decode role, and
    the reverse: token-identical to both unified loops, no fallback."""
    if direction == "jax_to_port":
        dec = _port(weights, role="decode", **SPLIT)
        out = _tokens(dec.run(_split_reqs(Request, split["jax"])))
        assert (dec.stats.adoptions, dec.stats.handoff_fallbacks) == (4, 0)
        assert _drained(dec)
    else:
        a0 = _counter("serve/adoptions")
        jdec = _jax(weights, role="decode", **SPLIT)
        out = _tokens(jdec.run(_split_reqs(JaxRequest, split["port"])))
        assert _counter("serve/adoptions") - a0 == 4
    assert out == split["unified"] == split["jax_unified"]


def _role_errors(make):
    out = []
    for kw in ({"role": "pre", **SPLIT},
               {"num_slots": 2, "cache_layout": "dense", "role": "prefill"},
               {"num_slots": 2, "cache_layout": "dense", "role": "decode"},
               {**SPLIT, "chunked_prefill": False, "role": "prefill"},
               {"num_slots": 2, "preempt": "migrate"},
               {"num_slots": 2, "preempt": "park"}):
        try:
            make(**kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_role_and_preempt_validation_matches_jax(weights):
    got = _role_errors(lambda **kw: _port(weights, **kw))
    assert got == _role_errors(lambda **kw: _jax(weights, **kw))
    assert all(m is not None for m in got)


# ---- preemption, evacuation, the version gate ------------------------------

def _arange(n):
    return np.arange(n, dtype=np.int32)


def _solo(weights, prompt, max_new):
    [c] = _port(weights, **MIG).run([Request(np.asarray(prompt, np.int32),
                                             max_new, rid="solo")])
    return [int(t) for t in c.tokens]


def _script_run(loop, cls, script):
    it = iter(script)
    return loop.run(source=lambda: next(it, None), sink=lambda c: None,
                    idle_wait_s=0.0)


def _preempt_script(cls):
    return ([[cls(rid=f"be{i}", prompt=_arange(8), max_new_tokens=48,
                  priority=0) for i in range(2)], [], [],
             [cls(rid="vip", prompt=_arange(6), max_new_tokens=8,
                  priority=5)]] + [[]] * 200 + [None])


def _sig(comps):
    return [(str(c.rid), tuple(int(t) for t in c.tokens), c.reason)
            for c in comps]


@pytest.mark.parametrize("depth", [1, 2])
def test_priority_preemption_exact(weights, depth):
    """Both lanes pinned by best-effort budgets; a priority request parks
    one (export, host park), runs, and the parked lane resumes: every
    completion equals its uninterrupted solo run, the pool drains, and at
    depth 1 the completions, their order and the preempted/resumed counts
    equal tpudist's."""
    loop = _port(weights, preempt="migrate", pipeline_depth=depth, **MIG)
    comps = _script_run(loop, Request, _preempt_script(Request))
    got = _sig(comps)
    assert sorted(r for r, _, _ in got) == ["be0", "be1", "vip"]
    for rid, toks, reason in got:
        assert reason == "length"
        assert list(toks) == _solo(weights, _arange(6 if rid == "vip"
                                                    else 8),
                                   8 if rid == "vip" else 48), rid
    st = loop.stats
    assert st.preempted >= 1 and st.resumed == st.preempted
    assert st.adoptions == st.resumed and st.handoff_fallbacks == 0
    assert _drained(loop) and not loop._parked
    if depth == 1:
        p0, r0 = _counter("serve/preempted"), _counter("serve/resumed")
        jloop = _jax(weights, preempt="migrate", pipeline_depth=1, **MIG)
        want = _sig(_script_run(jloop, JaxRequest,
                                _preempt_script(JaxRequest)))
        assert got == want
        assert (st.preempted, st.resumed) == (
            _counter("serve/preempted") - p0, _counter("serve/resumed") - r0)


def test_degrade_mode_never_preempts(weights):
    def script(cls):
        return ([[cls(rid="be0", prompt=_arange(8), max_new_tokens=24,
                      priority=0)],
                 [cls(rid="vip", prompt=_arange(6), max_new_tokens=8,
                      priority=5)]] + [[]] * 200 + [None])

    loop = _port(weights, pipeline_depth=1, **MIG)
    got = _sig(_script_run(loop, Request, script(Request)))
    p0 = _counter("serve/preempted")
    want = _sig(_script_run(_jax(weights, pipeline_depth=1, **MIG),
                            JaxRequest, script(JaxRequest)))
    assert got == want and len(got) == 2
    assert loop.stats.preempted == 0 == _counter("serve/preempted") - p0
    assert _drained(loop)


def _evacuate(loop, cls, at=4):
    state = {"n": 0}

    def source():
        state["n"] += 1
        if state["n"] == 1:
            return [cls(rid="a", prompt=_arange(9), max_new_tokens=30),
                    cls(rid="b", prompt=_arange(7), max_new_tokens=30),
                    cls(rid="q", prompt=_arange(5), max_new_tokens=30)]
        if state["n"] == at:
            loop.request_evacuate()
        return None if state["n"] > at else []

    return loop.run(source=source, sink=lambda c: None, idle_wait_s=0.0)


@pytest.mark.parametrize("depth", [1, 2])
def test_evacuation_adopted_exactly_by_a_peer(weights, depth):
    """request_evacuate exports both lanes with payloads (generated tokens
    and version riding along) and the queued request without one; a
    second loop adopts them mid-decode and finishes exactly; at depth 1
    the exports equal tpudist's, and tpudist's exports are adopted by the
    port's peer exactly too."""
    loop1 = _port(weights, preempt="migrate", pipeline_depth=depth, **MIG)
    out1 = _evacuate(loop1, Request)
    mig = {str(c.rid): c for c in out1 if c.reason == "migrate"}
    assert sorted(mig) == ["a", "b", "q"] and len(out1) == 3
    assert {r for r, c in mig.items() if c.handoff is not None} == {"a", "b"}
    assert loop1.stats.migrated_out == 3 and _drained(loop1)
    sources = {"port": mig}
    if depth == 1:
        jloop = _jax(weights, preempt="migrate", pipeline_depth=1, **MIG)
        jmig = {str(c.rid): c for c in _evacuate(jloop, JaxRequest)
                if c.reason == "migrate"}
        assert sorted(jmig) == sorted(mig)
        for rid in ("a", "b"):
            want, got = jmig[rid].handoff, mig[rid].handoff
            for key in ("first", "generated", "true_len", "chain",
                        "version"):
                assert got[key] == want[key], (rid, key)
        sources["jax"] = jmig
    for name, ms in sources.items():
        loop2 = _port(weights, preempt="migrate", pipeline_depth=depth,
                      **MIG)
        out2 = _tokens(loop2.run([Request(
            rid=rid, prompt=np.asarray(c.prompt, np.int32),
            max_new_tokens=30, kv_handoff=c.handoff)
            for rid, c in ms.items()]))
        assert loop2.stats.adoptions == 2, name
        assert loop2.stats.handoff_fallbacks == 0, name
        for rid, c in ms.items():
            assert out2[rid] == _solo(weights, c.prompt, 30), (name, rid)
        assert _drained(loop2)


def test_evacuation_in_batch_mode_is_ignored(weights):
    """Without a source or sink no one could resume a migrated request:
    the intents are dropped and everything completes here."""
    loop = _port(weights, preempt="migrate", **MIG)
    loop.request_evacuate()
    loop.request_migrate(["a"])
    [c] = loop.run([Request(rid="a", prompt=_arange(5), max_new_tokens=6)])
    assert c.reason == "length" and loop.stats.migrated_out == 0


def test_version_gate_refuses_pages_across_a_weight_roll(weights):
    """A migration payload exported under version 0, offered to a loop
    that has swapped to version 1 (the same weights), is refused and
    re-prefilled, still exactly; a matching version is adopted."""
    loop1 = _port(weights, preempt="migrate", **MIG)
    c = next(x for x in _evacuate(loop1, Request, at=3)
             if x.handoff is not None)
    assert c.handoff["version"] == 0
    loop2 = _port(weights, preempt="migrate", **MIG)
    loop2.request_swap(lambda: weights[1], version=1)
    req = Request(rid=c.rid, prompt=np.asarray(c.prompt, np.int32),
                  max_new_tokens=30, kv_handoff=c.handoff)
    [c2] = loop2.run([req])
    assert loop2.weights_version == 1
    assert (loop2.stats.adoptions, loop2.stats.handoff_fallbacks) == (0, 1)
    assert [int(t) for t in c2.tokens] == _solo(weights, c.prompt, 30)
    loop3 = _port(weights, **MIG)
    [c3] = loop3.run([req])
    assert loop3.stats.adoptions == 1
    assert list(c3.tokens) == list(c2.tokens)
    assert _drained(loop2) and _drained(loop3)
