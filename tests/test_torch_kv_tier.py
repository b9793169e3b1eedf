"""tpudist_torch's host-RAM KV tier against the JAX package's.

``HostTier``: one seeded sequence of puts, takes, peeks, probes,
discards, evictions and flushes drives the port's tier (host tensors) and
tpudist's (numpy arrays) alike; after every operation both return the same
values, hold the same hashes in the same LRU order and the same bytes, and
pass tpudist's ``check()`` invariants (the port's ``check`` is the same
code).  The tiered ``ServeLoop`` runs tpudist's ``tests/test_kv_tier.py``
seam (three 3-block prefixes through a 7-block pool, then the first
again): the first tenant's blocks spill on eviction and re-admit from the
tier, and every completion equals tpudist's tiered loop's and the greedy
rollout's.  Pull-mode exports cross between the packages both ways, a
preempted lane parks its pages block by block in the tier and resumes
exactly as tpudist's, and a swap flushes the tier.

Tolerance: tokens exactly equal (f32); tier bytes bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_migration import (
    _preempt_script,
    _script_run,
    _sig,
)
from tpudist.models import kv_tier as jtier
from tpudist.models.generate import greedy_generate
from tpudist.models.serving import Request as JaxRequest
from tpudist.models.serving import ServeLoop as JaxServeLoop
from tpudist.models.transformer import TransformerConfig as JaxConfig
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist_torch.models import kv_tier as ttier
from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.kv_pages import chain_hashes
from tpudist_torch.models.serving import Request, ServeLoop
from tpudist_torch.models.transformer import TransformerConfig

KW = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
          embed_dim=64, max_seq_len=96)
JCFG, CFG = JaxConfig(**KW), TransformerConfig(**KW)
BS = 16
TIER_ENV = "TPUDIST_KV_HOST_TIER_BYTES"


@pytest.fixture(scope="module")
def weights():
    params = JaxLM(JCFG).init(jax.random.key(0),
                              jnp.zeros((1, 2), jnp.int32))["params"]
    return params, from_flax_params(jax.tree.map(np.asarray, params), CFG)


def _prompt(seed, n):
    return np.asarray(jax.random.randint(jax.random.key(seed), (n,), 0, 64))


def _want(weights, prompt, n):
    out = greedy_generate(JCFG, weights[0], jnp.asarray(prompt)[None, :], n)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def _loop(weights, tier_bytes, port=True, **kw):
    """A paged ServeLoop (prefix sharing on) with the tier budget set for
    its constructor only."""
    old = os.environ.get(TIER_ENV)
    os.environ[TIER_ENV] = str(int(tier_bytes))
    try:
        kw = dict(dict(num_slots=2, steps_per_sync=4, prefill_chunk=8,
                       cache_layout="paged", kv_block_size=BS), **kw)
        if port:
            return ServeLoop(CFG, weights[1], device="cpu", **kw)
        return JaxServeLoop(JCFG, weights[0], decode_attention="flash",
                            **kw)
    finally:
        if old is None:
            os.environ.pop(TIER_ENV, None)
        else:
            os.environ[TIER_ENV] = old


# ---- HostTier's state machine ------------------------------------------------

def _block(rng, n_layers=2):
    return [{"k": rng.standard_normal((4, 8)).astype(np.float32),
             "v": rng.standard_normal((4, 8)).astype(np.float32)}
            for _ in range(n_layers)]


def _apply(tier, op, arg, to):
    name = op[0]
    if name == "put":
        _, h, parent, version = op
        return tier.put(h, [{k: to(v) for k, v in l.items()} for l in arg],
                        parent=parent, version=version)
    if name in ("take", "peek"):
        fn = tier.take if name == "take" else tier.peek_layers
        got = fn(op[1], version=op[2])
        return None if got is None else [
            {k: np.asarray(v) for k, v in l.items()} for l in got]
    if name == "has":
        return tier.has(op[1], version=op[2])
    if name == "match":
        return tier.match_chain(op[1], version=op[2])
    if name == "discard":
        return tier.discard(op[1])
    if name == "evict":
        return tier.evict_one()
    return tier.flush()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_tier_replays_tpudist(seed):
    rng = np.random.default_rng(seed)
    budget = 6 * 2 * 2 * 4 * 8 * 4      # room for six 2-layer blocks
    jt, tt = jtier.HostTier(budget), ttier.HostTier(budget)
    hashes = list(range(1, 13))
    for step in range(300):
        kind = rng.choice(["put"] * 5 + ["take", "peek", "has", "match",
                                         "discard", "evict"]
                          + (["flush"] if step % 97 == 96 else []))
        h = int(rng.choice(hashes))
        version = int(rng.integers(0, 2))
        if kind == "put":
            parent = int(h - 1) if h > 1 and rng.random() < 0.7 else None
            op, arg = ("put", h, parent, version), _block(rng)
        elif kind == "match":
            op, arg = ("match", hashes[:int(rng.integers(1, 8))],
                       version), None
        else:
            op, arg = (kind, h, version if rng.random() < 0.8 else None), None
        want = _apply(jt, op, arg, np.asarray)
        got = _apply(tt, op, arg, torch.from_numpy)
        if isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for k in ("k", "v"):
                    np.testing.assert_array_equal(g[k], w[k])
        else:
            assert got == want, (step, op)
        assert tt.hashes() == jt.hashes(), (step, op)
        assert (len(tt), tt.nbytes) == (len(jt), jt.nbytes)
        resident = [int(x) for x in rng.choice(hashes, 2)
                    if int(x) not in jt.hashes()]
        jt.check(resident)
        tt.check(resident)
    with pytest.raises(AssertionError, match="simultaneously"):
        if len(tt):
            tt.check(tt.hashes()[:1])
        else:
            raise AssertionError("simultaneously")


def test_budget_from_env_matches_tpudist(monkeypatch):
    for raw in (None, "0", "12345", "lots", "-3"):
        if raw is None:
            monkeypatch.delenv(TIER_ENV, raising=False)
        else:
            monkeypatch.setenv(TIER_ENV, raw)
        assert ttier.tier_budget_from_env() == jtier.tier_budget_from_env()
    assert ttier.DEFAULT_TIER_BYTES == jtier.DEFAULT_TIER_BYTES


# ---- the tiered ServeLoop -----------------------------------------------------

def _seam(loop, cls, prompts):
    comps = []
    for i, p in enumerate(prompts):
        comps += loop.run([cls(p, 8, rid=f"t{i}")])
    comps += loop.run([cls(prompts[0], 8, rid="t0-again")])
    return comps


def test_spill_then_readmit_matches_tpudist(weights):
    """The first tenant's cached blocks spill when the third admission
    evicts them, and its return re-admits them from the tier: the
    completions equal tpudist's tiered loop's and the greedy rollout's,
    the re-admit saved its prefill, and pool and tier drain clean."""
    prompts = [_prompt(100 + i, 52) for i in range(3)]
    loop = _loop(weights, 8 << 20, kv_num_blocks=7)
    assert loop._tier is not None
    got = _seam(loop, Request, prompts)
    want = _seam(_loop(weights, 8 << 20, port=False, kv_num_blocks=7),
                 JaxRequest, prompts)
    assert _sig(got) == _sig(want)
    for c in got:
        assert [int(t) for t in c.tokens] == _want(weights, c.prompt, 8)
    tier = loop._tier
    assert tier.spills >= 3 and tier.readmits >= 1
    assert tier.spilled_bytes > 0 and tier.readmitted_bytes > 0
    assert loop.tier_stats["readmit_blocks"] == tier.readmits
    assert loop.prefix_stats["hits"] >= 1
    loop.flush_prefix_cache()
    loop.pool.check()
    assert loop.pool.free_blocks == loop.pool.num_blocks
    assert loop.tier_drained() is True


def test_tier_off_gives_the_same_completions(weights):
    """With the tier disabled the evicted prefix is recomputed: the same
    completions, no tier."""
    prompts = [_prompt(100 + i, 52) for i in range(3)]
    off = _loop(weights, 0, kv_num_blocks=7)
    assert off._tier is None and off.tier_drained() is None
    on = _loop(weights, 8 << 20, kv_num_blocks=7)
    assert _sig(_seam(off, Request, prompts)) == _sig(
        _seam(on, Request, prompts))
    assert on.prefix_stats["prefill_tokens"] < off.prefix_stats[
        "prefill_tokens"]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_pull_export_crosses_packages(weights, direction):
    """An owner whose first tenant spilled exports its chain (pool pages,
    then the tier's entries peeked in place); the other package installs
    it and serves the prompt from the installed blocks, exactly."""
    prompts = [_prompt(200 + i, 52) for i in range(3)]
    src_port = direction == "port_to_jax"
    owner = _loop(weights, 8 << 20, port=src_port, kv_num_blocks=7)
    for i, p in enumerate(prompts):
        owner.run([(Request if src_port else JaxRequest)(p, 8, rid=i)])
    assert len(owner._tier) >= 1
    payload = owner.export_prefix(chain_hashes(prompts[0], BS))
    assert payload is not None and len(payload["chain"]) >= 1
    peer = _loop(weights, 8 << 20, port=not src_port, kv_num_blocks=12)
    assert peer.install_prefix(prompts[0], payload) == len(payload["chain"])
    cls = JaxRequest if src_port else Request
    [c] = peer.run([cls(prompts[0], 8, rid="q")])
    assert [int(t) for t in c.tokens] == _want(weights, prompts[0], 8)
    assert peer.prefix_stats["hits"] == 1
    res = owner.prefix_residency()
    assert set(res["tiered"]) <= set(res["chains"])


def test_install_gates_reject_bad_payloads(weights):
    prompt = _prompt(7, 52)
    owner = _loop(weights, 8 << 20, kv_num_blocks=12)
    owner.run([Request(prompt, 8, rid="seed")])
    payload = owner.export_prefix(chain_hashes(prompt, BS))
    assert len(payload["chain"]) == 3
    peer = _loop(weights, 8 << 20, kv_num_blocks=12)
    for bad in (dict(payload, version=99), dict(payload, block_size=8),
                dict(payload, chain=[h + 1 for h in payload["chain"]])):
        assert peer.install_prefix(prompt, bad) == 0
    assert peer.install_prefix(_prompt(9, 52), payload) == 0
    peer.pool.check()
    assert peer.pool.free_blocks == peer.pool.num_blocks


@pytest.mark.parametrize("depth", [1, 2])
def test_park_spills_per_block_and_resumes_exactly(weights, depth):
    """Priority preemption with the tier on: the parked lane's pages go
    into the tier block by block (no payload kept whole), resume through
    adoption, and every completion equals tpudist's tiered loop's."""
    kw = dict(num_slots=2, steps_per_sync=4, cache_layout="paged",
              kv_block_size=16, preempt="migrate")
    loop = _loop(weights, 8 << 20, pipeline_depth=depth, **kw)
    parked = []
    orig = loop._tier.put

    def spy(h, layers, **k):
        parked.append(h)
        return orig(h, layers, **k)

    loop._tier.put = spy
    got = _sig(_script_run(loop, Request, _preempt_script(Request)))
    assert sorted(r for r, _, _ in got) == ["be0", "be1", "vip"]
    st = loop.stats
    assert st.preempted >= 1 and st.resumed == st.preempted
    assert st.adoptions == st.resumed and st.handoff_fallbacks == 0
    assert len(parked) >= 1 and not loop._parked
    jloop = _loop(weights, 8 << 20, port=False, pipeline_depth=1, **kw)
    want = _sig(_script_run(jloop, JaxRequest, _preempt_script(JaxRequest)))
    assert sorted(got) == sorted(want)
    if depth == 1:
        assert got == want
    loop.flush_prefix_cache()
    assert loop.tier_drained() is True


def test_swap_flushes_the_tier(weights):
    """A weight swap flushes the tier with the prefix cache: a request
    after it re-prefills under the new weights."""
    prompts = [_prompt(300 + i, 52) for i in range(3)]
    loop = _loop(weights, 8 << 20, kv_num_blocks=7)
    for i, p in enumerate(prompts):
        loop.run([Request(p, 8, rid=i)])
    assert len(loop._tier) >= 1
    loop.request_swap(lambda: weights[1], version=3)
    loop.run([Request(prompts[1], 2, rid="after")])
    assert loop.weights_version == 3
    assert all(not loop._tier.has(h, version=0)
               for h in chain_hashes(prompts[0], BS))
