"""tpudist_torch's greedy_generate and ServeLoop against the JAX package's.

Token streams must be IDENTICAL: same weights (converted from the flax
init), same prompts, greedy selection.  The JAX side decodes with
``decode_attention="flash"`` (Pallas in interpret mode on the CPU), the
port's only cached-attention path, and runs its ServeLoop at
``pipeline_depth=1``, the depth the port implements.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models.generate import _filtered_logits as jax_filtered_logits
from tpudist.models.generate import greedy_generate as jax_greedy
from tpudist.models.serving import Request as JaxRequest
from tpudist.models.serving import ServeLoop as JaxServeLoop
from tpudist.models.transformer import TransformerConfig as JaxConfig
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.generate import _filtered_logits, greedy_generate
from tpudist_torch.models.serving import Request, ServeLoop
from tpudist_torch.models.transformer import TransformerConfig

KW = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
          embed_dim=64, max_seq_len=96)
JCFG, CFG = JaxConfig(**KW), TransformerConfig(**KW)
# tests/test_serving.py's mixed workload: 6 requests through 2 slots
LOOP = dict(num_slots=2, steps_per_sync=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def params():
    return JaxLM(JCFG).init(jax.random.key(0),
                            jnp.zeros((1, 2), jnp.int32))["params"]


@pytest.fixture(scope="module")
def state_dict(params):
    return from_flax_params(jax.tree.map(np.asarray, params), CFG)


def _prompt(seed, n):
    return np.asarray(jax.random.randint(jax.random.key(seed), (n,), 0, 64))


def _workload(cls, **kw):
    return [cls(_prompt(10 + i, 3 + 5 * i), 25, rid=i, **kw)
            for i in range(6)]


def _sig(comps):
    return [(c.rid, tuple(int(t) for t in c.tokens), c.reason)
            for c in comps]


@pytest.mark.parametrize("stop", [None, (2, 31)])
def test_greedy_generate_token_identical(params, state_dict, stop):
    prompt = np.stack([_prompt(1, 7), _prompt(2, 7)])
    want = jax_greedy(JCFG, params, jnp.asarray(prompt), 17,
                      decode_attention="flash", prefill_chunk=4,
                      stop_tokens=stop)
    got = greedy_generate(CFG, state_dict, prompt, 17,
                          prefill_chunk=4, stop_tokens=stop, device="cpu")
    if stop is None:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.6), (0.9, 8, 0.75),
    (1.0, 64, 1.0)])
def test_sampling_filters_match_jax(temperature, top_k, top_p):
    """Scale, then top-k, then top-p: the same tokens survive, with the
    same scaled logits (one f32 division each, so 1e-6 relative)."""
    logits = np.random.default_rng(7).standard_normal((3, 64)) * 3
    logits = logits.astype(np.float32)
    want = np.asarray(jax_filtered_logits(jnp.asarray(logits), temperature,
                                          top_k, top_p))
    got = _filtered_logits(torch.from_numpy(logits), temperature, top_k,
                           top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6)


def test_top_k_one_sampling_is_greedy(state_dict):
    """The sampling path of the segment (temperature > 0, a seeded
    torch.Generator): with top_k=1 every draw is the argmax, so the
    completions equal greedy serving's."""
    greedy = ServeLoop(CFG, state_dict, device="cpu", **LOOP)
    sampled = ServeLoop(CFG, state_dict, temperature=0.8, top_k=1,
                        generator=torch.Generator().manual_seed(3),
                        device="cpu", **LOOP)
    assert (_sig(sampled.run(_workload(Request)))
            == _sig(greedy.run(_workload(Request))))


@pytest.fixture(scope="module")
def jax_reference(params):
    """The JAX ServeLoop's completions (rid, tokens, reason, finish order)
    on the mixed workload, per stop set and attention path."""
    cache = {}

    def get(stop, chunked=True, window=None):
        key = (stop, chunked, window)
        if key not in cache:
            cfg = dataclasses.replace(JCFG, attention_window=window)
            loop = JaxServeLoop(cfg, params, decode_attention="flash",
                                stop_tokens=stop, chunked_prefill=chunked,
                                pipeline_depth=1, **LOOP)
            cache[key] = _sig(loop.run(_workload(JaxRequest)))
        return cache[key]

    return get


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "one_shot"])
@pytest.mark.parametrize("stop", [(7, 13), (59,)])
def test_serve_loop_token_identical(state_dict, jax_reference, stop,
                                    chunked):
    """Queueing, mid-flight admission into freed slots, stop tokens and
    budgets: the port's completions equal the JAX loop's, in the same
    finish order, with chunked and one-shot admission (which finish in
    different orders: a chunked prompt joins decode chunk by chunk)."""
    want = jax_reference(stop, chunked=chunked)
    loop = ServeLoop(CFG, state_dict, stop_tokens=stop,
                     chunked_prefill=chunked,
                     device="cpu", **LOOP)
    admitted = []
    admit = loop._admit
    loop._admit = lambda slot, req: (admitted.append(slot),
                                     admit(slot, req))[1]
    got = _sig(loop.run(_workload(Request)))
    assert got == want
    # 6 requests through 2 lanes: every lane was reused
    assert len(admitted) == 6 and min(admitted.count(0),
                                      admitted.count(1)) >= 2
    assert loop.stats.requests == 6
    if stop == (59,):   # the workload exercises both finish paths
        assert {r for _, _, r in got} == {"stop", "length"}


def test_serve_loop_window_token_identical(state_dict, jax_reference):
    """A sliding-window model: per-row cache writes and the plain banded
    mask (the per-row kernel has no window trim, so no side buffer) —
    same completions as the JAX loop, which serves it the same way."""
    cfg = dataclasses.replace(CFG, attention_window=6)
    with pytest.warns(UserWarning, match="sliding-window"):
        loop = ServeLoop(cfg, state_dict, stop_tokens=(59,), device="cpu",
                         **LOOP)
    assert loop.side == 0
    assert _sig(loop.run(_workload(Request))) == jax_reference((59,),
                                                               window=6)


def test_serve_loop_matches_own_greedy_rollouts(state_dict):
    """Every completion equals its request's own greedy_generate rollout
    (per-row + side-buffer decode vs scalar decode)."""
    comps = ServeLoop(CFG, state_dict, device="cpu", **LOOP).run(
        _workload(Request))
    for c in comps:
        want = greedy_generate(CFG, state_dict, c.prompt[None], 25,
                               prefill_chunk=8, device="cpu")
        np.testing.assert_array_equal(c.tokens,
                                      want.numpy()[0, len(c.prompt):])


@pytest.mark.parametrize("budget,prios,rejected,lengths", [
    (6, [0, 1, 0, 1, 0], [4, 2], {0: 6, 1: 6, 3: 6}),
    # rid 2 (best effort) is admitted while the loop is degraded: clamped
    # to degrade_max_new = 32; rid 0 came before, rid 3 has priority
    (40, [0, -1, 0, 1, -1], [4, 1], {0: 40, 2: 32, 3: 40}),
], ids=["shed", "shed_and_degrade"])
def test_max_queue_sheds_like_jax(params, state_dict, budget, prios,
                                  rejected, lengths):
    """A full queue sheds the lowest priority class first, newest first
    within it.  Past the soft watermark (``max_queue // 2``) the loop is
    degraded and clamps the budgets of best-effort admissions — as the
    JAX loop does."""
    def reqs(cls):
        return [cls(_prompt(30 + i, 4 + i), budget, rid=i, priority=p)
                for i, p in enumerate(prios)]

    want = _sig(JaxServeLoop(JCFG, params, num_slots=1, steps_per_sync=4,
                             prefill_chunk=8, max_queue=2,
                             pipeline_depth=1).run(reqs(JaxRequest)))
    loop = ServeLoop(CFG, state_dict, num_slots=1, steps_per_sync=4,
                     prefill_chunk=8, max_queue=2, device="cpu")
    got = _sig(loop.run(reqs(Request)))
    assert got == want
    assert [r for r, _, reason in got if reason == "rejected"] == rejected
    assert {r: len(t) for r, t, reason in got
            if reason == "length"} == lengths
    assert loop.stats.rejected == 2
    assert loop.stats.degrade_clamped == (budget > 32)
    assert not loop._degraded


def test_budget_one_completes_at_prefill(state_dict):
    [c] = ServeLoop(CFG, state_dict, device="cpu", **LOOP).run(
        [Request(_prompt(9, 4), 1, rid=0)])
    assert c.reason == "length" and c.tokens.shape == (1,)


def test_validation_and_unported_options(state_dict):
    loop = ServeLoop(CFG, state_dict, num_slots=1, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        loop.run([Request(_prompt(1, 90), 20)])
    with pytest.raises(ValueError, match="non-empty"):
        loop.run([Request(np.zeros((0,), np.int32), 5)])
    with pytest.raises(ValueError, match="num_slots"):
        ServeLoop(CFG, state_dict, num_slots=0, device="cpu")
    # speculative decoding, the roles and preemption by migration are
    # ported: each builds where tpudist's does and refuses where it does
    paged = {"cache_layout": "paged", "kv_block_size": 16}
    for kw in ({"decode_mode": "speculative", "draft_cfg": CFG,
                "draft_params": state_dict, "num_draft": 2},
               {"role": "prefill", **paged}, {"role": "decode", **paged},
               {"preempt": "migrate", **paged}):
        ServeLoop(CFG, state_dict, num_slots=1, device="cpu", **kw)
    for kw, match in (({"decode_mode": "speculative"}, "draft_cfg"),
                      ({"role": "prefill"}, "role='prefill' needs"),
                      ({"role": "decode"}, "role='decode' needs"),
                      ({"preempt": "migrate"}, "preempt='migrate' needs")):
        with pytest.raises(ValueError, match=match):
            ServeLoop(CFG, state_dict, num_slots=1, device="cpu", **kw)
    for kw, match in (({"degrade_max_new": 0}, "degrade_max_new"),
                      ({"degrade_queue": -1}, "degrade_queue"),
                      ({"preempt": "bogus"}, "preempt"),
                      ({"pipeline_depth": 0}, "pipeline_depth")):
        with pytest.raises(ValueError, match=match):
            ServeLoop(CFG, state_dict, num_slots=1, device="cpu", **kw)


# ---- the paged layout ------------------------------------------------------

def _pool_trace(loop):
    """Record the pool's page table and free list after every admission
    and every finalize (both loops admit and free at the same points)."""
    trace = []
    admit, free = loop._admit, loop.pool.free_slot

    def snap(tag, slot):
        trace.append((tag, slot, loop.pool.table.tolist(),
                      list(loop.pool._free), list(loop.pool._refcount)))

    def admit_and_snap(slot, req):
        st = admit(slot, req)
        snap("admit", slot)
        return st

    def free_and_snap(slot):
        free(slot)
        snap("free", slot)

    loop._admit, loop.pool.free_slot = admit_and_snap, free_and_snap
    return trace


def _paged_pair(params, state_dict, monkeypatch, reqs, **kw):
    """The JAX paged ServeLoop (flash decode, depth 1, no host tier) and
    the port's on the same requests: completions, pool traces, loops."""
    monkeypatch.setenv("TPUDIST_KV_HOST_TIER_BYTES", "0")
    jloop = JaxServeLoop(JCFG, params, decode_attention="flash",
                         pipeline_depth=1, cache_layout="paged", **kw)
    tloop = ServeLoop(CFG, state_dict, cache_layout="paged", device="cpu",
                      **kw)
    jtrace, ttrace = _pool_trace(jloop), _pool_trace(tloop)
    want = _sig(jloop.run([JaxRequest(r.prompt, r.max_new_tokens, rid=r.rid)
                           for r in reqs]))
    got = _sig(tloop.run(reqs))
    return want, got, jtrace, ttrace, jloop, tloop


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "one_shot"])
def test_paged_token_identical_to_jax(params, state_dict, monkeypatch,
                                      chunked):
    """tests/test_serving.py's paged-vs-dense workload: the port's paged
    loop gives the JAX paged loop's completions, in the same finish
    order, with the same page tables and free lists at every admission
    and finalize; both pools drain."""
    reqs = [Request(_prompt(70 + i, 3 + 5 * i), 20, rid=i) for i in range(5)]
    want, got, jtrace, ttrace, jloop, tloop = _paged_pair(
        params, state_dict, monkeypatch, reqs, num_slots=2, steps_per_sync=4,
        prefill_chunk=8, stop_tokens=(7, 13), kv_block_size=16,
        chunked_prefill=chunked)
    assert got == want
    assert ttrace == jtrace and len(ttrace) == 10
    dense = _sig(ServeLoop(CFG, state_dict, num_slots=2, steps_per_sync=4,
                           prefill_chunk=8, stop_tokens=(7, 13),
                           chunked_prefill=chunked, device="cpu").run(reqs))
    assert got == dense
    tloop.pool.check()
    assert tloop.pool.free_blocks == tloop.pool.num_blocks


def test_paged_small_pool_queues_like_jax(params, state_dict, monkeypatch):
    """A 2-block pool holds two one-block reservations at a time: the
    capacity gate queues the rest FIFO, and the completions, tables and
    free lists follow the JAX loop's."""
    reqs = [Request(_prompt(80 + i, 6), 10, rid=i) for i in range(4)]
    want, got, jtrace, ttrace, _, tloop = _paged_pair(
        params, state_dict, monkeypatch, reqs, num_slots=2, steps_per_sync=4,
        prefill_chunk=8, kv_block_size=16, kv_num_blocks=2)
    assert got == want and ttrace == jtrace
    # the third request waits for a finalize
    assert [t[0] for t in ttrace[:3]] == ["admit", "admit", "free"]
    tloop.pool.check()
    assert tloop.pool.free_blocks == 2


def _shared_prefix_requests(cls):
    """tests/test_prefix_sharing.py's trace: 3 shared blocks of 8, an
    exact repeat, and a block-aligned prompt twice (the second a full
    hit: copy-on-write split)."""
    base = _prompt(7, 24)
    reqs = [cls(np.concatenate([base, _prompt(100 + i, 5 + i)]), 10, rid=i)
            for i in range(5)]
    reqs.append(cls(np.concatenate([base, _prompt(100, 5)]), 10, rid=5))
    reqs.append(cls(base.copy(), 8, rid=6))
    reqs.append(cls(base.copy(), 8, rid=7))
    return reqs


def _count(log, split, pool, slot, i):
    """A JAX cow_write that logs whether it split (its block changed)."""
    before = pool._slot_blocks[slot][i]
    out = split(slot, i)
    log.append(out != before)
    return out


@pytest.mark.parametrize("sharing", [True, False], ids=["sharing", "off"])
def test_prefix_sharing_token_identical_to_jax(params, state_dict,
                                               monkeypatch, sharing):
    """Aliased prefix blocks, a gathered prefill cache, the suffix-only
    worklist and a copy-on-write split: the same completions as the JAX
    loop, the same prefix_stats, the same number of copy-on-write
    splits, the same tables and free lists; and the same tokens as
    prefix sharing off and the dense loop."""
    reqs = _shared_prefix_requests(Request)
    kw = dict(num_slots=3, steps_per_sync=4, prefill_chunk=8,
              kv_block_size=8, prefix_sharing=sharing)
    monkeypatch.setenv("TPUDIST_KV_HOST_TIER_BYTES", "0")
    jloop = JaxServeLoop(JCFG, params, decode_attention="flash",
                         pipeline_depth=1, cache_layout="paged", **kw)
    jcow = []
    jsplit = jloop.pool.cow_write
    jloop.pool.cow_write = lambda slot, i: _count(jcow, jsplit, jloop.pool,
                                                  slot, i)
    tloop = ServeLoop(CFG, state_dict, cache_layout="paged", device="cpu",
                      **kw)
    jtrace, ttrace = _pool_trace(jloop), _pool_trace(tloop)
    want = _sig(jloop.run(_shared_prefix_requests(JaxRequest)))
    got = _sig(tloop.run(reqs))
    assert got == want and ttrace == jtrace
    assert tloop.prefix_stats == jloop.prefix_stats
    assert tloop.pool.cow_splits == sum(jcow)
    dense = _sig(ServeLoop(CFG, state_dict, num_slots=3, steps_per_sync=4,
                           prefill_chunk=8, device="cpu").run(reqs))
    assert got == dense
    if sharing:
        assert tloop.prefix_stats["hits"] >= 4 and tloop.pool.cow_splits >= 1
        assert (tloop.prefix_stats["prefill_tokens"]
                < tloop.prefix_stats["prompt_tokens"])
    else:
        assert tloop.prefix_stats["hits"] == 0 == tloop.pool.cow_splits
    tloop.pool.check()
    tloop.flush_prefix_cache()
    assert tloop.pool.free_blocks == tloop.pool.num_blocks


def test_prefix_summary_and_flush(state_dict):
    from tpudist_torch.models.kv_pages import request_prefix_hash

    base = _prompt(3, 16)
    h = request_prefix_hash(base)
    loop = ServeLoop(CFG, state_dict, num_slots=2, steps_per_sync=4,
                     prefill_chunk=8, cache_layout="paged", kv_block_size=8,
                     device="cpu")
    loop.run([Request(np.concatenate([base, _prompt(4 + i, 3)]), 4, rid=i,
                      prefix_hash=h) for i in range(3)])
    assert loop.prefix_summary() == [h]
    assert loop.pool.used_blocks == 0 and len(loop._prefix_cache) == 2
    assert loop.pool.free_blocks == loop.pool.num_blocks   # idle = free
    loop.flush_prefix_cache()
    assert loop.prefix_summary() == [] and len(loop._prefix_cache) == 0
    off = ServeLoop(CFG, state_dict, num_slots=1, cache_layout="paged",
                    kv_block_size=8, chunked_prefill=False, device="cpu")
    assert off._prefix_cache is None and off.prefix_summary() == []


@pytest.mark.parametrize("case", ["layout", "block_size", "window",
                                  "pool_capacity"])
def test_paged_validation_like_jax(params, state_dict, case):
    """tests/test_serving.py's paged validation errors, raised alike."""
    def build(cls, cfg, p, **kw):
        extra = {} if cls is JaxServeLoop else {"device": "cpu"}
        return cls(cfg, p, num_slots=1, **kw, **extra)

    errors = []
    for cls, cfg, p, req in ((JaxServeLoop, JCFG, params, JaxRequest),
                             (ServeLoop, CFG, state_dict, Request)):
        try:
            if case == "layout":
                build(cls, cfg, p, cache_layout="sparse")
            elif case == "block_size":
                build(cls, cfg, p, cache_layout="paged", kv_block_size=12)
            elif case == "window":
                build(cls, dataclasses.replace(cfg, attention_window=32), p,
                      cache_layout="paged")
            else:
                build(cls, cfg, p, cache_layout="paged", kv_block_size=16,
                      kv_num_blocks=2).run([req(_prompt(1, 40), 20)])
        except ValueError as e:
            errors.append(str(e))
    assert len(errors) == 2 and errors[0] == errors[1]
    assert {"layout": "cache_layout", "block_size": "block_size",
            "window": "sliding-window",
            "pool_capacity": "pool capacity"}[case] in errors[1]


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1/K2 have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_serve_loop_on_card_matches_cpu(cuda_device, state_dict):
    """The f32 ServeLoop through kernels K1/K2 on the card gives the CPU
    plain path's completions, and both kernels were launched."""
    from tpudist_torch.ops.flash_attention import FLASH_FORWARD
    from tpudist_torch.ops.flash_decode import FLASH_DECODE

    want = _sig(ServeLoop(CFG, state_dict, stop_tokens=(59,),
                          device="cpu", **LOOP).run(_workload(Request)))
    f0, d0 = FLASH_FORWARD.launches, FLASH_DECODE.launches
    got = _sig(ServeLoop(CFG, state_dict, stop_tokens=(59,),
                         device=cuda_device, **LOOP).run(_workload(Request)))
    assert got == want
    assert FLASH_FORWARD.launches > f0 and FLASH_DECODE.launches > d0


@pytest.mark.cuda
def test_paged_serve_loop_on_card_matches_cpu(cuda_device, state_dict):
    """The f32 paged ServeLoop (prefix sharing on, a full-prompt hit)
    through K1 and K5 on the card gives the CPU plain path's completions;
    K2 is not launched."""
    from tpudist_torch.ops.flash_decode import (
        FLASH_DECODE,
        PAGED_FLASH_DECODE,
    )

    kw = dict(num_slots=3, steps_per_sync=4, prefill_chunk=8,
              cache_layout="paged", kv_block_size=8)
    want = _sig(ServeLoop(CFG, state_dict, device="cpu", **kw).run(
        _shared_prefix_requests(Request)))
    d0, p0 = FLASH_DECODE.launches, PAGED_FLASH_DECODE.launches
    loop = ServeLoop(CFG, state_dict, device=cuda_device, **kw)
    got = _sig(loop.run(_shared_prefix_requests(Request)))
    assert got == want
    assert PAGED_FLASH_DECODE.launches > p0 and FLASH_DECODE.launches == d0
    assert loop.pool.cow_splits >= 1


# ---- pipelined dispatch, deadlines, hot-swap and service mode -------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_pipelined_depths_token_identical(params, state_dict, monkeypatch,
                                          jax_reference, layout):
    """tests/test_serving.py:163's mixed workload at depths 1, 2 and 3 on
    one instance: tokens, finish reasons and finish ORDER equal the JAX
    loop's at depth 1 (its own depth-2 run is not the anchor: ROADMAP
    Queue C 3).  At depth >= 2 a segment reads nothing on the host per
    tick; at depth 1 every tick reads its early-exit flag.  Stop token 59
    ends some requests early (with these weights 7 and 13 never fire)."""
    stop = (59,)
    kw = dict(stop_tokens=stop, **LOOP)
    if layout == "paged":
        monkeypatch.setenv("TPUDIST_KV_HOST_TIER_BYTES", "0")
        kw.update(cache_layout="paged", kv_block_size=16)
        want = _sig(JaxServeLoop(JCFG, params, decode_attention="flash",
                                 pipeline_depth=1, **kw).run(
            _workload(JaxRequest)))
    else:
        want = jax_reference(stop)
    loop = ServeLoop(CFG, state_dict, device="cpu", **kw)
    assert loop.pipeline_depth == 2     # tpudist's default
    for depth in (1, 2, 3):
        loop.pipeline_depth = depth
        reads = loop.segment_host_reads
        got = _sig(loop.run(_workload(Request)))
        assert got == want, f"depth {depth} diverged"
        if depth == 1:
            assert loop.segment_host_reads > reads
        else:
            assert loop.segment_host_reads == reads
        if loop.pool is not None:
            loop.pool.check()
            assert loop.pool.used_blocks == 0
    assert {r for _, _, r in want} == {"stop", "length"}


def _port_want(state_dict, prompt, n):
    """The port's own greedy rollout (held against JAX's above)."""
    out = greedy_generate(CFG, state_dict, np.asarray(prompt)[None], n,
                          prefill_chunk=8, device="cpu")
    return out.numpy()[0, len(prompt):]


def test_expired_queued_deadline_times_out(params, state_dict):
    """tests/test_serving.py:363: a request already past its deadline
    completes "timeout" with no tokens; the next one is served — as the
    JAX loop does."""
    import time

    def reqs(cls):
        return [cls(_prompt(1, 4), 6, rid="late",
                    deadline_s=time.time() - 100.0),
                cls(_prompt(2, 5), 6, rid="ok")]

    want = _sig(JaxServeLoop(JCFG, params, num_slots=1, steps_per_sync=4,
                             prefill_chunk=8, decode_attention="flash",
                             pipeline_depth=1).run(reqs(JaxRequest)))
    loop = ServeLoop(CFG, state_dict, num_slots=1, steps_per_sync=4,
                     prefill_chunk=8, device="cpu")
    got = _sig(loop.run(reqs(Request)))
    assert got == want
    assert dict((r, reason) for r, _, reason in got) == {
        "late": "timeout", "ok": "length"}
    assert loop.stats.timeouts == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_inflight_deadline_refunds_paged_pool(params, state_dict, depth):
    """tests/test_serving.py:379: a deadline passing MID-DECODE finalizes
    "timeout" with a strict prefix of the uninterrupted rollout (JAX's
    greedy), and every block comes back — at depth 2 through the zombie
    path, with a segment still in flight at the kill; the recycled pool
    then serves a fresh request exactly."""
    import time

    loop = ServeLoop(CFG, state_dict, num_slots=2, steps_per_sync=4,
                     prefill_chunk=8, cache_layout="paged", kv_block_size=16,
                     pipeline_depth=depth, device="cpu")
    t0 = time.time()
    calls = [0]

    def clock():
        calls[0] += 1
        return t0 + (1000.0 if calls[0] > 8 else 0.0)

    loop._clock = clock
    zombies = []
    free = loop.pool.free_slot
    loop.pool.free_slot = lambda slot: (zombies.append(slot), free(slot))[1]
    [c] = loop.run([Request(_prompt(77, 6), 40, rid="doomed",
                            deadline_s=t0 + 500.0)])
    assert c.reason == "timeout"
    assert 0 < c.tokens.shape[0] < 40
    want = np.asarray(jax_greedy(JCFG, params,
                                 jnp.asarray(c.prompt)[None, :], 40,
                                 decode_attention="flash",
                                 prefill_chunk=8))[0, len(c.prompt):]
    np.testing.assert_array_equal(c.tokens, want[:c.tokens.shape[0]])
    loop.pool.check()
    assert loop.pool.free_blocks == loop.pool.num_blocks
    assert zombies == [0] and loop.stats.timeouts == 1
    loop._clock = time.time
    [c2] = loop.run([Request(_prompt(78, 5), 12, rid="next")])
    assert c2.reason == "length"
    np.testing.assert_array_equal(c2.tokens,
                                  _port_want(state_dict, c2.prompt, 12))


def _source(batches):
    it = iter(batches)
    return lambda: next(it)


@pytest.mark.parametrize("depth", [1, 2])
def test_service_mode_streams_like_jax(params, state_dict, depth):
    """tests/test_serving.py:419: incremental intake (an idle poll, a late
    arrival, a malformed request completing "invalid"), every completion
    streamed to the sink in finish order — the JAX loop's completions."""
    def batches(cls):
        return [[cls(_prompt(1, 4), 6, rid="a"),
                 cls(_prompt(2, 9), 8, rid="b"),
                 cls(_prompt(1, 90), 20, rid="toolong")],
                [],
                [cls(_prompt(3, 6), 5, rid="c")],
                None]

    jstream, stream = [], []
    want = _sig(JaxServeLoop(JCFG, params, decode_attention="flash",
                             pipeline_depth=1, **LOOP).run(
        source=_source(batches(JaxRequest)), sink=jstream.append,
        idle_wait_s=0.0))
    loop = ServeLoop(CFG, state_dict, pipeline_depth=depth, device="cpu",
                     **LOOP)
    got = _sig(loop.run(source=_source(batches(Request)),
                        sink=stream.append, idle_wait_s=0.0))
    assert got == want
    assert [c.rid for c in stream] == [c.rid for c in jstream]
    assert dict((r, reason) for r, _, reason in got)["toolong"] == "invalid"
    assert loop.stats.invalid == 1


@pytest.fixture(scope="module")
def params_v2():
    """tests/test_serving.py's second weight set (init seed 1)."""
    return JaxLM(JCFG).init(jax.random.key(1),
                            jnp.zeros((1, 2), jnp.int32))["params"]


@pytest.fixture(scope="module")
def state_dict_v2(params_v2):
    return from_flax_params(jax.tree.map(np.asarray, params_v2), CFG)


def _swap_source(loop, cls, v2, events):
    """tests/test_serving.py:483's script: two requests decoding and one
    queued when the swap arrives, two more arriving with it."""
    old = [cls(_prompt(60 + i, 4 + 2 * i), 8 + i, rid=f"old{i}")
           for i in range(2)]
    queued = cls(_prompt(65, 6), 7, rid="q")
    new = [cls(_prompt(70 + i, 5 + i), 6 + 2 * i, rid=f"new{i}")
           for i in range(2)]
    polls = {"n": 0}

    def source():
        polls["n"] += 1
        if polls["n"] == 1:
            return old + [queued]
        if polls["n"] == 2:
            loop.request_swap(lambda: v2, version=7,
                              on_swapped=lambda: events.append("swapped"))
            return new
        done = sum(1 for e in events if e != "swapped")
        return None if done == 5 else []

    return source


@pytest.mark.parametrize("depth", [1, 2])
def test_midstream_swap_like_jax(params, params_v2, state_dict, depth):
    """TestWeightHotSwap.test_midstream_swap_drains_then_rebinds: the
    requests decoding at the swap finish on the OLD weights, the queued
    one and the new arrivals decode on the NEW ones, every pre-swap
    completion lands before on_swapped — the JAX loop's completions and
    event order, with the new weights converted from its flax tree."""
    jevents, events = [], []
    jloop = JaxServeLoop(JCFG, params, decode_attention="flash",
                         pipeline_depth=1, **LOOP)
    want = _sig(jloop.run(
        source=_swap_source(jloop, JaxRequest, params_v2, jevents),
        sink=lambda c: jevents.append(c.rid), idle_wait_s=0.0))
    loop = ServeLoop(CFG, state_dict, pipeline_depth=depth, device="cpu",
                     **LOOP)
    got = _sig(loop.run(
        source=_swap_source(loop, Request, params_v2, events),
        sink=lambda c: events.append(c.rid), idle_wait_s=0.0))
    assert got == want and events == jevents
    swap_at = events.index("swapped")
    assert set(events[:swap_at]) == {"old0", "old1"}
    assert loop.weights_version == 7 and loop.stats.swaps == 1


def test_swap_between_runs_and_failed_restore(state_dict, state_dict_v2):
    """Between runs the swap lands before the next admission; a restore
    returning None keeps the old weights but still completes."""
    loop = ServeLoop(CFG, state_dict, device="cpu", **LOOP)
    req = Request(_prompt(80, 6), 9, rid="a")
    [c1] = loop.run([req])
    np.testing.assert_array_equal(c1.tokens,
                                  _port_want(state_dict, req.prompt, 9))
    loop.request_swap(lambda: state_dict_v2, version=2)
    [c2] = loop.run([req])
    np.testing.assert_array_equal(c2.tokens,
                                  _port_want(state_dict_v2, req.prompt, 9))
    fired = []
    loop.request_swap(lambda: None, version=9,
                      on_swapped=lambda: fired.append(True))
    [c3] = loop.run([req])
    assert fired == [True] and loop.weights_version == 2
    np.testing.assert_array_equal(c3.tokens, c2.tokens)


@pytest.mark.parametrize("depth", [1, 2])
def test_swap_paged_layout_drains_pool(state_dict, state_dict_v2, depth):
    """TestWeightHotSwap.test_swap_paged_layout_drains_pool: the paged
    loop drains its pool through the swap barrier, and the old and new
    requests decode on their own weights."""
    loop = ServeLoop(CFG, state_dict, num_slots=2, steps_per_sync=4,
                     prefill_chunk=8, cache_layout="paged", kv_block_size=16,
                     pipeline_depth=depth, device="cpu")
    old = [Request(_prompt(82, 7), 8, rid="old")]
    new = [Request(_prompt(83, 5), 7, rid="new")]
    polls = {"n": 0}
    seen = []

    def source():
        polls["n"] += 1
        if polls["n"] == 1:
            return old
        if polls["n"] == 2:
            loop.request_swap(lambda: state_dict_v2, version=3)
            return new
        return None if len(seen) == 2 else []

    comps = {c.rid: c for c in loop.run(source=source, sink=seen.append,
                                        idle_wait_s=0.0)}
    np.testing.assert_array_equal(
        comps["old"].tokens, _port_want(state_dict, old[0].prompt, 8))
    np.testing.assert_array_equal(
        comps["new"].tokens, _port_want(state_dict_v2, new[0].prompt, 7))
    assert loop.pool.used_blocks == 0

