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
    with pytest.raises(NotImplementedError, match="deadline"):
        loop.run([Request(_prompt(1, 4), 2, deadline_s=1.0)])
    with pytest.raises(NotImplementedError, match="service mode"):
        loop.run(source=lambda: None)
    for kw in ({"pipeline_depth": 2}, {"cache_layout": "paged"},
               {"decode_mode": "speculative"}, {"role": "prefill"},
               {"preempt": "migrate"}):
        with pytest.raises(NotImplementedError):
            ServeLoop(CFG, state_dict, num_slots=1, device="cpu", **kw)
    for kw, match in (({"degrade_max_new": 0}, "degrade_max_new"),
                      ({"degrade_queue": -1}, "degrade_queue"),
                      ({"preempt": "bogus"}, "preempt")):
        with pytest.raises(ValueError, match=match):
            ServeLoop(CFG, state_dict, num_slots=1, device="cpu", **kw)


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
