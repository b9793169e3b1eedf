"""tpudist_torch's speculative decoding against tpudist's.

Greedy rollouts must be token-identical to tpudist's ``speculative_generate``
(its own tests' ``decode_attention="dense"``) and to the port's
``greedy_generate``, for any draft, with the same round and acceptance
counts; the accept rule, the filtered probabilities and the adaptive-K
policy must give tpudist's values on the same inputs.  The weights are the
flax init, converted (``from_flax_params``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models import speculative as jspec
from tpudist.models.transformer import TransformerConfig as JaxConfig
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist_torch.models import speculative as spec
from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.generate import greedy_generate
from tpudist_torch.models.transformer import TransformerConfig

T_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=64,
            max_seq_len=96)
D_KW = dict(vocab_size=64, num_layers=1, num_heads=2, embed_dim=32,
            max_seq_len=96)
JT, JD = JaxConfig(**T_KW), JaxConfig(**D_KW)
TC, DC = TransformerConfig(**T_KW), TransformerConfig(**D_KW)


def _flax(cfg, seed):
    return JaxLM(cfg).init(jax.random.key(seed),
                           jnp.zeros((1, 2), jnp.int32))["params"]


@pytest.fixture(scope="module")
def models():
    """(jax target, jax draft, port target, port draft) weights: tpudist's
    test models (target seed 0, draft seed 1)."""
    tp, dp = _flax(JT, 0), _flax(JD, 1)
    return (tp, dp,
            from_flax_params(jax.tree.map(np.asarray, tp), TC),
            from_flax_params(jax.tree.map(np.asarray, dp), DC))


def _prompt(seed, shape):
    return np.asarray(jax.random.randint(jax.random.key(seed), shape, 0, 64))


# ---- the accept rule and the probabilities --------------------------------

def _one_hot_round(seed, b=5, k=4, v=9):
    """Greedy inputs: one-hot p and q, drafts that match the target's
    argmax for a random prefix of each row."""
    rng = np.random.default_rng(seed)
    p_tok = rng.integers(0, v, (b, k + 1))
    draft = rng.integers(0, v, (b, k))
    for r in range(b):
        agree = rng.integers(0, k + 1)
        draft[r, :agree] = p_tok[r, :agree]
    eye = np.eye(v, dtype=np.float32)
    active = rng.random(b) < 0.7
    return eye[p_tok], eye[draft], draft.astype(np.int32), active


@pytest.mark.parametrize("frozen", [False, True], ids=["all_live", "frozen"])
@pytest.mark.parametrize("seed", range(4))
def test_accept_and_next_greedy_matches_jax(seed, frozen):
    """One-hot (greedy) p and q: m, emit and the per-row accepted counts
    equal tpudist's, with frozen rows counted as all-accept."""
    p, q, draft, active = _one_hot_round(seed)
    act = active if frozen else None
    jm, jemit, jacc = jspec._accept_and_next(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(draft),
        jax.random.key(seed),
        active=None if act is None else jnp.asarray(act))
    m, emit, acc = spec._accept_and_next(
        torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(draft),
        torch.Generator().manual_seed(seed),
        active=None if act is None else torch.from_numpy(act))
    assert int(m) == int(jm)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


def test_sampled_rule_output_distribution_is_p():
    """The speculative-sampling identity: with p != q, the token emitted at
    the first position (the accepted draft, else a residual resample)
    follows p.  N = 200,000 rows of K = 1 in one batched call (the batch
    holds a rejecting row, so m = 0 and every row's emit is its first
    token); each frequency within 0.006 of p and the total variation
    below 0.01 (sampling noise at this N: about 0.002)."""
    v, n = 8, 200_000
    g = torch.Generator().manual_seed(0)
    p_row = torch.softmax(torch.randn(v, generator=g), -1)
    q_row = torch.softmax(torch.randn(v, generator=g) * 1.5, -1)
    p = p_row.expand(n, 2, v)
    q = q_row.expand(n, 1, v)
    draft = torch.multinomial(q_row, n, replacement=True,
                              generator=g)[:, None]
    m, emit, _ = spec._accept_and_next(p, q, draft, g)
    assert int(m) == 0
    freq = torch.bincount(emit, minlength=v).double() / n
    np.testing.assert_allclose(freq.numpy(), p_row.double().numpy(),
                               atol=0.006)
    assert 0.5 * (freq - p_row.double()).abs().sum() < 0.01


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, None, None), (1.0, None, None), (0.7, 5, None), (1.3, None, 0.6),
    (0.9, 8, 0.75)])
def test_filtered_probs_matches_jax(temperature, top_k, top_p):
    logits = (np.random.default_rng(3).standard_normal((3, 5, 64)) * 3
              ).astype(np.float32)
    want = np.asarray(jspec._filtered_probs(jnp.asarray(logits), temperature,
                                            top_k, top_p))
    got = spec._filtered_probs(torch.from_numpy(logits), temperature, top_k,
                               top_p).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_set_cache_index_resets_every_index():
    cache = [{"cache_index": torch.tensor(5, dtype=torch.int32),
              "side_index": torch.tensor(2, dtype=torch.int32),
              "cached_key": torch.ones(1, 4, 2)}]
    spec._set_cache_index(cache, 3)
    assert int(cache[0]["cache_index"]) == 3
    assert int(cache[0]["side_index"]) == 3
    assert cache[0]["cached_key"].sum() == 8


# ---- rollouts -----------------------------------------------------------

@pytest.mark.parametrize("num_draft", [1, 3, 4])
def test_speculative_generate_token_identical(models, num_draft):
    """An unrelated random draft: tokens equal tpudist's rollout and the
    port's greedy_generate; rounds and accepted drafts equal tpudist's."""
    tp, dp, tsd, dsd = models
    prompt = _prompt(2, (3, 5))
    want, jst = jspec.speculative_generate(
        JT, tp, JD, dp, jnp.asarray(prompt), 20, num_draft=num_draft,
        return_stats=True)
    got, st = spec.speculative_generate(TC, tsd, DC, dsd, prompt, 20,
                                        num_draft=num_draft,
                                        return_stats=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), greedy_generate(TC, tsd, prompt, 20,
                                     device="cpu").numpy())
    assert st == {"rounds": int(jst["rounds"]),
                  "draft_accepted": int(jst["draft_accepted"])}


def test_draft_is_target_accepts_everything(models):
    tp, _, tsd, _ = models
    prompt = _prompt(3, (2, 4))
    want, jst = jspec.speculative_generate(JT, tp, JT, tp, jnp.asarray(prompt),
                                           24, num_draft=4, return_stats=True)
    got, st = spec.speculative_generate(TC, tsd, TC, tsd, prompt, 24,
                                        num_draft=4, return_stats=True,
                                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st["rounds"] == int(jst["rounds"]) == -(-23 // 5)
    assert st["draft_accepted"] == int(jst["draft_accepted"]) == 4 * 5 * 2


def test_stop_tokens_and_lengths(models):
    tp, dp, tsd, dsd = models
    prompt = np.ones((2, 4), np.int32)
    want, want_len = jspec.speculative_generate(
        JT, tp, JD, dp, jnp.asarray(prompt), 16, num_draft=3,
        stop_tokens=(3,), pad_token=0)
    got, got_len = spec.speculative_generate(
        TC, tsd, DC, dsd, prompt, 16, num_draft=3, stop_tokens=(3,),
        pad_token=0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_sampled_rollout_draft_is_target_accepts_all(models):
    """Sampling from identical distributions accepts with probability 1;
    tokens lie in the vocabulary and move with the generator's seed."""
    _, _, tsd, _ = models
    prompt = np.ones((2, 4), np.int32)
    toks, st = spec.speculative_generate(
        TC, tsd, TC, tsd, prompt, 16, num_draft=4, temperature=1.0,
        generator=torch.Generator().manual_seed(7), return_stats=True,
        device="cpu")
    assert toks.shape == (2, 20)
    assert st["draft_accepted"] == 4 * st["rounds"] * 2
    other = spec.speculative_generate(
        TC, tsd, TC, tsd, prompt, 16, num_draft=4, temperature=1.0,
        generator=torch.Generator().manual_seed(8), device="cpu")
    assert not torch.equal(toks, other)
    assert 0 <= int(toks.min()) and int(toks.max()) < 64


@pytest.mark.parametrize("case", ["vocab", "too_long", "num_draft",
                                  "max_new"])
def test_validation_errors_match(case):
    """tpudist's argument errors, same type and message (checked before
    any weight is read, so both sides get None weights)."""
    bad = {"vocab": dict(draft=JaxConfig(vocab_size=32, max_seq_len=96)),
           "too_long": dict(prompt=(1, 90), new=8),
           "num_draft": dict(num_draft=0),
           "max_new": dict(new=0)}[case]
    jdraft = bad.get("draft", JD)
    tdraft = (TransformerConfig(vocab_size=32, max_seq_len=96)
              if "draft" in bad else DC)
    prompt = np.ones(bad.get("prompt", (1, 2)), np.int32)
    new, k = bad.get("new", 4), bad.get("num_draft", 4)
    with pytest.raises(ValueError) as want:
        jspec.speculative_generate(JT, None, jdraft, None,
                                   jnp.asarray(prompt), new, num_draft=k)
    with pytest.raises(ValueError) as got:
        spec.speculative_generate(TC, None, tdraft, None, prompt, new,
                                  num_draft=k, device="cpu")
    assert str(got.value) == str(want.value)


# ---- the adaptive-K policy ----------------------------------------------

def _policy_script(mod):
    """Drive one policy through every method; returns what each call gave."""
    P = mod.AdaptiveDraftPolicy
    out = [P._per_row_mean(0.7, 5)]
    for a in (0.3, 0.6, 0.95):
        for k in (2, 4, 16):
            out.append(P.infer_acceptance(P._per_row_mean(a, k) / k, k))
    pol = P(ladder=(2, 4, 8, 16), draft_cost_ratio=0.3, ema=0.4,
            initial_acceptance=0.9)
    out += [pol.expected_tokens_per_round(0.8, 4, 3), pol.calibrated,
            pol.round_cost(8), pol.num_draft]
    out += [pol.best_k(a, batch=b) for a in (0.2, 0.5, 0.8, 0.99)
            for b in (1, 4, 8)]
    pol.update({"rounds": 0, "draft_accepted": 0}, batch=2, num_draft=4)
    pol.update({"rounds": 5, "draft_accepted": 23}, batch=2, num_draft=4)
    pol.update({"rounds": 3, "draft_accepted": 2}, batch=1, num_draft=8)
    out += [pol.acceptance, pol.rounds_seen]
    pol.observe_round_cost(4, 1.2)
    out += [pol.round_cost(k) for k in (2, 4, 16)]
    pol.observe_round_cost(4, 0.0)
    pol.observe_round_cost(4, 1.6)
    pol.observe_round_cost(16, 2.6)
    out += [pol.round_cost(k) for k in (2, 4, 8, 16)]
    out += [pol.best_k(0.05, batch=4), pol.calibrated]
    pol.set_plain_cost(0.0)
    pol.set_plain_cost(0.1)
    pol.set_plain_cost(0.3)
    out += [pol._plain_tok_s, pol.best_k(0.05, batch=4),
            pol.best_k(0.05, batch=4, allow_plain=False),
            pol.best_k(1.0, batch=4), pol.num_draft]
    return out


def test_adaptive_policy_matches_jax():
    """Every method on the same calls gives tpudist's values."""
    want, got = _policy_script(jspec), _policy_script(spec)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == pytest.approx(w, rel=1e-12, abs=1e-15), (i, g, w)
    for mod in (jspec, spec):
        with pytest.raises(ValueError, match="ladder"):
            mod.AdaptiveDraftPolicy(ladder=())
        with pytest.raises(ValueError, match="draft_cost_ratio"):
            mod.AdaptiveDraftPolicy(draft_cost_ratio=0.0)


def test_adaptive_rollout_exact_and_adapts(models):
    """tpudist's adaptive test: a random draft starts at K = 8 and drops
    to 2; the tokens stay greedy's exactly."""
    _, _, tsd, dsd = models
    prompt = _prompt(2, (2, 4))
    pol = spec.AdaptiveDraftPolicy(ladder=(2, 8), draft_cost_ratio=0.2,
                                   initial_acceptance=0.97)
    toks, st = spec.adaptive_speculative_generate(
        TC, tsd, DC, dsd, prompt, 24, pol, segment_tokens=8,
        return_stats=True, probe_plain=False, device="cpu")
    np.testing.assert_array_equal(
        toks.numpy(), greedy_generate(TC, tsd, prompt, 24,
                                      device="cpu").numpy())
    assert st["ks"][0] == 8 and set(st["ks"][1:]) == {2}
    assert st["acceptance"][-1] < 0.3


def test_adaptive_plain_probe_arms_gate(models):
    """probe_plain: the second segment is plain, the gate arms, tokens
    stay exact (segments of 8, 8 and 4 tokens)."""
    _, _, tsd, dsd = models
    prompt = _prompt(2, (2, 4))
    pol = spec.AdaptiveDraftPolicy(ladder=(2, 8), initial_acceptance=0.97)
    toks, st = spec.adaptive_speculative_generate(
        TC, tsd, DC, dsd, prompt, 20, pol, segment_tokens=8,
        return_stats=True, device="cpu")
    np.testing.assert_array_equal(
        toks.numpy(), greedy_generate(TC, tsd, prompt, 20,
                                      device="cpu").numpy())
    assert st["ks"][1] == 0 and pol._plain_tok_s is not None
    with pytest.raises(ValueError, match="max_new_tokens"):
        spec.adaptive_speculative_generate(TC, tsd, DC, dsd, prompt, 0, pol,
                                           device="cpu")
