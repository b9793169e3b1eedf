"""tpudist_torch's beam search and sampled rollout against the JAX
package's.

A small f32 model (vocab 64, 2 layers, 4 heads over 2 KV heads, embed 32)
from flax weights through ``convert.py``: ``beam_search_generate`` at
widths 1, 3 and 4, with stop tokens, a length penalty and the scores,
``decode_attention`` ``"dense"`` and ``"flash"`` (the plain versions of
K1 and K2 on the CPU), against tpudist's ``beam_search_generate``.
``sample_generate`` draws from a ``torch.Generator``, so its tokens
cannot match ``jax.random``'s: its filters are held exactly against
tpudist's (the same logits kept, the rest ``-inf``), and ``top_k=1`` (and
``temperature=0``) must give tpudist's greedy tokens.

Tolerances: tokens and lengths exactly equal; the beams' log-prob scores
within atol 1e-4 (sums of up to 8 f32 log-softmax terms over a 64-way
vocabulary, computed in other orders).
"""

import numpy as np
import pytest
import torch

from tpudist_torch.models import beam_search_generate, sample_generate
from tpudist_torch.models.transformer import TransformerConfig

BASE = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            embed_dim=32, max_seq_len=32)
PROMPT_LEN, NEW = 7, 8
SCORE_ATOL = 1e-4

_REF: dict = {}


def _ref():
    if not _REF:
        pytest.importorskip("flax", reason="the JAX reference needs flax")
        import jax
        import jax.numpy as jnp

        from tpudist.models import TransformerConfig as JCfg
        from tpudist.models import TransformerLM
        from tpudist.models.generate import greedy_generate

        cfg = JCfg(**BASE)
        rng = np.random.default_rng(3)
        prompt = rng.integers(0, BASE["vocab_size"], (2, PROMPT_LEN)).astype(
            np.int32)
        params = jax.tree.map(np.asarray, TransformerLM(cfg).init(
            jax.random.key(2), jnp.asarray(prompt))["params"])
        greedy = np.asarray(greedy_generate(cfg, params, jnp.asarray(prompt),
                                            NEW))
        _REF.update(cfg=cfg, params=params, prompt=prompt, greedy=greedy,
                    stop=int(greedy[1, PROMPT_LEN + 2]))
    return _REF


# name: (beam_size, kwargs)
BEAM_CASES = {
    "w4": (4, {}),
    "w4_flash": (4, {"decode_attention": "flash"}),
    "w1_is_greedy": (1, {}),
    "w3_stop_penalty": (3, {"stop": True, "length_penalty": 0.6}),
    "w4_stop_flash_chunked": (4, {"stop": True, "decode_attention": "flash",
                                  "prefill_chunk": 3}),
}


@pytest.mark.parametrize("name", sorted(BEAM_CASES))
def test_beam_matches_tpudist(name):
    import jax.numpy as jnp

    from tpudist.models.beam import beam_search_generate as jax_beam

    ref = _ref()
    w, kw = BEAM_CASES[name]
    kw = dict(kw)
    stop = {"stop_tokens": [ref["stop"]]} if kw.pop("stop", False) else {}
    flash = kw.pop("decode_attention", "dense")
    want = jax_beam(ref["cfg"], ref["params"], jnp.asarray(ref["prompt"]),
                    NEW, beam_size=w, return_scores=True, **stop, **kw)
    got = beam_search_generate(
        TransformerConfig(**BASE), ref["params"],
        torch.from_numpy(ref["prompt"]), NEW, beam_size=w,
        return_scores=True, decode_attention=flash, device="cpu", **stop,
        **kw)
    want = [np.asarray(x) for x in want]
    assert len(got) == len(want)
    for g, x in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), x)
    np.testing.assert_allclose(got[-1].numpy(), want[-1], atol=SCORE_ATOL,
                               rtol=0)
    if name == "w1_is_greedy":
        np.testing.assert_array_equal(got[0][:, 0].numpy(), ref["greedy"])
    if stop:
        assert (want[1] < PROMPT_LEN + NEW).any(), "the stop never fired"


def test_beam_errors_match_tpudist():
    ref = _ref()
    cfg = TransformerConfig(**BASE)
    prompt = torch.from_numpy(ref["prompt"])
    for kw, msg in ((dict(beam_size=0), "beam_size must be >= 1"),
                    (dict(beam_size=65), "exceeds vocab_size 64")):
        with pytest.raises(ValueError, match=msg):
            beam_search_generate(cfg, ref["params"], prompt, 4,
                                 device="cpu", **kw)
    with pytest.raises(ValueError, match="exceeds max_seq_len 32"):
        beam_search_generate(cfg, ref["params"], prompt, 30, device="cpu")


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(temperature=0.0),
                                dict(top_k=1, top_p=0.5,
                                     decode_attention="flash")])
def test_sample_top_k1_is_greedy(kw):
    ref = _ref()
    got = sample_generate(TransformerConfig(**BASE), ref["params"],
                          torch.from_numpy(ref["prompt"]), NEW,
                          torch.Generator().manual_seed(0), device="cpu",
                          **kw)
    np.testing.assert_array_equal(got.numpy(), ref["greedy"])


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, None), (0.7, None, 0.8), (1.3, 10, 0.6), (1.0, 64, 1.0)])
def test_filtered_distribution_matches_tpudist(temperature, top_k, top_p):
    """The categorical a sample is drawn from: the port's filtered logits
    equal tpudist's (the kept set exactly, values within f32 rounding)."""
    import jax.numpy as jnp

    from tpudist.models.generate import _filtered_logits as jax_filtered
    from tpudist_torch.models.generate import _filtered_logits

    logits = np.random.default_rng(7).standard_normal((6, 64)).astype(
        np.float32)
    want = np.asarray(jax_filtered(jnp.asarray(logits), temperature, top_k,
                                   top_p))
    got = _filtered_logits(torch.from_numpy(logits), temperature, top_k,
                           top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=1e-6)


def test_sample_stops_and_draws_from_generator():
    """Stop tokens freeze a row at its first stop (pad after it, lengths
    returned); the same generator seed draws the same tokens."""
    ref = _ref()
    cfg = TransformerConfig(**BASE)
    prompt = torch.from_numpy(ref["prompt"])

    def run(seed):
        return sample_generate(cfg, ref["params"], prompt, NEW,
                               torch.Generator().manual_seed(seed),
                               temperature=1.0, top_k=1,
                               stop_tokens=[ref["stop"]], pad_token=63,
                               device="cpu")

    toks, lens = run(0)
    assert int(lens[1]) == PROMPT_LEN + 3
    assert (toks[1, PROMPT_LEN + 3:] == 63).all()
    a = sample_generate(cfg, ref["params"], prompt, NEW,
                        torch.Generator().manual_seed(5), top_k=8,
                        device="cpu")
    b = sample_generate(cfg, ref["params"], prompt, NEW,
                        torch.Generator().manual_seed(5), top_k=8,
                        device="cpu")
    assert torch.equal(a, b)


def test_sample_validation_messages_match_tpudist():
    ref = _ref()
    cfg = TransformerConfig(**BASE)
    prompt = torch.from_numpy(ref["prompt"])
    for kw, msg in ((dict(temperature=-1.0), "temperature must be >= 0"),
                    (dict(top_k=0), "top_k must be >= 1"),
                    (dict(top_p=0.0), r"top_p must be in \(0, 1\]")):
        with pytest.raises(ValueError, match=msg):
            sample_generate(cfg, ref["params"], prompt, 2, device="cpu",
                            **kw)
