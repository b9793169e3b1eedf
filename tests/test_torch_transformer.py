"""tpudist_torch's TransformerLM against the JAX package's.

Weights come from the flax init through ``from_flax_params``; the inputs
are seeded numpy tokens.  Tolerance (f32): atol = rtol = 1e-4 on logits
and 2e-5 on cached K/V — both sides compute in f32, through different
matmul libraries (XLA's CPU dot vs ATen), so products sum in different
orders and differences of a few ulp grow through the layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models.generate import _blank_cache as jax_blank_cache
from tpudist.models.generate import _prefill as jax_prefill
from tpudist.models.transformer import TransformerConfig as JaxConfig
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.generate import _prefill, build_model
from tpudist_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    blank_cache,
)
from tpudist_torch.train import TrainState

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=64,
            max_seq_len=96)
CONFIGS = {
    "mha": {},
    "gqa": {"num_kv_heads": 2},
    "window": {"num_kv_heads": 2, "attention_window": 8},
}


def _pair(name, **extra):
    kw = dict(BASE, **CONFIGS[name], **extra)
    jcfg = JaxConfig(**kw)
    params = JaxLM(jcfg).init(jax.random.key(0),
                              jnp.zeros((1, 2), jnp.int32))["params"]
    return jcfg, TransformerConfig(**kw), params


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


def test_converter_round_trip():
    """Every parameter of the port's model is filled, shapes match, and
    the f32 state_dict comes back unchanged."""
    _, cfg, params = _pair("gqa")
    sd = from_flax_params(_np_tree(params), cfg)
    model = TransformerLM(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    np.testing.assert_array_equal(
        sd["blocks.1.attn.kv.weight"].numpy(),
        np.asarray(params["block1"]["attn"]["kv"]["kernel"]).T)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_sequence_logits_match(name):
    jcfg, cfg, params = _pair(name)
    toks = _tokens(1, (2, 40))
    want = np.asarray(JaxLM(jcfg).apply({"params": params},
                                        jnp.asarray(toks)))
    model = build_model(cfg, _np_tree(params), device="cpu")
    got = model(torch.from_numpy(toks)).detach().numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_scanned_checkpoint_logits_match():
    """A checkpoint trained with scan_layers=True (stacked blocks) is
    unstacked by the converter and serves the same logits."""
    jcfg, cfg, _ = _pair("gqa", scan_layers=True)
    params = JaxLM(jcfg).init(jax.random.key(2),
                              jnp.zeros((1, 2), jnp.int32))["params"]
    assert "blocks" in params
    toks = _tokens(2, (1, 24))
    want = np.asarray(JaxLM(jcfg).apply({"params": params},
                                        jnp.asarray(toks)))
    model = build_model(cfg, _np_tree(params), device="cpu")
    assert not model.cfg.scan_layers
    got = model(torch.from_numpy(toks)).detach().numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("name", ["gqa", "window"])
def test_chunked_prefill_matches_one_shot(name):
    _, cfg, params = _pair(name)
    model = build_model(cfg, _np_tree(params), device="cpu")
    prompt = torch.from_numpy(_tokens(3, (2, 37)))
    with torch.no_grad():
        c1, l1 = _prefill(model, blank_cache(cfg, 2, device="cpu"), prompt,
                          None)
        c2, l2 = _prefill(model, blank_cache(cfg, 2, device="cpu"), prompt,
                          8)
    torch.testing.assert_close(l2[:, -1], l1[:, -1], **LOGIT_TOL)
    for a, b in zip(c1, c2):
        assert int(a["cache_index"]) == int(b["cache_index"]) == 37
        torch.testing.assert_close(b["cached_key"], a["cached_key"],
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["gqa", "window"])
def test_cache_after_prefill_matches_jax(name):
    """The packed [B, S, Hkv*D] cache the port writes holds the same K/V
    as the flax cache collection after the same chunked prefill (flash
    path on both sides), and the same last-position logits."""
    jcfg, cfg, params = _pair(name)
    jmodel = JaxLM(jcfg, decode=True, decode_attention="flash")
    prompt = _tokens(4, (2, 21))
    jcache, jlogits = jax_prefill(jmodel, params, jax_blank_cache(jmodel, 2),
                                  jnp.asarray(prompt), 8)
    model = build_model(cfg, _np_tree(params), device="cpu")
    with torch.no_grad():
        cache, logits = _prefill(model, blank_cache(cfg, 2, device="cpu"),
                                 torch.from_numpy(prompt), 8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    for i, layer in enumerate(cache):
        jl = jcache[f"block{i}"]["attn"]
        assert int(layer["cache_index"]) == int(jl["cache_index"])
        for name_ in ("cached_key", "cached_value"):
            np.testing.assert_allclose(layer[name_].numpy(),
                                       np.asarray(jl[name_]),
                                       atol=2e-5, rtol=2e-5)


def test_cached_decode_step_matches_full_forward():
    """Prefill then one-token flash decode steps reproduce the uncached
    forward's logits at every position."""
    _, cfg, params = _pair("gqa")
    model = build_model(cfg, _np_tree(params), device="cpu")
    toks = torch.from_numpy(_tokens(5, (2, 20)))
    with torch.no_grad():
        full = model(toks)
        cache, _ = _prefill(model, blank_cache(cfg, 2, device="cpu"),
                            toks[:, :12], 8)
        for t in range(12, 20):
            pos = torch.full((2, 1), t)
            step, cache = model(toks[:, t:t + 1], positions=pos, cache=cache)
            torch.testing.assert_close(step[:, 0], full[:, t], **LOGIT_TOL)


def test_unported_paths_raise():
    _, cfg, _ = _pair("mha")
    model = TransformerLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="verify chunk"):
        model(torch.zeros((2, 3), dtype=torch.long),
              positions=torch.zeros((2, 3), dtype=torch.long),
              cache=blank_cache(cfg, 2, device="cpu", per_row=True))
    # the paged layout is ported: the model builds, sized by its pool;
    # a windowed paged model is refused as in the JAX package
    paged = TransformerLM(cfg, serve_side_slots=4, cache_layout="paged",
                          kv_block_size=16, kv_num_blocks=8, device="cpu")
    assert (paged.kv_block_size, paged.kv_num_blocks) == (16, 8)
    with pytest.raises(ValueError, match="sliding-window"):
        TransformerLM(dataclasses.replace(cfg, attention_window=8),
                      cache_layout="paged", kv_block_size=16,
                      kv_num_blocks=8, device="cpu")
    with pytest.raises(ValueError, match="kv_num_blocks > 0"):
        TransformerLM(cfg, cache_layout="paged", device="cpu")
    with pytest.raises(NotImplementedError, match="sharded decode"):
        TransformerLM(cfg, decode_shard=("mesh", "model"), device="cpu")
    # scan_layers is accepted now (the port runs the unrolled stack); a
    # sharded train state is laid out over a mesh of processes, so it
    # needs a process group (tests/test_torch_mesh_compose.py builds one)
    scanned = TransformerLM(dataclasses.replace(cfg, scan_layers=True),
                            device="cpu")
    assert len(scanned.blocks) == cfg.num_layers
    from tpudist_torch.parallel import MeshSpec
    from tpudist_torch.train import sgd

    with pytest.raises(RuntimeError, match="process group"):
        TrainState.create_sharded(scanned, sgd(0.1), MeshSpec(tp=2))
