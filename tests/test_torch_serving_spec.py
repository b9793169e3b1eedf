"""tpudist_torch's speculative ServeLoop against tpudist's.

The workload of tpudist's ``tests/test_serve_fused.py`` (4 requests through
2 slots, stop token 1, segments of 8): the port's speculative loop, dense
and paged, at depths 1 and 2, with a fixed K and an adaptive one, must give
tpudist's speculative loop's completions (its ``decode_attention="flash"``,
Pallas in interpret mode, at depth 1) and the port's plain loop's, and its
pool must end drained.  A windowed target verifies through the per-row
chunk without side buffers, held against tpudist's ``_serve_attend``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models.generate import _blank_cache as jax_blank_cache
from tpudist.models.serving import Request as JaxRequest
from tpudist.models.serving import ServeLoop as JaxServeLoop
from tpudist.models.transformer import TransformerConfig as JaxConfig
from tpudist.models.transformer import TransformerLM as JaxLM
from tpudist_torch.models.convert import from_flax_params
from tpudist_torch.models.generate import build_model
from tpudist_torch.models.serving import Request, ServeLoop
from tpudist_torch.models.transformer import TransformerConfig, blank_cache

T_KW = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            embed_dim=64, max_seq_len=96)
D_KW = dict(vocab_size=64, num_layers=1, num_heads=2, num_kv_heads=1,
            embed_dim=32, max_seq_len=96)
JT, JD = JaxConfig(**T_KW), JaxConfig(**D_KW)
TC, DC = TransformerConfig(**T_KW), TransformerConfig(**D_KW)
LOOP = dict(num_slots=2, prefill_chunk=16, stop_tokens=(1,),
            steps_per_sync=8)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
KS = {"k3": dict(num_draft=3),
      "adaptive": dict(num_draft="adaptive", spec_ladder=(2, 4))}
LAYOUTS = {"dense": {}, "paged": dict(cache_layout="paged",
                                      kv_block_size=16)}


def _flax(cfg, seed):
    return JaxLM(cfg).init(jax.random.key(seed),
                           jnp.zeros((1, 2), jnp.int32))["params"]


@pytest.fixture(scope="module")
def weights():
    """tpudist's test models (target seed 0, draft seed 7), flax and
    converted."""
    tp, dp = _flax(JT, 0), _flax(JD, 7)
    return (tp, dp, from_flax_params(jax.tree.map(np.asarray, tp), TC),
            from_flax_params(jax.tree.map(np.asarray, dp), DC))


def _prompt(seed, n):
    return np.asarray(jax.random.randint(jax.random.key(seed), (n,), 1, 64,
                                         dtype=jnp.int32))


def _reqs(cls):
    return [cls(prompt=_prompt(i, 5 + 3 * i), max_new_tokens=12, rid=i)
            for i in range(4)]


def _sig(comps):
    return [(c.rid, tuple(int(t) for t in c.tokens), c.reason)
            for c in comps]


@pytest.fixture(scope="module")
def jax_spec(weights):
    """tpudist's speculative loop's completions at depth 1, per layout,
    K and window."""
    tp, dp, _, _ = weights
    cache = {}

    def get(layout, ks, window=None):
        key = (layout, ks, window)
        if key not in cache:
            cfg = dataclasses.replace(JT, attention_window=window)
            loop = JaxServeLoop(cfg, tp, decode_attention="flash",
                                pipeline_depth=1, decode_mode="speculative",
                                draft_cfg=JD, draft_params=dp,
                                **LAYOUTS[layout], **KS[ks], **LOOP)
            cache[key] = _sig(loop.run(_reqs(JaxRequest)))
        return cache[key]

    return get


@pytest.fixture(scope="module")
def port_plain(weights):
    _, _, tsd, _ = weights
    return _sig(ServeLoop(TC, tsd, device="cpu", **LOOP).run(_reqs(Request)))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("ks", list(KS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_serve_matches_jax_and_plain(weights, jax_spec, port_plain,
                                          layout, ks, depth):
    """Completions equal tpudist's speculative loop's and the port's plain
    loop's (per request; at depth 1 with a fixed K also in tpudist's
    finish order), the spec counters moved, and a paged pool ends
    drained and consistent."""
    _, _, tsd, dsd = weights
    loop = ServeLoop(TC, tsd, pipeline_depth=depth, decode_mode="speculative",
                     draft_cfg=DC, draft_params=dsd, device="cpu",
                     **LAYOUTS[layout], **KS[ks], **LOOP)
    got = _sig(loop.run(_reqs(Request)))
    want = jax_spec(layout, ks)
    assert sorted(got) == sorted(want) == sorted(port_plain)
    if depth == 1 and ks == "k3":
        assert got == want
    st = loop.stats
    assert st.spec_rounds > 0 and st.spec_k in (2, 3, 4)
    assert 0 <= st.spec_accepted <= st.spec_row_rounds * st.spec_k
    if ks == "adaptive":
        assert loop._spec_policy.rounds_seen > 0
    if loop.pool is not None:
        loop.pool.check()
        assert loop.pool.used_blocks == 0


def test_spec_serve_draft_is_target_accepts_everything(weights, port_plain):
    """With draft = target every live row accepts every draft token."""
    _, _, tsd, _ = weights
    loop = ServeLoop(TC, tsd, pipeline_depth=2, decode_mode="speculative",
                     draft_cfg=TC, draft_params=tsd, num_draft=4,
                     device="cpu", **LOOP)
    assert sorted(_sig(loop.run(_reqs(Request)))) == sorted(port_plain)
    assert loop.stats.spec_accepted == 4 * loop.stats.spec_row_rounds


@pytest.mark.parametrize("depth", [1, 2])
def test_spec_serve_reads_the_host_once_a_round(weights, depth):
    """At every depth a speculative segment reads the host once a round
    and once more to end: spec_host_reads counts each of them, and the
    plain segment's tick reads stay untouched."""
    _, _, tsd, dsd = weights
    loop = ServeLoop(TC, tsd, pipeline_depth=depth, decode_mode="speculative",
                     draft_cfg=DC, draft_params=dsd, num_draft=3,
                     device="cpu", **LOOP)
    loop.run(_reqs(Request))
    st = loop.stats
    assert loop.spec_host_reads == st.spec_rounds + st.segments > 0
    assert loop.segment_host_reads == 0


def test_spec_side_buffer_bound_names_both_terms(weights):
    """A side buffer of steps_per_sync + num_draft slots past max_seq_len
    is refused with both terms in the message."""
    _, _, tsd, dsd = weights
    with pytest.raises(ValueError, match=r"steps_per_sync 94 \+ num_draft 3"
                                         r" = 97\) exceeds max_seq_len 96"):
        ServeLoop(TC, tsd, num_slots=1, steps_per_sync=94,
                  decode_mode="speculative", draft_cfg=DC,
                  draft_params=dsd, num_draft=3, device="cpu")


@pytest.mark.parametrize("depth", [1, 2])
def test_windowed_target_spec_serve_matches_jax(weights, jax_spec, depth):
    """A sliding-window target has no side buffer: its verify chunk takes
    the per-row path; completions equal tpudist's."""
    _, _, tsd, dsd = weights
    cfg = dataclasses.replace(TC, attention_window=8)
    with pytest.warns(UserWarning, match="sliding-window"):
        loop = ServeLoop(cfg, tsd, pipeline_depth=depth,
                         decode_mode="speculative", draft_cfg=DC,
                         draft_params=dsd, device="cpu", **KS["k3"], **LOOP)
    got = _sig(loop.run(_reqs(Request)))
    want = jax_spec("dense", "k3", window=8)
    assert sorted(got) == sorted(want)
    if depth == 1:
        assert got == want


@pytest.mark.parametrize("window", [None, 8])
def test_per_row_verify_chunk_matches_jax(window):
    """The per-row verify chunk without side buffers: each row's s = 4
    tokens land at its own index, query j sees the row's first idx + j + 1
    positions (and the window); logits, K/V and indices equal tpudist's
    ``_serve_attend`` with s > 1."""
    kw = dict(T_KW, max_seq_len=32, attention_window=window)
    jcfg, cfg = JaxConfig(**kw), TransformerConfig(**kw)
    params = _flax(jcfg, 3)
    b, s = 3, 4
    idx = np.array([5, 17, 30], np.int32)     # the last row is clamped
    rng = np.random.default_rng(4)
    kv = rng.standard_normal((2, 2, b, 32, 32)).astype(np.float32)
    jmodel = JaxLM(jcfg, decode=True, decode_attention="dense")
    jcache = jax_blank_cache(jmodel, b)
    for li, name in enumerate(("block0", "block1")):
        node = jcache[name]["attn"]
        node["cache_index"] = jnp.asarray(idx)
        node["cached_key"] = jnp.asarray(kv[li, 0])
        node["cached_value"] = jnp.asarray(kv[li, 1])
    toks = rng.integers(0, 64, (b, s)).astype(np.int32)
    pos = np.minimum(idx[:, None] + np.arange(s), 31)
    want, mut = jmodel.apply({"params": params, "cache": jcache},
                             jnp.asarray(toks), positions=jnp.asarray(pos),
                             mutable=["cache"])
    model = build_model(cfg, jax.tree.map(np.asarray, params), device="cpu")
    cache = blank_cache(cfg, b, device="cpu", per_row=True)
    for li, layer in enumerate(cache):
        layer["cache_index"] = torch.from_numpy(idx.copy())
        layer["cached_key"] = torch.from_numpy(kv[li, 0].copy())
        layer["cached_value"] = torch.from_numpy(kv[li, 1].copy())
    with torch.no_grad():
        got, cache = model(torch.from_numpy(toks).long(),
                           positions=torch.from_numpy(pos).long(),
                           cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for li, layer in enumerate(cache):
        node = mut["cache"][f"block{li}"]["attn"]
        np.testing.assert_array_equal(layer["cache_index"].numpy(),
                                      np.asarray(node["cache_index"]))
        for name in ("cached_key", "cached_value"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(node[name]), **LOGIT_TOL)


def _errors(cls_loop, cls_req, tcfg, tp, dcfg, dp):
    """Each speculative configuration error's message (None: no error)."""
    cases = [dict(), dict(draft_cfg=dcfg),
             dict(draft_cfg=dataclasses.replace(dcfg, vocab_size=32),
                  draft_params=dp),
             dict(draft_cfg=dataclasses.replace(dcfg, max_seq_len=64),
                  draft_params=dp),
             dict(draft_cfg=dcfg, draft_params=dp, num_draft=0),
             dict(draft_cfg=dcfg, draft_params=dp, num_draft="many"),
             dict(draft_cfg=dcfg, draft_params=dp, num_draft="adaptive",
                  spec_ladder=())]
    out = []
    for kw in cases:
        try:
            cls_loop(tcfg, tp, num_slots=1, decode_mode="speculative", **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    # headroom: 60 + 30 + 8 - 1 = 97 > 96
    loop = cls_loop(tcfg, tp, num_slots=1, decode_mode="speculative",
                    draft_cfg=dcfg, draft_params=dp, num_draft=8)
    try:
        loop._validate(cls_req(prompt=_prompt(0, 60), max_new_tokens=30))
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    loop._validate(cls_req(prompt=_prompt(0, 59), max_new_tokens=30))
    return out


def test_spec_configuration_errors_match_jax(weights):
    """Missing draft, vocabulary, draft length, num_draft, ladder and the
    per-request headroom: tpudist's ValueErrors, word for word."""
    tp, dp, tsd, dsd = weights
    want = _errors(JaxServeLoop, JaxRequest, JT, tp, JD, dp)
    got = _errors(lambda *a, **k: ServeLoop(*a, device="cpu", **k), Request,
                  TC, tsd, DC, dsd)
    assert got == want and all(m is not None for m in got)
    assert "speculative serving" in got[-1] and "draft_cfg" in got[0]


def test_serve_continuous_example_on_cpu(capsys):
    """examples/serve_continuous_gpu.py at a small size on the CPU: the
    trained LM and draft serve the language's continuations (accuracy >
    0.9, exit 0) speculatively and print the acceptance rate."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parent.parent / "examples"
            / "serve_continuous_gpu.py")
    spec = importlib.util.spec_from_file_location("serve_continuous_gpu",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    # one intra-op thread: under a loaded multi-worker run, torch's
    # default thread pool oversubscribes the cores many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = example.main(["--device", "cpu", "--seq-len", "96",
                           "--train-steps", "40", "--requests", "3",
                           "--speculative", "3"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "speculative K=3" in out and "draft acceptance" in out
