"""tpudist_torch's sharded rollouts against the JAX package's.

``tp_generate``, ``sp_generate`` and ``tp_sp_generate``, and the sharded
speculative rollouts (``tp_speculative_generate``,
``sp_speculative_generate``, ``tp_sp_speculative_generate``, with a
1-layer draft, K = 4) run in 4 gloo ranks spawned once for the module
(``run_ranks``): tp 2
(a leading ``rep`` axis of 2 fills the 4 ranks), sp 2, sp 4 and tp 2 ×
sp 2, each with ``decode_attention`` ``"flash"`` (the plain versions of
K1 and K2 on the CPU, at the shard's offsets, with the LSE merge across
ranks) and ``"dense"``, and with stop tokens.  A 10-token prompt is
prefilled in chunks of 6, so at sp 4 (8 slots a rank) the second chunk
straddles two ranks' slices.  tpudist runs its own sharded rollouts
(GSPMD, dense cached attention) on the same mesh shapes of conftest's
virtual CPU devices, from the same flax weights.

Tolerance: tokens exactly equal in f32 (greedy, first index on ties), on
every rank, and the speculative rollouts' rounds and accepted drafts
equal tpudist's; each rank's cache shard is 1/tp, 1/sp or 1/(tp·sp) of
the whole cache's bytes.
"""

import numpy as np
import pytest

from tests.test_torch_data_parallel import run_ranks

BASE = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            embed_dim=32, max_seq_len=32)
PROMPT_LEN, NEW, CHUNK = 10, 8, 6
# name: (entry point, mesh axes, kwargs); "rep" fills the 4 ranks
CASES = {
    "tp2_flash": ("tp_generate", {"rep": 2, "model": 2},
                  {"decode_attention": "flash"}),
    "tp2_dense": ("tp_generate", {"rep": 2, "model": 2},
                  {"decode_attention": "dense"}),
    "sp2_flash": ("sp_generate", {"rep": 2, "seq": 2},
                  {"decode_attention": "flash"}),
    "sp4_flash": ("sp_generate", {"seq": 4}, {"decode_attention": "flash"}),
    "sp4_dense": ("sp_generate", {"seq": 4}, {"decode_attention": "dense"}),
    "tp2_sp2_flash": ("tp_sp_generate", {"model": 2, "seq": 2},
                      {"decode_attention": "flash"}),
    "tp2_sp2_dense": ("tp_sp_generate", {"model": 2, "seq": 2},
                      {"decode_attention": "dense"}),
    "sp4_flash_stop": ("sp_generate", {"seq": 4},
                       {"decode_attention": "flash", "stop": True}),
    "tp2_sp2_flash_stop": ("tp_sp_generate", {"model": 2, "seq": 2},
                           {"decode_attention": "flash", "stop": True}),
}
DRAFT = dict(vocab_size=64, num_layers=1, num_heads=2, num_kv_heads=1,
             embed_dim=16, max_seq_len=32)
K = 4
# name: (entry point, mesh axes, kwargs) of the speculative rollouts
SPEC_CASES = {
    "tp2_flash": ("tp_speculative_generate", {"rep": 2, "model": 2},
                  {"decode_attention": "flash"}),
    "tp2_dense_stop": ("tp_speculative_generate", {"rep": 2, "model": 2},
                       {"decode_attention": "dense", "stop": True}),
    "sp4_flash": ("sp_speculative_generate", {"seq": 4},
                  {"decode_attention": "flash"}),
    "sp2_dense": ("sp_speculative_generate", {"rep": 2, "seq": 2},
                  {"decode_attention": "dense"}),
    "tp2_sp2_flash": ("tp_sp_speculative_generate", {"model": 2, "seq": 2},
                      {"decode_attention": "flash"}),
}
# each case's share of the whole cache's K/V bytes on one rank
SHARE = {"tp_generate": 2, "sp_generate": None, "tp_sp_generate": 4}

_REF: dict = {}


def _ref():
    """tpudist's model weights (numpy), the prompt, its greedy rollout
    and a stop token that fires inside it."""
    if not _REF:
        import jax
        import jax.numpy as jnp

        from tpudist.models import TransformerConfig, TransformerLM
        from tpudist.models.generate import greedy_generate

        cfg = TransformerConfig(**BASE)
        rng = np.random.default_rng(0)
        prompt = rng.integers(0, BASE["vocab_size"], (2, PROMPT_LEN)).astype(
            np.int32)
        params = TransformerLM(cfg).init(
            jax.random.key(1), jnp.asarray(prompt))["params"]
        params = jax.tree.map(np.asarray, params)
        greedy = np.asarray(greedy_generate(cfg, params, jnp.asarray(prompt),
                                            NEW))
        dcfg = TransformerConfig(**DRAFT)
        dparams = jax.tree.map(np.asarray, TransformerLM(dcfg).init(
            jax.random.key(2), jnp.asarray(prompt))["params"])
        _REF.update(cfg=cfg, params=params, prompt=prompt, greedy=greedy,
                    stop=int(greedy[0, PROMPT_LEN + 3]), dcfg=dcfg,
                    dparams=dparams)
    return _REF


def _jax_sharded(name):
    """tpudist's sharded rollout of the case on its mesh shape."""
    import jax
    import jax.numpy as jnp

    from tpudist.models import generate as jg
    from tpudist.runtime.mesh import make_mesh

    ref = _ref()
    fn, axes, kw = CASES[name]
    axes = {k: v for k, v in axes.items() if k != "rep"}
    mesh = make_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])
    extra = {"stop_tokens": [ref["stop"]]} if kw.get("stop") else {}
    return getattr(jg, fn)(ref["cfg"], ref["params"],
                           jnp.asarray(ref["prompt"]), NEW, mesh,
                           prefill_chunk=CHUNK, decode_attention="dense",
                           **extra)


def _jax_speculative(name):
    """tpudist's sharded speculative rollout of the case (its stats
    included) on its mesh shape."""
    import jax
    import jax.numpy as jnp

    from tpudist.models import speculative as js
    from tpudist.runtime.mesh import make_mesh

    ref = _ref()
    fn, axes, kw = SPEC_CASES[name]
    axes = {k: v for k, v in axes.items() if k != "rep"}
    mesh = make_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])
    extra = {"stop_tokens": [ref["stop"]]} if kw.get("stop") else {}
    out = getattr(js, fn)(ref["cfg"], ref["params"], ref["dcfg"],
                          ref["dparams"], jnp.asarray(ref["prompt"]), NEW,
                          mesh, num_draft=K, prefill_chunk=CHUNK,
                          return_stats=True, **extra)
    stats = {k: int(v) for k, v in out[-1].items()}
    return tuple(np.asarray(x) for x in out[:-1]), stats


def _ranks(rank, world, payload):
    import torch

    from tpudist_torch.models import generate as tg
    from tpudist_torch.models.transformer import TransformerConfig
    from tpudist_torch.runtime.mesh import make_mesh

    cfg = TransformerConfig(**BASE)
    prompt = torch.from_numpy(payload["prompt"])
    out = {}
    for name, (fn, axes, kw) in CASES.items():
        mesh = make_mesh(axes)
        extra = {"stop_tokens": [payload["stop"]]} if kw.get("stop") else {}
        caches = []
        orig = tg._blank_cache

        def spy(*a, **k):
            caches.append(orig(*a, **k))
            return caches[-1]

        tg._blank_cache = spy
        try:
            res = getattr(tg, fn)(
                cfg, payload["params"], prompt, NEW, mesh,
                prefill_chunk=CHUNK, device="cpu",
                decode_attention=kw["decode_attention"], **extra)
        finally:
            tg._blank_cache = orig
        kv_bytes = sum(t.numel() * t.element_size() for layer in caches[0]
                       for n, t in layer.items() if n != "cache_index")
        if isinstance(res, tuple):
            res = (res[0].numpy(), res[1].numpy())
        else:
            res = res.numpy()
        out[name] = {"tokens": res, "kv_bytes": kv_bytes}
    from tpudist_torch.models import speculative as ts

    dcfg = TransformerConfig(**DRAFT)
    for name, (fn, axes, kw) in SPEC_CASES.items():
        mesh = make_mesh(axes)
        extra = {"stop_tokens": [payload["stop"]]} if kw.get("stop") else {}
        res = getattr(ts, fn)(
            cfg, payload["params"], dcfg, payload["dparams"], prompt, NEW,
            mesh, num_draft=K, prefill_chunk=CHUNK, return_stats=True,
            decode_attention=kw["decode_attention"], device="cpu", **extra)
        out["spec_" + name] = {
            "tokens": tuple(x.numpy() for x in res[:-1]),
            "stats": {k: int(v) for k, v in res[-1].items()}}
    return out


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    ref = _ref()
    payload = {"params": ref["params"], "prompt": ref["prompt"],
               "stop": ref["stop"], "dparams": ref["dparams"]}
    return run_ranks(_ranks, 4, tmp_path_factory.mktemp("sharded_gen"),
                     payload)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_generate_matches_tpudist(name, rank_results):
    want = _jax_sharded(name)
    ref = _ref()
    if CASES[name][2].get("stop"):
        want = tuple(np.asarray(w) for w in want)
        assert (want[1] < PROMPT_LEN + NEW).any(), "the stop never fired"
    else:
        want = np.asarray(want)
        np.testing.assert_array_equal(want, ref["greedy"])
    for r, res in enumerate(rank_results):
        got = res[name]["tokens"]
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_cache_shard_bytes(name, rank_results):
    """Each rank allocates its shard of the cache and no more: the whole
    cache's K/V bytes over tp, sp or tp·sp."""
    fn, axes, _ = CASES[name]
    cfg = BASE
    whole = (2 * cfg["num_layers"] * 2 * cfg["max_seq_len"]
             * cfg["num_kv_heads"] * cfg["embed_dim"] // cfg["num_heads"]
             * 4)
    n = SHARE[fn] or axes["seq"]
    for res in rank_results:
        assert res[name]["kv_bytes"] == whole // n


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_sharded_speculative_matches_tpudist(name, rank_results):
    want, stats = _jax_speculative(name)
    if not SPEC_CASES[name][2].get("stop"):
        np.testing.assert_array_equal(want[0], _ref()["greedy"])
    for r, res in enumerate(rank_results):
        got = res["spec_" + name]
        assert len(got["tokens"]) == len(want)
        for g, w in zip(got["tokens"], want):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")
        assert got["stats"] == stats, f"rank {r}"


def test_example_sp2_generate_under_torchrun():
    """``examples/long_context_lm_gpu.py --attn ring_flash --sp 2
    --generate`` on two CPU processes decodes through ``sp_generate``
    (flash, the cache split over the two processes) to the tokens of the
    one-process run's ``greedy_generate`` from the same seeded weights
    (no training steps, so the weights are equal bit for bit)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    script = str(root / "examples" / "long_context_lm_gpu.py")
    args = ["--device", "cpu", "--layers", "2", "--embed-dim", "32",
            "--heads", "4", "--kv-heads", "2", "--seq-len", "32",
            "--batch-size", "2", "--steps", "0", "--generate", "6"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    runs = [subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                           timeout=300, env=env)
            for cmd in ([sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc-per-node", "2", script,
                         "--attn", "ring_flash", "--sp", "2", *args],
                        [sys.executable, script, *args])]
    for res in runs:
        assert res.returncode == 0, res.stderr[-3000:]
    assert "via sp2 flash" in runs[0].stdout
    assert "via single-program flash" in runs[1].stdout
    sample = [r.stdout.split("sample:")[1].strip() for r in runs]
    assert sample[0] == sample[1]
