"""tpudist_torch's sequence parallelism against the JAX package's (the
counterpart of ``tests/test_ring_attention.py``).

The port runs in spawned gloo ranks (``run_ranks`` of
``tests/test_torch_data_parallel.py``: a ``file://`` store under the
test's temporary directory, a time limit per spawn); tpudist runs the same
functions under ``jax.shard_map`` on the same mesh shape of
``tests/conftest.py``'s virtual CPU devices, Pallas in interpret mode,
exactly as its own tests run them.  Each module fixture computes the JAX
references of a group of cases, hands the numpy inputs to one spawn of the
port's ranks, and gathers their blocks; the tests compare case by case.
On the CPU the ring flash steps run the plain versions of K1, K8 and K4.

Tolerances (f32): attention outputs atol = rtol = 1e-5 and their
gradients 1e-4, as tpudist's test holds its strategies to plain
attention; logits of ``sp_forward`` atol = rtol = 1e-4, as
``tests/test_torch_transformer.py``; the train step's losses and
parameters after 2 Adam steps as ``tests/test_torch_training.py``
(``assert_params_close``).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_data_parallel import (
    RANK_TIMEOUT_S,
    assert_params_close,
    run_ranks,
)

ROOT = Path(__file__).resolve().parent.parent
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)

# name: (strategy, causal, window, (b, s, h, h_kv, d), seed, factory
# kwargs, gradients too)
CASES4 = {
    "ring_causal": ("ring", True, None, (2, 32, 4, 4, 8), 0, {}, True),
    "ring_full": ("ring", False, None, (2, 32, 4, 4, 8), 0, {}, False),
    "ring_gqa2": ("ring", True, None, (2, 32, 8, 2, 8), 3, {}, False),
    "ring_window": ("ring", True, 12, (1, 32, 2, 2, 8), 5, {}, True),
    "flash_causal": ("ring_flash", True, None, (1, 32, 2, 2, 8), 2,
                     {"block_q": 8, "block_k": 8}, True),
    "flash_full": ("ring_flash", False, None, (1, 32, 2, 2, 8), 2,
                   {"block_q": 8, "block_k": 8}, True),
    "flash_gqa2": ("ring_flash", True, None, (1, 32, 8, 2, 8), 3, {}, True),
    "flash_gqa4": ("ring_flash", True, None, (1, 32, 8, 4, 8), 3, {}, True),
    "flash_window": ("ring_flash", True, 12, (1, 32, 2, 2, 8), 5,
                     {"block_q": 8, "block_k": 8, "window": 12}, True),
    "flash_uneven": ("ring_flash", True, None, (1, 32, 2, 2, 4), 6,
                     {"block_q": 4, "block_k": 8}, False),
    "ulysses_causal": ("ulysses", True, None, (2, 32, 4, 4, 8), 0, {}, True),
    "ulysses_full": ("ulysses", False, None, (2, 32, 4, 4, 8), 0, {}, False),
    "ulysses_gqa2": ("ulysses", True, None, (2, 32, 8, 2, 8), 3, {}, False),
    "ulysses_gqa4": ("ulysses", True, None, (2, 32, 8, 4, 8), 3, {}, False),
    "ulysses_window": ("ulysses", True, 12, (1, 32, 4, 4, 8), 5, {}, False),
}
# 2 ranks: rank 0 holds rank 1's block, wholly in its future, at step 1
CASES2 = {
    "future_flash": ("ring_flash", True, None, (1, 16, 4, 2, 16), 7, {},
                     True),
    "future_ring": ("ring", True, None, (1, 16, 4, 2, 16), 7, {}, True),
}


def _inputs(spec, seed):
    b, s, h, h_kv, d = spec
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, s, h_kv, d), np.float32),
            rng.standard_normal((b, s, h_kv, d), np.float32))


# ---- the reference (parent process only) ----------------------------------

def _jax_case(devices, n, case):
    """tpudist's output (and q/k/v gradients of sum(out²)) under shard_map
    over an ``n``-device ``seq`` mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpudist.parallel import ring_attention as jra
    from tpudist.runtime.mesh import make_mesh

    kind, causal, window, spec, seed, fkw, grads = case
    q, k, v = (jnp.asarray(x) for x in _inputs(spec, seed))
    if kind == "ring_flash":
        attend = functools.partial(jra.ring_flash_attention_fn("seq", **fkw),
                                   causal=causal)
    else:
        make = {"ring": jra.ring_attention_fn,
                "ulysses": jra.ulysses_attention_fn}[kind]
        attend = functools.partial(make("seq"), causal=causal, window=window)
    mesh = make_mesh({"seq": n}, devices[:n])

    def fn(q, k, v):
        if not grads:
            return attend(q, k, v)
        # the gradients of the per-shard LOCAL loss sum(out²), as
        # tpudist's test takes them: the sum over shards is the global
        # loss (one compile for the output and its gradients)
        o, vjp = jax.vjp(attend, q, k, v)
        return (o, *vjp(2 * o))

    spec = P(None, "seq")
    res = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                                out_specs=(spec,) * 4 if grads else spec,
                                check_vma=False))(q, k, v)
    names = ("out", "dq", "dk", "dv") if grads else ("out",)
    return dict(zip(names, map(np.asarray, res if grads else (res,))))


# ---- the ranks -------------------------------------------------------------

def _attention_rank(rank, world, cases):
    """The port's output (and gradients) of each case on this rank's
    sequence block."""
    from tpudist_torch.parallel import (
        ring_attention_fn,
        ring_flash_attention_fn,
        ulysses_attention_fn,
    )
    from tpudist_torch.runtime import local_block, make_mesh

    make = {"ring": ring_attention_fn, "ring_flash": ring_flash_attention_fn,
            "ulysses": ulysses_attention_fn}
    mesh = make_mesh({"seq": world})
    results = {}
    for name, (kind, causal, window, spec, seed, fkw, grads) in cases.items():
        attend = make[kind]("seq", mesh=mesh, **fkw)
        kw = {"causal": causal}
        if kind != "ring_flash":
            kw["window"] = window
        xs = [local_block(torch.from_numpy(x), mesh, (None, "seq"))
              .clone().requires_grad_(grads) for x in _inputs(spec, seed)]
        out = attend(*xs, **kw)
        res = {"out": out.detach().numpy()}
        if grads:
            out.square().sum().backward()
            res.update(dq=xs[0].grad.numpy(), dk=xs[1].grad.numpy(),
                       dv=xs[2].grad.numpy())
        results[name] = res
    return results


def _gather_seq(blocks):
    """The ranks' ``[B, S/n, ...]`` blocks of a ``seq`` mesh, in order."""
    return {key: np.concatenate([b[key] for b in blocks], 1)
            for key in blocks[0]}


def _check(got, want, case):
    np.testing.assert_allclose(got["out"], want["out"], **OUT_TOL,
                               err_msg=f"{case} out")
    assert set(got) == set(want)
    for name in ("dq", "dk", "dv"):
        if name in want:
            np.testing.assert_allclose(got[name], want[name], **GRAD_TOL,
                                       err_msg=f"{case} {name}")


@pytest.fixture(scope="module")
def ring4(devices8, tmp_path_factory):
    want = {name: _jax_case(devices8, 4, c) for name, c in CASES4.items()}
    ranks = run_ranks(_attention_rank, 4, tmp_path_factory.mktemp("ring4"),
                      CASES4)
    return want, {name: _gather_seq([r[name] for r in ranks])
                  for name in CASES4}


@pytest.mark.parametrize("case", sorted(CASES4))
def test_sp_attention_matches_jax_on_four_ranks(ring4, case):
    """Ring, ring flash and Ulysses at 4 ranks on a ``seq`` axis: causal
    and not, GQA (``h_kv`` 2 and 4), a sliding window across blocks, the
    uneven ``block_q=4, block_k=8`` — outputs, and q/k/v gradients."""
    want, got = ring4
    _check(got[case], want[case], case)


@pytest.fixture(scope="module")
def ring2(devices8, tmp_path_factory):
    want = {name: _jax_case(devices8, 2, c) for name, c in CASES2.items()}
    ranks = run_ranks(_attention_rank, 2, tmp_path_factory.mktemp("ring2"),
                      CASES2)
    return want, {name: _gather_seq([r[name] for r in ranks])
                  for name in CASES2}


@pytest.mark.parametrize("case", sorted(CASES2))
def test_ring_with_blocks_wholly_in_the_future(ring2, case):
    """2 ranks, causal: at its second step rank 0 holds rank 1's block,
    every key of which is in its queries' future (K1 gives O = 0 and an
    LSE of -1e30 there; K8 and K4 write zeros)."""
    want, got = ring2
    _check(got[case], want[case], case)


def _one_rank(rank, world):
    """A gloo group of one: the ring has one step and equals the plain
    attention functions."""
    from tpudist_torch.models.transformer import sdpa
    from tpudist_torch.ops.flash_attention import flash_attention
    from tpudist_torch.parallel import (
        ring_attention_fn,
        ring_flash_attention_fn,
        ulysses_attention_fn,
    )
    from tpudist_torch.runtime import make_mesh

    mesh = make_mesh({"seq": 1})
    q, k, v = (torch.from_numpy(x) for x in _inputs((2, 16, 4, 2, 16), 8))
    out = {}
    for window in (None, 6):
        out[("ring_flash", window)] = (
            ring_flash_attention_fn("seq", window=window, mesh=mesh)(
                q, k, v).numpy(),
            flash_attention(q, k, v, window=window).numpy())
        out[("ring", window)] = (
            ring_attention_fn("seq", mesh=mesh)(q, k, v,
                                               window=window).numpy(),
            sdpa(q, k, v, window=window).numpy())
        out[("ulysses", window)] = (
            ulysses_attention_fn("seq", mesh=mesh)(q, k, v,
                                                  window=window).numpy(),
            sdpa(q, k, v, window=window).numpy())
    return out


def test_one_rank_ring_equals_flash_attention(tmp_path):
    (out,) = run_ranks(_one_rank, 1, tmp_path)
    for key, (got, want) in out.items():
        if key[0] == "ring_flash":   # the same K1 call, merged with nothing
            np.testing.assert_array_equal(got, want, err_msg=str(key))
        else:
            np.testing.assert_allclose(got, want, **OUT_TOL,
                                       err_msg=str(key))


# ---- the model on a data × seq grid ----------------------------------------

LM = dict(vocab_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
          embed_dim=32, max_seq_len=64)
LM_BATCH, LM_SEQ, LR, STEPS = 4, 64, 1e-3, 2
GRID_ATTN = ("ring", "ring_flash")


def _lm_batch():
    tokens = np.random.default_rng(0).integers(
        0, LM["vocab_size"], (LM_BATCH, LM_SEQ)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_grid(devices, kind):
    """tpudist's sp_forward logits and make_sp_train_step (2 Adam steps:
    losses, final parameters) on a data 2 × seq 2 mesh, and the initial
    parameters."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpudist.models.transformer import TransformerConfig, TransformerLM
    from tpudist.ops.losses import cross_entropy_per_token
    from tpudist.parallel import ring_attention as jra
    from tpudist.parallel.data_parallel import broadcast_params
    from tpudist.runtime.mesh import make_mesh
    from tpudist.train.state import TrainState

    cfg = TransformerConfig(**LM)
    tokens, targets = (jnp.asarray(x) for x in _lm_batch())
    params = TransformerLM(cfg).init(jax.random.key(0), tokens)["params"]
    mesh = make_mesh({"data": 2, "seq": 2}, devices[:4])
    attn = (jra.ring_attention_fn("seq") if kind == "ring"
            else jra.ring_flash_attention_fn("seq", block_q=8, block_k=8))
    model = TransformerLM(cfg, attention_fn=attn)
    logits = np.asarray(jra.sp_forward(model, mesh)(params, tokens))
    state = TrainState.create(model.apply, broadcast_params(params, mesh),
                              optax.adam(LR))
    step = jra.make_sp_train_step(model, cross_entropy_per_token, mesh,
                                  tokens.size)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, tokens, targets)
        losses.append(float(m["loss"]))
    np_tree = functools.partial(jax.tree.map, np.asarray)
    return {"logits": logits, "losses": losses,
            "params": _state_dict_lm(np_tree(state.params)),
            "init": _state_dict_lm(np_tree(params))}


def _state_dict_lm(params):
    from tpudist_torch.models.convert import from_flax_params
    from tpudist_torch.models.transformer import TransformerConfig

    return {k: v.numpy() for k, v in from_flax_params(
        params, TransformerConfig(**LM)).items()}


def _grid_rank(rank, world, init, tokens, targets):
    """sp_forward and 2 steps of make_sp_train_step on a data 2 × seq 2
    mesh, for each attention strategy of ``GRID_ATTN``."""
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.ops.losses import cross_entropy_per_token
    from tpudist_torch.parallel import (
        broadcast_params,
        make_sp_train_step,
        ring_attention_fn,
        ring_flash_attention_fn,
        sp_forward,
    )
    from tpudist_torch.runtime import local_block, make_mesh
    from tpudist_torch.train import TrainState, adam

    mesh = make_mesh({"data": 2, "seq": 2})
    toks = local_block(torch.from_numpy(tokens).long(), mesh)
    tgts = local_block(torch.from_numpy(targets).long(), mesh)
    out = {}
    for kind in GRID_ATTN:
        attn = (ring_attention_fn("seq", mesh=mesh) if kind == "ring"
                else ring_flash_attention_fn("seq", 8, 8, mesh=mesh))
        model = TransformerLM(TransformerConfig(**LM), attention_fn=attn,
                              param_dtype=torch.float32, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in init.items()})
        broadcast_params(model, mesh)
        with torch.no_grad():
            logits = sp_forward(model, mesh)(toks).numpy()
        state = TrainState.create(model, adam(LR))
        step = make_sp_train_step(model, cross_entropy_per_token, mesh,
                                  tokens.size)
        losses = []
        for _ in range(STEPS):
            state, m = step(state, toks, tgts)
            losses.append(float(m["loss"]))
        out[kind] = {"logits": logits, "losses": losses,
                     "params": {k: v.detach().numpy().copy()
                                for k, v in model.state_dict().items()}}
    return out


@pytest.fixture(scope="module")
def grid(devices8, tmp_path_factory):
    want = {kind: _jax_grid(devices8, kind) for kind in GRID_ATTN}
    tokens, targets = _lm_batch()
    ranks = run_ranks(_grid_rank, 4, tmp_path_factory.mktemp("grid"),
                      want["ring"]["init"], tokens, targets)
    return want, ranks


@pytest.mark.parametrize("kind", GRID_ATTN)
def test_sp_forward_matches_jax_on_data2_seq2(grid, kind):
    """Each rank's ``[B/2, S/2]`` logits block, placed by its mesh
    coordinates (rank = 2·data + seq), against tpudist's sp_forward."""
    want, ranks = grid
    logits = want[kind]["logits"]
    b, s = LM_BATCH // 2, LM_SEQ // 2
    for rank, out in enumerate(ranks):
        d, q = divmod(rank, 2)
        np.testing.assert_allclose(
            out[kind]["logits"], logits[d * b:(d + 1) * b, q * s:(q + 1) * s],
            **LOGIT_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("kind", GRID_ATTN)
def test_sp_train_step_matches_jax_on_data2_seq2(grid, kind):
    """2 Adam steps of make_sp_train_step on data 2 × seq 2 from the same
    weights as tpudist's: the summed loss at each step on every rank, and
    every parameter after (replicas identical)."""
    want, ranks = grid
    for rank, out in enumerate(ranks):
        np.testing.assert_allclose(out[kind]["losses"], want[kind]["losses"],
                                   **LOSS_TOL, err_msg=f"rank {rank}")
        assert_params_close(out[kind]["params"], want[kind]["params"])
    for k, v in ranks[0][kind]["params"].items():
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[kind]["params"][k], v)


# ---- errors (one process) ---------------------------------------------------

def test_errors():
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from tpudist_torch.parallel import (
        ring_attention_fn,
        ring_flash_attention_fn,
    )

    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="must divide"):
        ring_flash_attention_fn("seq", block_q=3)(q, q, q)
    with pytest.raises(ValueError, match="requires causal=True"):
        ring_flash_attention_fn("seq", window=4)(q, q, q, causal=False)
    with pytest.raises(ValueError, match="requires causal=True"):
        ring_attention_fn("seq")(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ring_flash_attention_fn("seq")(q, q[:, :, :1].expand(1, 8, 3, 8),
                                       q[:, :, :1].expand(1, 8, 3, 8))
    cfg = TransformerConfig(**dict(LM, attention_window=8))
    with pytest.raises(ValueError, match="attention_window"):
        TransformerLM(cfg, attention_fn=ring_flash_attention_fn(window=4),
                      device="cpu")
    TransformerLM(cfg, attention_fn=ring_flash_attention_fn(window=8),
                  device="cpu")


# ---- the example under torchrun ---------------------------------------------

def test_example_ring_flash_sp2_under_torchrun():
    """``examples/long_context_lm_gpu.py --attn ring_flash --sp 2`` on two
    CPU processes under ``torch.distributed.run``: the loss it prints is
    finite; tpudist's flag rules reject ``--sp 1`` with ring attention."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    args = ["--device", "cpu", "--layers", "2", "--embed-dim", "32",
            "--heads", "4", "--seq-len", "64", "--batch-size", "2",
            "--steps", "2", "--log-every", "1"]
    script = str(ROOT / "examples" / "long_context_lm_gpu.py")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", script, "--attn", "ring_flash", "--sp",
         "2", *args], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=RANK_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    losses = [float(line.split("loss")[1]) for line in res.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all(), res.stdout
    assert "sp2 (ring_flash)" in res.stdout
    bad = subprocess.run([sys.executable, script, "--attn", "ring_flash",
                          "--sp", "1", *args], capture_output=True,
                         text=True, cwd=ROOT, timeout=RANK_TIMEOUT_S)
    assert bad.returncode != 0 and "pass --sp N" in bad.stderr
