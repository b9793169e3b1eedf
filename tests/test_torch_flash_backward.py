"""tpudist_torch's flash-attention backward against the JAX package's.

On the CPU the port runs its plain versions (``flash_block_grads_plain``,
``_flash_forward_plain`` under the autograd wrapper); the JAX side runs the
Pallas kernels in interpret mode.  Same inputs (numpy, seeded) into both;
the block-grads cases feed both sides the JAX forward's ``out`` and
``lse``, so they compare the backward alone.

Tolerance (f32): 2e-5 absolute plus 1e-4 relative.  Both sides compute in
f32, but the Pallas kernels sum dQ over K blocks and dK/dV over q-blocks
and group members one block at a time while the plain version reduces in
one einsum, so sums differ by a few ulp of their largest terms.

The ``future`` case is a block wholly in its queries' future (a causal
ring's dead block): the forward gives O = 0 and an LSE of -1e30 there, so
its backward takes the LSE and O of the same queries against their own
diagonal block, as the ring's final statistics are, and every gradient
must be an exact zero.

The planner tests (``_bwd_plan``) need no card: the plan's walks cover
every live tile exactly once, K3 and K8 take the same plan, and the plain
versions run over each split's key or query slice at the slice's offsets,
summed in split order, give the unsplit result and the JAX package's.

The ``cuda`` tests hold kernels K3, K8 and K4 against the plain versions
on the card, at shapes where the planner splits and where it does not,
and check that two calls give the same bits.  The JAX package is imported
inside a fixture, so on a card host without flax they still run (the
parity tests skip there).
"""

import importlib

import numpy as np
import pytest
import torch

from tpudist_torch.ops import flash_attention as tfa

TOL = dict(atol=2e-5, rtol=1e-4)

# (b, sq, sk, h, h_kv, d, causal, q_offset, k_offset, window,
#  jax block_q, block_k)
CASES = {
    "mha": (2, 32, 32, 4, 4, 16, True, 0, 0, None, 16, 16),
    "gqa": (2, 32, 32, 4, 2, 32, True, 0, 0, None, 16, 16),
    "window": (1, 64, 64, 4, 2, 16, True, 0, 0, 20, 16, 16),
    "non_causal": (2, 24, 40, 4, 2, 16, False, 0, 0, None, 8, 8),
    "q_offset": (1, 16, 64, 4, 2, 16, True, 40, 0, None, 16, 16),
    "q_k_offsets": (1, 32, 32, 4, 2, 16, True, 32, 16, None, 16, 16),
    "window_offset": (1, 16, 64, 4, 2, 16, True, 40, 0, 12, 16, 16),
    "future": (1, 32, 32, 4, 2, 16, True, 0, 32, None, 16, 16),
    "window_q_after_k": (1, 32, 32, 4, 2, 16, True, 48, 16, 24, 16, 16),
}
# cases whose backward takes the statistics of the queries' own diagonal
# block (their own block is dead)
DIAGONAL_STATS = {"future"}


def _inputs(seed, b, sq, sk, h, h_kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, h_kv, d), np.float32)
    v = rng.standard_normal((b, sk, h_kv, d), np.float32)
    do = rng.standard_normal((b, sq, h, d), np.float32)
    return q, k, v, do


@pytest.fixture(scope="module")
def jax_flash():
    """The JAX package's flash-attention module (Pallas, interpret mode
    here)."""
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    # the module, not the function tpudist.ops re-exports under its name
    return importlib.import_module("tpudist.ops.flash_attention")


def _jax_case(jfa, case):
    """The case's inputs and the JAX forward's (out, lse), as numpy (for a
    ``DIAGONAL_STATS`` case, of the queries against their own block)."""
    import jax.numpy as jnp

    b, sq, sk, h, h_kv, d, causal, q_off, k_off, window, bq, bk = CASES[case]
    q, k, v, do = _inputs(sorted(CASES).index(case), b, sq, sk, h, h_kv, d)
    stats_k_off = q_off if case in DIAGONAL_STATS else k_off
    out, lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, bq, bk, True,
        q_offset=q_off, k_offset=stats_k_off, window=window)
    return (q, k, v, do, np.asarray(out), np.asarray(lse)), CASES[case]


def _t(*xs):
    return [torch.from_numpy(np.array(x, copy=True)) for x in xs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_grads_match_jax(jax_flash, case):
    """``delta=None``: Δ from ``out`` and ``dout`` (the fused dQ route of
    B2, then B3)."""
    import jax.numpy as jnp

    (q, k, v, do, out, lse), spec = _jax_case(jax_flash, case)
    _, _, _, _, _, _, causal, q_off, k_off, window, bq, bk = spec
    want = jax_flash.flash_block_grads(
        *(jnp.asarray(x) for x in (q, k, v, do, lse)), None, causal=causal,
        block_q=bq, block_k=bk, interpret=True, q_offset=q_off,
        k_offset=k_off, window=window, out=jnp.asarray(out))
    tq, tk, tv, tdo, tlse, tout = _t(q, k, v, do, lse, out)
    got = tfa.flash_block_grads(tq, tk, tv, tdo, tlse, None, causal=causal,
                                q_offset=q_off, k_offset=k_off, window=window,
                                out=tout)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
        if case in DIAGONAL_STATS:
            assert not g.any() and not np.asarray(w).any(), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_grads_explicit_delta_match_jax(jax_flash, case):
    """An explicit Δ (the ring backward's route, B7, then B3)."""
    import jax.numpy as jnp

    (q, k, v, do, out, lse), spec = _jax_case(jax_flash, case)
    _, _, _, _, _, _, causal, q_off, k_off, window, bq, bk = spec
    delta = jax_flash.flash_delta(jnp.asarray(out), jnp.asarray(do))
    want = jax_flash.flash_block_grads(
        *(jnp.asarray(x) for x in (q, k, v, do, lse)), delta, causal=causal,
        block_q=bq, block_k=bk, interpret=True, q_offset=q_off,
        k_offset=k_off, window=window)
    tq, tk, tv, tdo, tlse, tout = _t(q, k, v, do, lse, out)
    tdelta = tfa.flash_delta(tout, tdo)
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(delta), **TOL)
    got = tfa.flash_block_grads(tq, tk, tv, tdo, tlse, tdelta,
                                causal=causal, q_offset=q_off,
                                k_offset=k_off, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
        if case in DIAGONAL_STATS:
            assert not g.any() and not np.asarray(w).any(), name


def test_forward_on_a_future_block_is_dead(jax_flash):
    """A block wholly in its queries' future: O = 0 and an LSE of -1e30
    (the running max floored at -1e30, the sum at 1e-30), in both
    packages, so the ring's log-sum-exp merge adds nothing."""
    import jax.numpy as jnp

    b, sq, sk, h, h_kv, d, causal, q_off, k_off, window, bq, bk = \
        CASES["future"]
    q, k, v, _ = _inputs(0, b, sq, sk, h, h_kv, d)
    jout, jlse = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, bq, bk, True,
        q_offset=q_off, k_offset=k_off, window=window)
    out, lse = tfa._flash_forward(*_t(q, k, v), causal, q_offset=q_off,
                                  k_offset=k_off, window=window)
    neg_big = np.float32(-1e30)
    assert not out.any() and not np.asarray(jout).any()
    assert (lse.numpy() == neg_big).all()
    assert (np.asarray(jlse) == neg_big).all()


# (b, s, h, h_kv, d, causal, window): self-attention, as flash_attention
AUTOGRAD_CASES = {
    "mha": (2, 32, 4, 4, 16, True, None),
    "gqa": (2, 32, 4, 2, 32, True, None),
    "window": (1, 64, 4, 2, 16, True, 20),
    "non_causal": (2, 24, 4, 2, 16, False, None),
}


@pytest.mark.parametrize("case", sorted(AUTOGRAD_CASES))
def test_autograd_matches_jax_grad(jax_flash, case):
    """``flash_attention``'s gradients (the autograd wrapper) against
    ``jax.grad`` of the JAX ``flash_attention`` (its custom_vjp), for the
    loss sum(out * w) with a random cotangent w."""
    import jax
    import jax.numpy as jnp

    b, s, h, h_kv, d, causal, window = AUTOGRAD_CASES[case]
    q, k, v, w = _inputs(sorted(AUTOGRAD_CASES).index(case) + 20, b, s, s,
                         h, h_kv, d)

    def jloss(q, k, v):
        return jnp.sum(jax_flash.flash_attention(
            q, k, v, causal=causal, window=window) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(w)).sum().backward()
    for name, g, wg in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                           want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL,
                                   err_msg=name)


def test_autograd_through_strided_views():
    """The model's q/k/v are ``unbind`` views of one projection: gradients
    flow back to the fused tensor."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 16, 3, 4, 16, generator=g, requires_grad=True)
    q, k, v = qkv.unbind(2)
    tfa.flash_attention(q, k, v).square().sum().backward()
    ref = qkv.detach().clone().requires_grad_()
    rq, rk, rv = ref.unbind(2)
    out, _ = tfa._flash_forward_plain(rq, rk, rv, True)
    out.square().sum().backward()
    torch.testing.assert_close(qkv.grad, ref.grad, **TOL)


def test_attention_fn_validation():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="requires causal=True"):
        tfa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="window >= 1"):
        tfa.flash_attention(q, q, q, window=0)
    attend = tfa.flash_attention_fn(window=4)
    assert attend.factory_window == 4
    assert tfa.flash_attention_fn().factory_window is None
    with pytest.raises(ValueError, match="needs `out`"):
        tfa.flash_block_grads(q, q, q, q, torch.zeros(1, 4, 8), None,
                              causal=True)


def test_cpu_backward_launches_no_kernel():
    before = (tfa.FLASH_FORWARD.launches, tfa.FLASH_BWD_DQ.launches,
              tfa.FLASH_BWD_DKV.launches)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    tfa.flash_attention(q, q, q).sum().backward()
    assert (tfa.FLASH_FORWARD.launches, tfa.FLASH_BWD_DQ.launches,
            tfa.FLASH_BWD_DKV.launches) == before


# ---- on the card: kernels K3 and K4 against their plain versions ---------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K3/K4 have no CPU mode)")
    return torch.device("cuda")


def _bf16_close(got, want, name):
    """bf16: each element within 1e-2·max|plain| + 2e-2·|plain| — dS and P
    are rounded to bf16 at the same points in both, but the products sum
    in other orders, so an element may land one bf16 ulp away."""
    got, want = got.float(), want.float()
    lim = 1e-2 * want.abs().max() + 2e-2 * want.abs()
    diff = (got - want).abs()
    # an exact match is within any limit (all-zero gradients have lim 0)
    ratio = torch.where(diff == 0, 0.0, diff / lim).max().item()
    assert ratio <= 1.0, f"{name}: worst error/limit ratio {ratio}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain(cuda_device, dtype, case):
    b, sq, sk, h, h_kv, d, causal, q_off, k_off, window, _, _ = CASES[case]
    q, k, v, do = (torch.from_numpy(x).to(cuda_device, dtype)
                   for x in _inputs(5, b, sq, sk, h, h_kv, d))
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off, window=window)
    out, lse = tfa._flash_forward_plain(q, k, v, **kw)
    before = (tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DKV.launches)
    got = tfa.flash_block_grads(q, k, v, do, lse, None, out=out, **kw)
    want = tfa.flash_block_grads_plain(q, k, v, do, lse, None, out=out, **kw)
    dq, delta = tfa._flash_bwd_dq(q, k, v, do, out, lse, **kw)
    torch.cuda.synchronize()
    assert (tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DKV.launches) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(delta, tfa.flash_delta(out, do), atol=1e-3,
                               rtol=1e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == torch.float32:
            # exact FMAs on both sides; sums in other orders
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4,
                                       msg=name)
        else:
            _bf16_close(g, w, name)


@pytest.mark.cuda
def test_kernels_take_strided_views_and_autograd(cuda_device):
    """The training call: q/k/v as ``unbind`` views, gradients through the
    autograd wrapper (K1, then K3 and K4) against the plain path's."""
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 100, 3, 4, 64, generator=g).to(cuda_device)
    w = torch.randn(2, 100, 4, 64, generator=g).to(cuda_device)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        x = qkv.detach().to(dev).requires_grad_()
        q, k, v = x.unbind(2)
        (tfa.flash_attention(q, k, v) * w.to(dev)).sum().backward()
        grads.append(x.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_explicit_delta_kernel_matches_plain(cuda_device):
    """K8 (dQ from a given Δ) then K4, against the plain explicit-Δ route
    at every case, in f32 and bf16; fed the Δ that K3 writes, K8 gives
    K3's dQ bit for bit."""
    for dtype, case in ((dt, c) for dt in (torch.float32, torch.bfloat16)
                        for c in sorted(CASES)):
        b, sq, sk, h, h_kv, d, causal, q_off, k_off, window, _, _ = \
            CASES[case]
        q, k, v, do = (torch.from_numpy(x).to(cuda_device, dtype)
                       for x in _inputs(6, b, sq, sk, h, h_kv, d))
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off,
                  window=window)
        stats = dict(kw, k_offset=q_off) if case in DIAGONAL_STATS else kw
        out, lse = tfa._flash_forward_plain(q, k, v, **stats)
        delta = tfa.flash_delta(out, do)
        before = (tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DQ_DELTA.launches,
                  tfa.FLASH_BWD_DKV.launches)
        got = tfa.flash_block_grads(q, k, v, do, lse, delta, **kw)
        want = tfa.flash_block_grads_plain(q, k, v, do, lse, delta, **kw)
        dq3, delta3 = tfa._flash_bwd_dq(q, k, v, do, out, lse, **kw)
        dq8 = tfa._flash_bwd_dq_delta(q, k, v, do, lse, delta3, **kw)
        torch.cuda.synchronize()
        assert (tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DQ_DELTA.launches,
                tfa.FLASH_BWD_DKV.launches) == (before[0] + 1, before[1] + 2,
                                                before[2] + 1), case
        assert torch.equal(dq8, dq3), case
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if case in DIAGONAL_STATS:
                assert not g.any(), (case, name)
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4,
                                           msg=f"{case} {name}")
            else:
                _bf16_close(g, w, f"{case} {name}")


# ---- the split planner (no card needed) ------------------------------------

# (sq, sk, h, h_kv, d, causal, q_offset, k_offset, window, steps): steps is
# the longest walk a split CTA may take (32 in the kernels' own plan)
PLAN_CASES = {
    "causal": (1000, 1000, 8, 2, 64, True, 0, 0, None, 3),
    "causal_d128": (1000, 1000, 8, 2, 128, True, 0, 0, None, 5),
    "window": (1000, 1000, 8, 2, 64, True, 0, 0, 150, 2),
    "window_1": (300, 300, 4, 4, 32, True, 0, 0, 1, 1),
    "ring_diagonal": (512, 512, 8, 2, 64, True, 512, 512, None, 2),
    "ring_live": (512, 512, 8, 2, 64, True, 1024, 0, None, 3),
    "ring_masked": (512, 512, 8, 2, 64, True, 0, 512, None, 2),
    "window_offsets": (512, 512, 8, 2, 64, True, 1024, 512, 300, 2),
    "ragged": (200, 130, 4, 2, 16, True, 70, 0, None, 2),
    "non_causal": (130, 700, 4, 1, 64, False, 0, 0, None, 4),
    "prefill_offset": (100, 4096, 8, 2, 64, True, 3996, 0, None, 7),
    "train_seq": (2048, 2048, 8, 2, 64, True, 0, 0, None, 32),
}
SM_COUNT = 132   # an H100's


def _split_steps(n, split, chunk):
    """The steps of an ``n``-step walk that split ``split`` takes: the
    kernels' ``[split·chunk, (split+1)·chunk)`` cut at ``n``."""
    return range(min(n, split * chunk), min(n, (split + 1) * chunk))


def _live_tiles(sq, sk, causal, q_offset, k_offset, window, q_rows):
    """``[q-tiles, key tiles]`` booleans: whether a tile of ``q_rows``
    queries and 64 keys holds a visible (query, key) pair, by brute force
    over the mask."""
    keep = np.ones((sq, sk), bool)
    if causal:
        qp = q_offset + np.arange(sq)[:, None]
        kp = k_offset + np.arange(sk)[None, :]
        keep = kp <= qp
        if window:
            keep &= qp - kp < window
    nq, nk = -(-sq // q_rows), -(-sk // 64)
    pad = np.zeros((nq * q_rows, nk * 64), bool)
    pad[:sq, :sk] = keep
    return pad.reshape(nq, q_rows, nk, 64).any(axis=(1, 3))


def _plan_of(case, steps=None):
    sq, sk, h, h_kv, d, causal, q_off, k_off, window, st = PLAN_CASES[case]
    return tfa._bwd_plan(1, sq, sk, h, h_kv, d, causal=causal,
                         q_offset=q_off, k_offset=k_off, window=window,
                         sm_count=SM_COUNT, steps=steps or st)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_covers_every_live_tile_once(case):
    """Every live (q-tile, key tile) pair is walked by exactly one split of
    K3/K8's plan, and every live (key tile, q-tile, group member) by
    exactly one split of K4's; no split walks past the tensors or takes
    more than the plan's chunk, and no CTA more than ``steps`` once the
    walk is split."""
    sq, sk, h, h_kv, d, causal, q_off, k_off, window, steps = \
        PLAN_CASES[case]
    plan = _plan_of(case)
    eff_window = window if causal else None
    group, bq = h // h_kv, tfa._bwd_bq(d)
    for splits, chunk in ((plan.dq_splits, plan.dq_chunk),
                          (plan.dkv_splits, plan.dkv_chunk)):
        assert splits >= 1 and chunk >= 1
        if splits > 1:
            assert chunk <= steps

    live = _live_tiles(sq, sk, causal, q_off, k_off, eff_window, 64)
    walks = tfa._dq_walks(sq, sk, q_off, k_off, causal, eff_window)
    assert len(walks) == live.shape[0]
    for qi, (lo, n) in enumerate(walks):
        seen = []
        for s in range(plan.dq_splits):
            seen += [(lo + i * 64) // 64 for i in
                     _split_steps(n, s, plan.dq_chunk)]
        assert len(seen) == len(set(seen)) == n, (qi, seen)
        assert all(0 <= t < live.shape[1] for t in seen), (qi, seen)
        assert set(np.flatnonzero(live[qi])) <= set(seen), (qi, seen)

    live = _live_tiles(sq, sk, causal, q_off, k_off, eff_window, bq)
    walks = tfa._dkv_walks(sq, sk, d, q_off, k_off, causal, eff_window)
    assert len(walks) == live.shape[1]
    for ki, (lo, n) in enumerate(walks):
        seen = []
        for s in range(plan.dkv_splits):
            seen += [((lo // bq) + i // group, i % group) for i in
                     _split_steps(n * group, s, plan.dkv_chunk)]
        assert len(seen) == len(set(seen)) == n * group, (ki, seen)
        assert all(0 <= t < live.shape[0] for t, _ in seen), (ki, seen)
        want = {(t, m) for t in np.flatnonzero(live[:, ki])
                for m in range(group)}
        assert want <= set(seen), (ki, seen)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_k3_and_k8_take_one_plan(case):
    """K3 and K8 read the same (splits, chunk), so K8 fed K3's Δ sums dQ
    in K3's order; K4 reads its own.  The plan depends on the shape, the
    offsets and the window alone: a non-causal call ignores the window."""
    plan = _plan_of(case)
    k3 = tfa._launch_split(tfa.FLASH_BWD_DQ, plan)
    assert k3 == tfa._launch_split(tfa.FLASH_BWD_DQ_DELTA, plan) == (
        plan.dq_splits, plan.dq_chunk)
    assert tfa._launch_split(tfa.FLASH_BWD_DKV, plan) == (
        plan.dkv_splits, plan.dkv_chunk)
    sq, sk, h, h_kv, d, causal, q_off, k_off, window, steps = \
        PLAN_CASES[case]
    if not causal:
        assert plan == tfa._bwd_plan(
            1, sq, sk, h, h_kv, d, causal=False, q_offset=q_off,
            k_offset=k_off, window=77, sm_count=SM_COUNT, steps=steps)


def test_plan_splits_only_walks_that_set_the_pace():
    """The kernels' own plan at the main path's shapes.  train_sp's (B=1,
    S=8192): K4's 256 key tiles are fewer than the card holds at once and
    the first walks 512 steps, so it splits in 16 and no CTA walks more
    than 32; K8's 1,024 q-tiles run longest first in 2.6 waves, so it
    stays whole.  The training shape (B=8, S=2048) and a 512 window keep
    both whole; a fully masked block has nothing to split."""
    kw = dict(causal=True, q_offset=0, k_offset=0, window=None,
              sm_count=SM_COUNT)
    sp = tfa._bwd_plan(1, 8192, 8192, 8, 2, 64, **kw)
    assert (sp.dq_splits, sp.dkv_splits, sp.dkv_chunk) == (1, 16, 32)
    for window in (None, 512):
        train = tfa._bwd_plan(8, 2048, 2048, 8, 2, 64,
                              **dict(kw, window=window))
        assert (train.dq_splits, train.dkv_splits) == (1, 1), window
    masked = tfa._bwd_plan(1, 2048, 2048, 8, 2, 64,
                           **dict(kw, k_offset=2048))
    assert (masked.dq_splits, masked.dkv_splits) == (1, 1)
    # a smaller grid splits both: 2 heads at S=4096
    small = tfa._bwd_plan(1, 4096, 4096, 2, 1, 64, **kw)
    assert (small.dq_splits, small.dkv_splits) == (2, 4)


# (b, s, h, h_kv, d, causal, q_offset, k_offset, window, steps)
SPLIT_CASES = {
    "causal": (1, 256, 4, 2, 16, True, 0, 0, None, 2),
    "window": (1, 256, 4, 2, 16, True, 0, 0, 72, 1),
    "offsets": (1, 256, 4, 2, 32, True, 128, 64, None, 2),
    "window_offsets": (1, 192, 4, 2, 16, True, 256, 64, 100, 1),
    "non_causal": (1, 192, 4, 2, 16, False, 0, 0, None, 2),
}


def _split_sum_plain(q, k, v, do, lse, delta, plan, *, causal, q_offset,
                     k_offset, window):
    """dQ, dK, dV as the split kernels sum them, from the plain versions:
    each split's partial over its key slice (dQ) or its (q-tile, group
    member) steps (dK, dV) at the slice's offsets, the partials added in
    split order."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    group, bq = h // h_kv, tfa._bwd_bq(d)
    eff_window = window if causal else None
    kw = dict(causal=causal, window=eff_window)
    dq = torch.zeros(q.shape)
    for qi, (lo, n) in enumerate(tfa._dq_walks(sq, sk, q_offset, k_offset,
                                               causal, eff_window)):
        rows = slice(qi * 64, qi * 64 + 64)
        for s in range(plan.dq_splits):
            st = _split_steps(n, s, plan.dq_chunk)
            if not st:
                continue
            ks, ke = lo + st.start * 64, min(sk, lo + st.stop * 64)
            part, _ = tfa._flash_bwd_dq_plain(
                q[:, rows], k[:, ks:ke], v[:, ks:ke], do[:, rows], None,
                lse[:, :, rows], delta=delta[:, :, rows],
                q_offset=q_offset + qi * 64, k_offset=k_offset + ks, **kw)
            dq[:, rows] += part
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for ki, (lo, n) in enumerate(tfa._dkv_walks(sq, sk, d, q_offset,
                                                k_offset, causal,
                                                eff_window)):
        keys = slice(ki * 64, ki * 64 + 64)
        for hk in range(h_kv):
            for s in range(plan.dkv_splits):
                pk = torch.zeros_like(dk[:, keys, hk:hk + 1])
                pv = torch.zeros_like(pk)
                for i in _split_steps(n * group, s, plan.dkv_chunk):
                    qt, hq = lo + (i // group) * bq, hk * group + i % group
                    qs, hs = slice(qt, qt + bq), slice(hq, hq + 1)
                    gk, gv = tfa._flash_bwd_dkv_plain(
                        q[:, qs, hs], k[:, keys, hk:hk + 1],
                        v[:, keys, hk:hk + 1], do[:, qs, hs],
                        lse[:, hs, qs], delta[:, hs, qs],
                        q_offset=q_offset + qt, k_offset=k_offset + ki * 64,
                        **kw)
                    pk, pv = pk + gk, pv + gv
                dk[:, keys, hk:hk + 1] += pk
                dv[:, keys, hk:hk + 1] += pv
    return dq, dk, dv


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_sums_match_unsplit_and_jax(jax_flash, case):
    """The split's offset and window arithmetic, on the CPU: the plain
    versions over each split's slice, summed in split order, match the
    unsplit plain result and the JAX ``flash_block_grads`` within TOL."""
    import jax.numpy as jnp

    b, s, h, h_kv, d, causal, q_off, k_off, window, steps = \
        SPLIT_CASES[case]
    q, k, v, do = _inputs(sorted(SPLIT_CASES).index(case) + 40, b, s, s, h,
                          h_kv, d)
    # the queries' statistics over their own diagonal block, as a ring's
    out, lse = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64, 64, True,
        q_offset=q_off, k_offset=q_off, window=window)
    delta = jax_flash.flash_delta(out, jnp.asarray(do))
    want = jax_flash.flash_block_grads(
        *(jnp.asarray(x) for x in (q, k, v, do, lse)), delta, causal=causal,
        block_q=64, block_k=64, interpret=True, q_offset=q_off,
        k_offset=k_off, window=window)
    plan = tfa._bwd_plan(b, s, s, h, h_kv, d, causal=causal, q_offset=q_off,
                         k_offset=k_off, window=window, sm_count=SM_COUNT,
                         steps=steps)
    assert plan.dq_splits > 1 or plan.dkv_splits > 1, plan
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off, window=window)
    tq, tk, tv, tdo, tlse, tdelta = _t(q, k, v, do, lse, delta)
    got = _split_sum_plain(tq, tk, tv, tdo, tlse, tdelta, plan, **kw)
    whole = tfa.flash_block_grads_plain(tq, tk, tv, tdo, tlse, tdelta, **kw)
    for name, g, u, w in zip(("dq", "dk", "dv"), got, whole, want):
        np.testing.assert_allclose(g.numpy(), u.numpy(), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


# ---- on the card: split and unsplit shapes, repeatability ----------------

# (b, s, h, h_kv, d, dtype, K3/K8 split?, K4 split?) at the kernels' own
# plan on an H100 (132 SMs)
CARD_SPLIT_CASES = {
    "split_bf16": (1, 4096, 2, 1, 64, torch.bfloat16, True, True),
    "split_f32": (1, 4096, 2, 1, 64, torch.float32, True, True),
    "split_d128": (1, 4096, 4, 2, 128, torch.bfloat16, True, True),
    "unsplit_bf16": (4, 512, 8, 2, 64, torch.bfloat16, False, False),
    "ragged_d128_bf16": (2, 300, 4, 2, 128, torch.bfloat16, False, False),
    "ragged_d128_f32": (2, 300, 4, 2, 128, torch.float32, False, False),
}


def _card_case(device, case, seed):
    b, s, h, h_kv, d, dtype, _, _ = CARD_SPLIT_CASES[case]
    q, k, v, do = (torch.from_numpy(x).to(device, dtype)
                   for x in _inputs(seed, b, s, s, h, h_kv, d))
    out, lse = tfa._flash_forward(q, k, v, True)
    return q, k, v, do, out, lse


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_SPLIT_CASES))
def test_kernels_match_plain_split_and_unsplit(cuda_device, case):
    """K3 (dQ, Δ), K8 and K4 against the plain versions where the planner
    splits the walks (B=1, S=4096) and where it does not; two calls give
    the same bits; K8 fed K3's Δ gives K3's dQ bit for bit."""
    b, s, h, h_kv, d, dtype, dq_split, dkv_split = CARD_SPLIT_CASES[case]
    plan = tfa._bwd_plan(b, s, s, h, h_kv, d, causal=True, q_offset=0,
                         k_offset=0, window=None,
                         sm_count=tfa._sm_count(cuda_device.index or 0))
    assert (plan.dq_splits > 1, plan.dkv_splits > 1) == (dq_split,
                                                         dkv_split), plan
    q, k, v, do, out, lse = _card_case(cuda_device, case, 7)
    kw = dict(causal=True)
    dq, delta = tfa._flash_bwd_dq(q, k, v, do, out, lse, **kw)
    dq8 = tfa._flash_bwd_dq_delta(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa._flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    pdq, pdelta = tfa._flash_bwd_dq_plain(q, k, v, do, out, lse, **kw)
    pdk, pdv = tfa._flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    again = (tfa._flash_bwd_dq(q, k, v, do, out, lse, **kw)
             + tfa._flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, pdelta, atol=1e-3, rtol=1e-5)
    assert torch.equal(dq8, dq)
    for name, first, second in zip(("dq", "delta", "dk", "dv"),
                                   (dq, delta, dk, dv), again):
        assert torch.equal(first, second), name
    for name, g, w in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4, msg=name)
        else:
            _bf16_close(g, w, f"{case} {name}")


@pytest.mark.cuda
def test_split_kernels_on_ring_blocks(cuda_device):
    """K8 and K4 at a split shape on a ring's blocks: fully live (offsets
    4096, 0) against the plain versions, fully masked (0, 4096) exact
    zeros."""
    q, k, v, do, out, lse = _card_case(cuda_device, "split_bf16", 8)
    delta = tfa.flash_delta(out, do)
    for q_off, k_off in ((4096, 0), (0, 4096)):
        kw = dict(causal=True, q_offset=q_off, k_offset=k_off)
        dq = tfa._flash_bwd_dq_delta(q, k, v, do, lse, delta, **kw)
        dk, dv = tfa._flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        if q_off < k_off:
            assert not dq.any() and not dk.any() and not dv.any()
            continue
        pdq, _ = tfa._flash_bwd_dq_plain(q, k, v, do, None, lse,
                                         delta=delta, **kw)
        pdk, pdv = tfa._flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
        for name, g, w in (("dq", dq, pdq), ("dk", dk, pdk),
                           ("dv", dv, pdv)):
            _bf16_close(g, w, f"fully live {name}")
