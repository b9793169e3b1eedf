"""tpudist_torch's flash-attention forward against the JAX package's.

On the CPU the port runs its plain version; the JAX side runs the Pallas
kernel in interpret mode.  Same inputs (numpy, seeded) into both.

Tolerance (f32): atol = rtol = 2e-5.  Both sides compute in f32; the
Pallas kernel sums the online softmax block by block while the plain
version reduces each row in one pass, so results differ by a few ulp of
the O(1) outputs and LSEs.

K1 splits a long key walk over CTAs and merges the splits' partials in
split order (``_fwd_plan``); its plain counterpart for that is
``_flash_forward_split_plain``, held here against the JAX kernel under
several plans, and shown to give a query row the same bits whatever
prefill chunk the row arrives in.

The ``cuda`` tests hold kernel K1 against the plain versions on the card.
The JAX package is imported inside a fixture, so on a card host without
JAX and flax the ``cuda`` tests still run (the parity tests skip there).
"""

import inspect

import numpy as np
import pytest
import torch

from tpudist_torch.ops import flash_attention as tfa

TOL = dict(atol=2e-5, rtol=2e-5)
# the planner's tests read an H100's SM count
SM_COUNT = 132
# bf16 on the card: P is rounded to bf16 before P·V in kernel and plain
# version alike, but sums run in other orders; 2e-2 is ~4 bf16 ulps of the
# O(1) outputs
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _inputs(seed, b, sq, sk, h, h_kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, h_kv, d), np.float32)
    v = rng.standard_normal((b, sk, h_kv, d), np.float32)
    return q, k, v


# (b, sq, sk, h, h_kv, d, causal, q_offset, window, jax block_q, block_k)
CASES = {
    "mha": (2, 32, 32, 4, 4, 16, True, 0, None, 16, 16),
    "gqa": (2, 32, 32, 4, 2, 32, True, 0, None, 16, 16),
    "prefill_offset": (1, 16, 64, 4, 2, 16, True, 40, None, 16, 16),
    "window": (1, 64, 64, 4, 2, 16, True, 0, 20, 16, 16),
    "window_offset": (1, 16, 64, 4, 2, 16, True, 40, 12, 16, 16),
    "non_causal": (2, 24, 40, 4, 2, 16, False, 0, None, 8, 8),
    "ragged": (1, 37, 100, 4, 2, 16, True, 63, None, 37, 100),
}


@pytest.fixture(scope="module")
def jax_flash_forward():
    """The JAX package's ``_flash_forward`` (Pallas, interpret mode here)."""
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    from tpudist.ops.flash_attention import _flash_forward
    return _flash_forward


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_flash_forward(jax_flash_forward, case):
    import jax.numpy as jnp

    b, sq, sk, h, h_kv, d, causal, q_off, window, bq, bk = CASES[case]
    q, k, v = _inputs(sorted(CASES).index(case), b, sq, sk, h, h_kv, d)
    want_o, want_l = jax_flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, bq, bk, True,
        q_offset=q_off, window=window)
    got_o, got_l = tfa._flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, q_offset=q_off, window=window)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


def test_tensor_offset_matches_int_offset():
    """The chunked prefill passes the cache index as a 0-D tensor."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(9, 1, 8, 48, 4, 2, 16))
    a = tfa._flash_forward(q, k, v, True, q_offset=30)
    b = tfa._flash_forward(q, k, v, True,
                           q_offset=torch.tensor(30, dtype=torch.int32))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_fully_masked_row_is_zero():
    """A query with no visible key (q_offset below k_offset) gets exact
    zeros and an LSE of about -1e30, as the Pallas kernel's -1e30 floor
    gives."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 4, 8, 2, 2, 16))
    o, lse = tfa._flash_forward(q, k, v, True, q_offset=0, k_offset=10)
    assert torch.all(o == 0)
    assert torch.all(lse < -1e29)


# (b, sq, sk, h, h_kv, d, causal, q_offset, k_offset, window,
#  plan (splits, chunk of 64-key tiles), offsets as 0-D tensors)
SPLIT_CASES = {
    "one_split": (1, 32, 128, 4, 2, 16, True, 64, 0, None, (1, 2), False),
    "many_splits_gqa": (2, 32, 256, 4, 2, 32, True, 200, 0, None, (4, 1),
                        False),
    "window_band_across_splits": (1, 64, 256, 4, 2, 16, True, 150, 0, 100,
                                  (4, 1), True),
    "tensor_offsets": (1, 32, 256, 4, 4, 16, True, 100, 30, None, (2, 2),
                       True),
    "dead_rows": (1, 64, 256, 4, 2, 16, True, 0, 40, None, (4, 1), False),
    "non_causal": (2, 32, 192, 4, 2, 16, False, 0, 0, None, (3, 1), False),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_plain_matches_jax_flash_forward(jax_flash_forward, case):
    """K1's split walk and merge as plain PyTorch against the JAX kernel
    (interpret mode), f32, within TOL: one split, several, a window band
    that crosses split boundaries, 0-D tensor offsets, and rows whose
    splits are all empty (O = 0, LSE = -1e30)."""
    import jax.numpy as jnp

    b, sq, sk, h, h_kv, d, causal, q_off, k_off, window, plan, as_t = \
        SPLIT_CASES[case]
    q, k, v = _inputs(sorted(SPLIT_CASES).index(case) + 20, b, sq, sk, h,
                      h_kv, d)
    want_o, want_l = jax_flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 32, 64, True,
        q_offset=q_off, k_offset=k_off, window=window)
    off = (lambda x: torch.tensor(x, dtype=torch.int32)) if as_t else int
    got_o, got_l = tfa._flash_forward_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, q_offset=off(q_off), k_offset=off(k_off), window=window,
        plan=tfa.FwdPlan(*plan))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    if case == "dead_rows":   # queries 0..39 see no key: exact O and LSE
        assert torch.all(got_o[:, :k_off] == 0)
        assert torch.all(got_l[:, :, :k_off] == tfa._NEG_BIG)
        assert torch.all(got_l[:, :, k_off:] > -100)


def test_fwd_plan_is_pure_and_blind_to_query_length_and_offsets():
    """``_fwd_plan`` is a pure function of (B, Sk, H, causal, window, SM
    count) — it takes no query length and no offsets — so the
    plan a call gets does not change with Sq, q_offset or k_offset.  At
    the main path's shapes on an H100: a serve prefill over the 8k cache
    and train_sp (B=1, 8 heads, Sk = 8192) split the walk in 4 of 32
    tiles; the training shape, a 512 window and a ring block do not."""
    params = set(inspect.signature(tfa._fwd_plan).parameters)
    assert not params & {"sq", "q_offset", "k_offset"}, params
    assert not set(inspect.signature(tfa._fwd_plan_for).parameters) & {
        "q_offset", "k_offset"}
    k = torch.zeros(1, 8192, 2, 64)
    plans = {tfa._fwd_plan_for(torch.zeros(1, sq, 8, 64), k, causal=True,
                               sm_count=SM_COUNT)
             for sq in (1, 37, 512, 1024, 8192)}
    assert plans == {tfa.FwdPlan(4, 32)}, plans
    kw = dict(causal=True, window=0, sm_count=SM_COUNT)
    assert tfa._fwd_plan(1, 8192, 8, **kw) == tfa._fwd_plan(
        1, 8192, 8, **kw) == tfa.FwdPlan(4, 32)
    for args in ((8, 2048, 8), (1, 2048, 8), (4, 2048, 8)):
        assert tfa._fwd_plan(*args, **kw).splits == 1, args
    assert tfa._fwd_plan(8, 2048, 8, **dict(kw, window=512)).splits == 1
    # one split takes every tile; splits cover all of Sk in absolute tiles
    for sk, window in ((8192, 0), (8192, 4096), (3000, 0), (100, 0)):
        plan = tfa._fwd_plan(1, sk, 2, causal=True, window=window,
                             sm_count=SM_COUNT)
        assert plan.splits * plan.chunk >= -(-sk // 64), (sk, plan)
        assert (plan.splits - 1) * plan.chunk < -(-sk // 64), (sk, plan)
    # a non-causal call ignores the window
    assert tfa._fwd_plan(1, 8192, 8, causal=False, window=100,
                         sm_count=SM_COUNT) == tfa._fwd_plan(
        1, 8192, 8, causal=False, window=0, sm_count=SM_COUNT)


@pytest.mark.parametrize("plan", [(1, 4), (4, 1), (2, 3)])
def test_split_plain_is_chunk_invariant(plan):
    """A 96-token prompt's rows over a 256-slot cache, prefilled as one
    chunk and as chunks of 40 + 32 + 24 at their offsets (a 0-D tensor,
    as the serve path passes the cache index): every out and LSE row is
    bit-identical, for one split and for several.  (Chunk lengths are
    multiples of 8, so that no chunk leaves PyTorch's vectorised CPU loops
    a scalar tail, whose exp may differ in the last bit.)"""
    q, k, v = (torch.from_numpy(x) for x in _inputs(11, 1, 96, 256, 4, 2,
                                                   16))
    fp = tfa.FwdPlan(*plan)
    whole_o, whole_l = tfa._flash_forward_split_plain(q, k, v, True, plan=fp)
    lo = 0
    for n in (40, 32, 24):
        o, l = tfa._flash_forward_split_plain(
            q[:, lo:lo + n], k, v, True,
            q_offset=torch.tensor(lo, dtype=torch.int32), plan=fp)
        assert torch.equal(o, whole_o[:, lo:lo + n]), (plan, lo)
        assert torch.equal(l, whole_l[:, :, lo:lo + n]), (plan, lo)
        lo += n


# ---- on the card: kernel K1 against its plain version --------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda_device, dtype, case):
    b, sq, sk, h, h_kv, d, causal, q_off, window, _, _ = CASES[case]
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in _inputs(1, b, sq, sk, h, h_kv, d))
    before = tfa.FLASH_FORWARD.launches
    got_o, got_l = tfa._flash_forward(q, k, v, causal, q_offset=q_off,
                                      window=window)
    want_o, want_l = tfa._flash_forward_plain(q, k, v, causal,
                                              q_offset=q_off, window=window)
    torch.cuda.synchronize()
    assert tfa.FLASH_FORWARD.launches == before + 1
    # bf16: P is rounded to bf16 before P·V in both, but sums run in other
    # orders; 2e-2 is ~4 bf16 ulps of the O(1) outputs
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got_o.float(), want_o.float(), **tol)
    torch.testing.assert_close(got_l, want_l, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_reads_packed_cache_and_device_offset(cuda_device):
    """The serve path's call: a packed [B, S, Hkv*D] cache viewed as
    [B, S, Hkv, D] (read through strides) and the cache index as a device
    scalar."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 50, 8, 64, generator=g).to(cuda_device, torch.bfloat16)
    kc = torch.randn(1, 200, 128, generator=g).to(cuda_device, torch.bfloat16)
    vc = torch.randn(1, 200, 128, generator=g).to(cuda_device, torch.bfloat16)
    off = torch.tensor(100, dtype=torch.int32, device=cuda_device)
    k4, v4 = kc.view(1, 200, 2, 64), vc.view(1, 200, 2, 64)
    got, _ = tfa._flash_forward(q, k4, v4, True, q_offset=off)
    want, _ = tfa._flash_forward_plain(q, k4, v4, True, q_offset=100)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _card(device, dtype, *arrays):
    return tuple(torch.from_numpy(x).to(device, dtype) for x in arrays)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(),
                               **(TOL if dtype == torch.float32
                                  else BF16_TOL))


def _k1(q, k, v, plan, **kw):
    """Kernel K1 under a given plan (the wrapper takes the planner's)."""
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    tfa._fwd_launch(q, k, v, out, lse, causal=kw.pop("causal", True),
                    q_offset=kw.pop("q_offset", 0),
                    k_offset=kw.pop("k_offset", 0),
                    window=kw.pop("window", None), plan=plan)
    assert not kw
    return out, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_kernel_every_head_dim(cuda_device, dtype, d):
    """Every head dim, GQA, ragged Sq/Sk edges at an offset, one split and
    the card's own plan."""
    q, k, v = _card(cuda_device, dtype, *_inputs(d, 2, 100, 300, 4, 2, d))
    want_o, want_l = tfa._flash_forward_plain(q, k, v, True, q_offset=200)
    for plan in (None, tfa.FwdPlan(3, 2)):
        got_o, got_l = (tfa._flash_forward(q, k, v, True, q_offset=200)
                        if plan is None else
                        _k1(q, k, v, plan, q_offset=200))
        torch.cuda.synchronize()
        _close(got_o, want_o, dtype)
        torch.testing.assert_close(got_l, want_l, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 16])
def test_forced_splits_match_split_plain(cuda_device, dtype, splits):
    """1, 2 and 16 splits of a 16-tile walk, with GQA, a window crossing
    split boundaries and a device offset: K1 against the split plain
    version and the whole plain version; a second call bitwise equal."""
    q, k, v = _card(cuda_device, dtype, *_inputs(5, 1, 200, 1000, 8, 2, 64))
    plan = tfa.FwdPlan(splits, 16 // splits)
    kw = dict(q_offset=torch.tensor(700, dtype=torch.int32,
                                    device=cuda_device), window=300)
    got_o, got_l = _k1(q, k, v, plan, **kw)
    again = _k1(q, k, v, plan, **kw)
    split_o, split_l = tfa._flash_forward_split_plain(q, k, v, True, **kw,
                                                      plan=plan)
    want_o, want_l = tfa._flash_forward_plain(q, k, v, True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_o, again[0]) and torch.equal(got_l, again[1])
    for o, l in ((split_o, split_l), (want_o, want_l)):
        _close(got_o, o, dtype)
        torch.testing.assert_close(got_l, l, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 4])
def test_kernel_packed_cache_window_device_offset(cuda_device, splits):
    """The serve call with a window: a packed [B, S, Hkv*D] cache read
    through strides, the cache index a device scalar."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 50, 8, 64, generator=g).to(cuda_device, torch.bfloat16)
    kc = torch.randn(1, 512, 128, generator=g).to(cuda_device, torch.bfloat16)
    vc = torch.randn(1, 512, 128, generator=g).to(cuda_device, torch.bfloat16)
    k4, v4 = kc.view(1, 512, 2, 64), vc.view(1, 512, 2, 64)
    off = torch.tensor(300, dtype=torch.int32, device=cuda_device)
    got, got_l = _k1(q, k4, v4, tfa.FwdPlan(splits, 8 // splits),
                     q_offset=off, window=200)
    want, want_l = tfa._flash_forward_plain(q, k4, v4, True, q_offset=300,
                                            window=200)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16)
    torch.testing.assert_close(got_l, want_l, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 4])
def test_dead_ring_block(cuda_device, dtype, splits):
    """A ring block wholly in the queries' future: O exactly 0 and LSE
    exactly -1e30, with one split and with four."""
    q, k, v = _card(cuda_device, dtype, *_inputs(6, 1, 256, 256, 8, 2, 64))
    o, lse = _k1(q, k, v, tfa.FwdPlan(splits, 4 // splits), q_offset=0,
                 k_offset=256)
    torch.cuda.synchronize()
    assert not o.any()
    assert torch.all(lse == tfa._NEG_BIG)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("forced", [None, 1])
def test_kernel_chunk_invariance(cuda_device, dtype, forced):
    """A 1,024-token prompt over the serve model's 8k cache (H=8, Hkv=2,
    D=64; the card's plan splits the walk), prefilled as one chunk and as
    chunks of 512 + 300 + 212 at their offsets (a device scalar, as the
    serve path passes the cache index): every out and LSE row is
    bit-identical."""
    q, k, v = _card(cuda_device, dtype, *_inputs(12, 1, 1024, 8192, 8, 2,
                                                 64))
    plan = (tfa._fwd_plan_for(q, k, causal=True) if forced is None
            else tfa.FwdPlan(1, 128))
    assert forced or plan.splits > 1, plan
    whole_o, whole_l = _k1(q, k, v, plan)
    lo = 0
    for n in (512, 300, 212):
        off = torch.tensor(lo, dtype=torch.int32, device=cuda_device)
        o, l = _k1(q[:, lo:lo + n], k, v, plan, q_offset=off)
        torch.cuda.synchronize()
        assert torch.equal(o, whole_o[:, lo:lo + n]), (lo, n)
        assert torch.equal(l, whole_l[:, :, lo:lo + n]), (lo, n)
        lo += n


@pytest.mark.cuda
def test_kernel_paired_heads_change_no_bit(cuda_device):
    """A 4,096-token prompt over the 8k cache as one call (a grid large
    enough that K1 pairs two heads of a GQA group a CTA) and as 8 chunks
    of 512 (one head a CTA): bit-identical rows."""
    q, k, v = _card(cuda_device, torch.bfloat16,
                    *_inputs(13, 1, 4096, 8192, 8, 2, 64))
    plan = tfa._fwd_plan_for(q, k, causal=True)
    whole_o, whole_l = _k1(q, k, v, plan)
    for lo in range(0, 4096, 512):
        off = torch.tensor(lo, dtype=torch.int32, device=cuda_device)
        o, l = _k1(q[:, lo:lo + 512], k, v, plan, q_offset=off)
        torch.cuda.synchronize()
        assert torch.equal(o, whole_o[:, lo:lo + 512]), lo
        assert torch.equal(l, whole_l[:, :, lo:lo + 512]), lo
