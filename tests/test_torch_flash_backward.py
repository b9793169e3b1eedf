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

The ``cuda`` tests hold kernels K3 and K4 against the plain versions on
the card.  The JAX package is imported inside a fixture, so on a card host
without flax they still run (the parity tests skip there).
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
}


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
    """The case's inputs and the JAX forward's (out, lse), as numpy."""
    import jax.numpy as jnp

    b, sq, sk, h, h_kv, d, causal, q_off, k_off, window, bq, bk = CASES[case]
    q, k, v, do = _inputs(sorted(CASES).index(case), b, sq, sk, h, h_kv, d)
    out, lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, bq, bk, True,
        q_offset=q_off, k_offset=k_off, window=window)
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
    ratio = ((got - want).abs() / lim).max().item()
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
def test_explicit_delta_raises_on_cuda(cuda_device):
    q = torch.randn(1, 8, 2, 16, device=cuda_device)
    lse = torch.zeros(1, 2, 8, device=cuda_device)
    with pytest.raises(NotImplementedError, match="ring"):
        tfa.flash_block_grads(q, q, q, q, lse, lse, causal=True)
