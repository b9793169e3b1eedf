"""tpudist_torch's flash-attention forward against the JAX package's.

On the CPU the port runs its plain version; the JAX side runs the Pallas
kernel in interpret mode.  Same inputs (numpy, seeded) into both.

Tolerance (f32): atol = rtol = 2e-5.  Both sides compute in f32; the
Pallas kernel sums the online softmax block by block while the plain
version reduces each row in one pass, so results differ by a few ulp of
the O(1) outputs and LSEs.

The ``cuda`` tests hold kernel K1 against the plain version on the card.
The JAX package is imported inside a fixture, so on a card host without
JAX and flax the ``cuda`` tests still run (the parity tests skip there).
"""

import numpy as np
import pytest
import torch

from tpudist_torch.ops import flash_attention as tfa

TOL = dict(atol=2e-5, rtol=2e-5)


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
