"""tpudist_torch's flash decode against the JAX package's.

On the CPU the port runs its plain version; the JAX side runs the Pallas
decode kernel in interpret mode.  Same seeded numpy inputs into both.

Tolerance (f32): atol = rtol = 2e-5 — both sides compute in f32 and
differ only in summation order (the Pallas kernel walks the cache in
blocks with an online softmax, the plain version reduces in one pass).

The ``cuda`` tests hold kernel K2 against the plain version on the card.
The JAX package is imported inside a fixture, so on a card host without
JAX and flax the ``cuda`` tests still run (the parity tests skip there).
"""

import numpy as np
import pytest
import torch

from tpudist_torch.ops import flash_decode as tfd

TOL = dict(atol=2e-5, rtol=2e-5)
B, S, H, D, CAP = 3, 96, 4, 16, 8


def _inputs(seed, h_kv, s_q=1, packed=True):
    rng = np.random.default_rng(seed)
    shape = (B, S, h_kv * D) if packed else (B, S, h_kv, D)
    side_shape = (B, CAP) + shape[2:]
    return dict(
        q=rng.standard_normal((B, s_q, H, D), np.float32),
        k=rng.standard_normal(shape, np.float32),
        v=rng.standard_normal(shape, np.float32),
        side_k=rng.standard_normal(side_shape, np.float32),
        side_v=rng.standard_normal(side_shape, np.float32))


ROW_LENS = np.array([96, 41, 1], np.int32)

# name: (h_kv, packed, cache_len, kwargs)
CASES = {
    "scalar_4d_mha": (4, False, 70, {}),
    "scalar_packed_gqa": (2, True, 57, {}),
    "per_row_packed_gqa": (2, True, ROW_LENS, {}),
    "per_row_4d": (2, False, ROW_LENS, {}),
    "side_len_0": (2, True, ROW_LENS, {"side": 0}),
    "side_len_5": (2, True, ROW_LENS, {"side": 5}),
    "window": (2, True, 80, {"window": 24}),
    "lse_scalar": (1, True, 33, {"return_lse": True}),
    "lse_per_row_side": (2, True, ROW_LENS, {"side": 3, "return_lse": True}),
}


def _call(fn, to, x, h_kv, packed, cache_len, kw, s_q_side=None):
    side = kw.get("side")
    args = dict(window=kw.get("window"), return_lse=kw.get("return_lse",
                                                             False),
                packed_kv_heads=h_kv if packed else None)
    if side is not None:
        args.update(side_k=to(x["side_k"]), side_v=to(x["side_v"]),
                    side_len=side)
    return fn(to(x["q"]), to(x["k"]), to(x["v"]), to(cache_len), **args)


@pytest.fixture(scope="module")
def jax_flash_decode():
    """The JAX package's ``flash_decode`` (Pallas, interpret mode here)."""
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    from tpudist.ops.flash_decode import flash_decode
    return flash_decode


def _jax(x):
    import jax.numpy as jnp

    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _torch(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_flash_decode(jax_flash_decode, case):
    h_kv, packed, cache_len, kw = CASES[case]
    x = _inputs(sorted(CASES).index(case), h_kv, packed=packed)
    want = _call(lambda *a, **k: jax_flash_decode(*a, interpret=True, **k),
                 _jax, x, h_kv, packed, cache_len, kw)
    got = _call(tfd.flash_decode, _torch, x, h_kv, packed, cache_len, kw)
    if kw.get("return_lse"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_multi_query_with_side_buffer(jax_flash_decode):
    """s_q = 3 (the speculative verify chunk): query j sees side positions
    below side_len - (2 - j)."""
    import jax.numpy as jnp

    x = _inputs(11, 2, s_q=3)
    want = jax_flash_decode(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(ROW_LENS), interpret=True, side_k=jnp.asarray(x["side_k"]),
        side_v=jnp.asarray(x["side_v"]), side_len=6, packed_kv_heads=2)
    got = tfd.flash_decode(
        torch.from_numpy(x["q"]), torch.from_numpy(x["k"]),
        torch.from_numpy(x["v"]), torch.from_numpy(ROW_LENS),
        side_k=torch.from_numpy(x["side_k"]),
        side_v=torch.from_numpy(x["side_v"]),
        side_len=torch.tensor(6), packed_kv_heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_contract_errors_match_jax():
    x = {k: torch.from_numpy(v) for k, v in _inputs(0, 2).items()}
    lens = torch.from_numpy(ROW_LENS)
    with pytest.raises(ValueError, match="per-row"):
        tfd.flash_decode(x["q"], x["k"], x["v"], lens, window=4,
                         packed_kv_heads=2)
    with pytest.raises(ValueError, match="side buffers require"):
        tfd.flash_decode(x["q"], x["k"], x["v"], 5, side_k=x["side_k"],
                         side_v=x["side_v"], side_len=1, packed_kv_heads=2)
    with pytest.raises(ValueError, match="packed_kv_heads"):
        tfd.flash_decode(x["q"], x["k"], x["v"], 5)


# ---- on the card: kernel K2 against its plain version --------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K2 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda_device, dtype, case):
    h_kv, packed, cache_len, kw = CASES[case]
    x = _inputs(5, h_kv, packed=packed)

    def to(a):
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(a).to(cuda_device)
            return t if a.dtype == np.int32 else t.to(dtype)
        return a

    before = tfd.FLASH_DECODE.launches
    got = _call(tfd.flash_decode, to, x, h_kv, packed, cache_len, kw)
    want = _call(tfd.flash_decode_plain, to, x, h_kv, packed, cache_len, kw)
    torch.cuda.synchronize()
    assert tfd.FLASH_DECODE.launches == before + 1
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    if kw.get("return_lse"):
        torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)
        got, want = got[0], want[0]
    torch.testing.assert_close(got.float(), want.float(), **tol)
