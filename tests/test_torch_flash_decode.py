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


# ---- the split walk: K2's splits and merge in plain PyTorch -----------------

# name: (cache_len, kwargs); at 32-key splits of the 96-key cache,
# lengths one below, at and one past a split boundary, the side buffer, a
# window (one ending on a boundary), and pos_offset with a wholly dead
# slice
SPLIT_CASES = {
    "per_row_boundaries": (np.array([31, 32, 33], np.int32), {}),
    "per_row_boundaries_64": (np.array([63, 64, 65], np.int32), {}),
    "scalar_one_below": (63, {}),
    "scalar_one_past": (65, {}),
    "side": (np.array([33, 96, 1], np.int32),
             {"side": 5, "return_lse": True}),
    "window": (80, {"window": 24}),
    "window_at_boundary": (64, {"window": 33, "return_lse": True}),
    "pos_offset_dead": (40, {"pos_offset": 64, "return_lse": True}),
    "pos_offset_window": (100, {"pos_offset": 32, "window": 20}),
}
GROUPS = {"g1_d16": (1, 16), "g4_d16": (4, 16), "g1_d64": (1, 64),
          "g4_d64": (4, 64)}


def _split_inputs(seed, g, d, s=S):
    """4 query heads over 4 // g KV heads, the cache [B, s, Hkv, D]."""
    rng = np.random.default_rng(seed)
    h_kv = H // g
    t = lambda *shape: rng.standard_normal(shape, np.float32)  # noqa: E731
    return h_kv, dict(q=t(B, 1, H, d), k=t(B, s, h_kv, d),
                      v=t(B, s, h_kv, d), side_k=t(B, CAP, h_kv, d),
                      side_v=t(B, CAP, h_kv, d))


def _at_split(x, ck):
    """A length or position written at 32-key splits, moved to ``ck``-key
    splits: the same distance from its nearest split boundary."""
    if isinstance(x, np.ndarray):
        return np.array([_at_split(int(v), ck) for v in x], np.int32)
    n = round(x / 32)
    return n * ck + x - n * 32


def _case_at_split(case, ck):
    """SPLIT_CASES[case] over a ``3·ck``-key cache at ``ck``-key splits."""
    cache_len, kw = SPLIT_CASES[case]
    return _at_split(cache_len, ck), {
        k: _at_split(v, ck) if k in ("window", "pos_offset") else v
        for k, v in kw.items()}


def _split_call(fn, to, x, cache_len, kw, **extra):
    args = dict(window=kw.get("window"),
                return_lse=kw.get("return_lse", False),
                pos_offset=kw.get("pos_offset", 0), **extra)
    if "side" in kw:
        args.update(side_k=to(x["side_k"]), side_v=to(x["side_v"]),
                    side_len=kw["side"])
    return fn(to(x["q"]), to(x["k"]), to(x["v"]), to(cache_len), **args)


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_walk_matches_jax(jax_flash_decode, case, group):
    """The split walk at 32-key splits, where SPLIT_CASES's boundaries
    lie, against tpudist's flash_decode (Pallas, interpret mode)."""
    g, d = GROUPS[group]
    cache_len, kw = SPLIT_CASES[case]
    h_kv, x = _split_inputs(sorted(SPLIT_CASES).index(case), g, d)
    split = 32
    want = _split_call(
        lambda *a, **k: jax_flash_decode(*a, interpret=True, **k), _jax, x,
        cache_len, kw)
    got = _split_call(tfd._flash_decode_split_plain, _torch, x, cache_len,
                      kw, split_keys=split)
    if kw.get("return_lse"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "pos_offset_dead":
        assert not got.any()


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_walk_at_the_wrappers_split_matches_jax(jax_flash_decode, case,
                                                      group):
    """The split walk at the wrappers' split (SPLIT_CASES moved to it,
    over three splits of keys) against tpudist's flash_decode (Pallas,
    interpret mode)."""
    g, d = GROUPS[group]
    split = tfd._SPLIT_KEYS
    cache_len, kw = _case_at_split(case, split)
    h_kv, x = _split_inputs(sorted(SPLIT_CASES).index(case), g, d,
                            s=3 * split)
    want = _split_call(
        lambda *a, **k: jax_flash_decode(*a, interpret=True, **k), _jax, x,
        cache_len, kw)
    got = _split_call(tfd._flash_decode_split_plain, _torch, x, cache_len,
                      kw, split_keys=split)
    if kw.get("return_lse"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "pos_offset_dead":
        assert not got.any()


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


# ---- on the card: the split merge (K2's, K5's and K6's) ---------------------

# 512 keys = 4 of the wrappers' 128-key splits (and the side buffer's own
# split); name:
# (cache_len, window, side tokens)
MERGE_CASES = {
    "one_live_split": (np.array([100, 7, 128], np.int32), None, None),
    "all_splits_live": (np.array([512, 512, 512], np.int32), None, None),
    "window": (500, 200, None),
    "side_buffer_only": (np.array([0, 0, 0], np.int32), None, 6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_cases_on_the_card(cuda_device, dtype, case):
    """The merge over rows whose live keys fall in one split, in every
    split, in a window band, or only in the side buffer: out and LSE
    against the plain version, and a second call bitwise equal."""
    cache_len, window, side = MERGE_CASES[case]
    rng = np.random.default_rng(sorted(MERGE_CASES).index(case))
    b, s, h, h_kv, d, cap = 3, 512, 8, 2, 64, 8

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            cuda_device, dtype)

    q, k, v = t(b, 1, h, d), t(b, s, h_kv * d), t(b, s, h_kv * d)
    lens = torch.as_tensor(cache_len).to(cuda_device)
    kw = dict(window=window, return_lse=True, packed_kv_heads=h_kv)
    if side is not None:
        kw.update(side_k=t(b, cap, h_kv * d), side_v=t(b, cap, h_kv * d),
                  side_len=side)
    got, lse = tfd.flash_decode(q, k, v, lens, **kw)
    again, lse2 = tfd.flash_decode(q, k, v, lens, **kw)
    want, plse = tfd.flash_decode_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-4)
    assert torch.equal(got, again) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("split", tfd._SPLIT_SIZES)
def test_kernel_split_boundaries_on_the_card(cuda_device, monkeypatch,
                                             split, dtype, group, case):
    """K2 at each split size the kernel is held at, at lengths one below, at
    and one past its boundaries, with the side buffer, a window and a
    dead pos_offset slice: against the plain version and the split walk
    at that split, and a second call bitwise equal."""
    g, d = GROUPS[group]
    cache_len, kw = _case_at_split(case, split)
    h_kv, x = _split_inputs(sorted(SPLIT_CASES).index(case), g, d,
                            s=3 * split)

    def to(a):
        if not isinstance(a, np.ndarray):
            return a
        t = torch.from_numpy(a).to(cuda_device)
        return t if a.dtype == np.int32 else t.to(dtype)

    monkeypatch.setattr(tfd, "_SPLIT_KEYS", split)
    before = tfd.FLASH_DECODE.launches
    got = _split_call(tfd.flash_decode, to, x, cache_len, kw)
    again = _split_call(tfd.flash_decode, to, x, cache_len, kw)
    want = _split_call(tfd.flash_decode_plain, to, x, cache_len, kw)
    walk = _split_call(tfd._flash_decode_split_plain, to, x, cache_len, kw,
                       split_keys=split)
    torch.cuda.synchronize()
    assert tfd.FLASH_DECODE.launches == before + 2
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    if kw.get("return_lse"):
        for ref in (want, walk):
            torch.testing.assert_close(got[1], ref[1], atol=1e-3, rtol=1e-4)
        assert torch.equal(got[1], again[1])
        got, again, want, walk = got[0], again[0], want[0], walk[0]
    for ref in (want, walk):
        torch.testing.assert_close(got.float(), ref.float(), **tol)
    assert torch.equal(got, again)
    if case == "pos_offset_dead":
        assert not got.any()
