"""tpudist_torch's sequence-sharded flash decode against the JAX package's.

K2 and K6 at a global ``pos_offset``: a 96-slot cache cut into four
24-slot slices, each slice decoded on its own at ``pos_offset = 24·i``,
against ``tpudist.ops.flash_decode`` (Pallas in interpret mode) on the
same slice and offset.  The cases cover a slice wholly past ``cache_len``
(out 0, LSE -1e30 on both sides), a window that starts inside a slice and
one that starts in an earlier slice, per-row lengths and a 0-D device
offset.  :func:`sp_flash_decode` runs in gloo ranks (``run_ranks``)
against tpudist's under ``shard_map`` over conftest's virtual CPU mesh.

Tolerances: out and LSE within atol = rtol = 2e-5 in f32 (the plain
version reduces in one pass, the Pallas kernel in blocks), the int8 path
within the int8 tests' 1e-3; the merged step within 1e-5, tpudist's own
``test_sp_flash_decode_in_shard_map`` tolerance.

The ``cuda`` tests hold K2 and K6 at an offset against their plain
versions on the card.
"""

import numpy as np
import pytest
import torch

from tpudist_torch.ops import flash_decode as tfd

TOL = dict(atol=2e-5, rtol=2e-5)
Q8_TOL = dict(atol=1e-3, rtol=1e-3)
B, S, H, HKV, D, N = 3, 96, 4, 2, 16, 4
S_LOC = S // N

# name: (cache_len, window); every case runs on each of the N slices
CASES = {
    "scalar_last_slice_dead": (70, None),
    "full": (96, None),
    "window_mid_slice": (80, 30),          # starts at 50, inside slice 2
    "window_earlier_slice": (60, 40),      # starts at 20, in slice 0
    "per_row": (np.array([96, 41, 1], np.int32), None),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((B, 1, H, D), np.float32),
                k=rng.standard_normal((B, S, HKV * D), np.float32),
                v=rng.standard_normal((B, S, HKV * D), np.float32))


@pytest.fixture(scope="module")
def jax_decode():
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    import importlib

    return importlib.import_module("tpudist.ops.flash_decode")


def _slice(x, i):
    return x[:, i * S_LOC:(i + 1) * S_LOC]


@pytest.mark.parametrize("tensor_offset", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pos_offset_matches_jax(jax_decode, case, tensor_offset):
    import jax.numpy as jnp

    cache_len, window = CASES[case]
    x = _inputs(sorted(CASES).index(case))
    for i in range(N):
        k, v = _slice(x["k"], i), _slice(x["v"], i)
        want = jax_decode.flash_decode(
            jnp.asarray(x["q"]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(cache_len), window=window, interpret=True,
            pos_offset=i * S_LOC, return_lse=True, packed_kv_heads=HKV)
        off = torch.tensor(i * S_LOC) if tensor_offset else i * S_LOC
        got = tfd.flash_decode(
            torch.from_numpy(x["q"]), torch.from_numpy(k),
            torch.from_numpy(v), torch.as_tensor(cache_len), window=window,
            pos_offset=off, return_lse=True, packed_kv_heads=HKV)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"slice {i}", **TOL)


def test_dead_slice_is_zero_with_floor_lse():
    """A slice wholly past cache_len: out 0 and LSE -1e30, as tpudist's
    floor-initialised online softmax gives."""
    x = _inputs(3)
    out, lse = tfd.flash_decode(
        torch.from_numpy(x["q"]), torch.from_numpy(_slice(x["k"], 3)),
        torch.from_numpy(_slice(x["v"], 3)), 70, pos_offset=72,
        return_lse=True, packed_kv_heads=HKV)
    assert torch.equal(out, torch.zeros_like(out))
    torch.testing.assert_close(lse, torch.full_like(lse, -1e30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_q8_pos_offset_matches_jax(jax_decode, case):
    import jax.numpy as jnp

    cache_len, window = CASES[case]
    x = _inputs(10 + sorted(CASES).index(case))
    k4 = x["k"].reshape(B, S, HKV, D)
    v4 = x["v"].reshape(B, S, HKV, D)
    jq = jax_decode.quantize_kv(jnp.asarray(k4), jnp.asarray(v4))
    tq = tfd.quantize_kv(torch.from_numpy(k4), torch.from_numpy(v4))
    for i in range(N):
        want = jax_decode.flash_decode_q8(
            jnp.asarray(x["q"]), *(_slice(t, i) for t in jq),
            jnp.asarray(cache_len), window=window, interpret=True,
            pos_offset=i * S_LOC, return_lse=True)
        got = tfd.flash_decode_q8(
            torch.from_numpy(x["q"]), *(_slice(t, i) for t in tq),
            torch.as_tensor(cache_len), window=window, pos_offset=i * S_LOC,
            return_lse=True)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   err_msg=f"slice {i}", **Q8_TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   err_msg=f"slice {i}", **Q8_TOL)


def test_offset_must_be_a_scalar():
    x = {k: torch.from_numpy(v) for k, v in _inputs(0).items()}
    with pytest.raises(ValueError, match="pos_offset must be an int or a "
                                         "0-D tensor"):
        tfd.flash_decode(x["q"], x["k"], x["v"], 9, packed_kv_heads=HKV,
                         pos_offset=torch.zeros(B, dtype=torch.long))


def test_merge_of_slices_equals_whole_cache():
    """The LSE merge of the N slices' partials (done here in one process)
    equals one decode over the whole cache, windows and a dead slice
    included."""
    for case, (cache_len, window) in sorted(CASES.items()):
        x = {k: torch.from_numpy(v) for k, v in _inputs(20).items()}
        parts = [tfd.flash_decode(
            x["q"], _slice(x["k"], i), _slice(x["v"], i),
            torch.as_tensor(cache_len), window=window, pos_offset=i * S_LOC,
            return_lse=True, packed_kv_heads=HKV) for i in range(N)]
        lse = torch.stack([p[1] for p in parts])
        w = torch.exp(lse - torch.logsumexp(lse, 0))[:, :, None, :, None]
        merged = (torch.stack([p[0] for p in parts]) * w).sum(0)
        whole = tfd.flash_decode(x["q"], x["k"], x["v"],
                                 torch.as_tensor(cache_len), window=window,
                                 packed_kv_heads=HKV)
        torch.testing.assert_close(merged, whole, atol=1e-5, rtol=1e-5,
                                   msg=case)


# ---- sp_flash_decode across gloo ranks --------------------------------------

SP_CASES = [(None, 40), (None, 96), (12, 50), (30, 80)]


def _sp_ranks(rank, world, x):
    import torch.distributed as dist

    from tpudist_torch.ops.flash_decode import sp_flash_decode

    s_loc = S // world
    out = []
    for window, cache_len in SP_CASES:
        k = torch.from_numpy(x["k"][:, rank * s_loc:(rank + 1) * s_loc])
        v = torch.from_numpy(x["v"][:, rank * s_loc:(rank + 1) * s_loc])
        out.append(sp_flash_decode(
            torch.from_numpy(x["q"]), k, v, cache_len, dist.group.WORLD,
            window=window, packed_kv_heads=HKV).numpy())
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sp_flash_decode_matches_jax(jax_decode, tmp_path, world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tests.test_torch_data_parallel import run_ranks
    from tpudist.runtime.mesh import make_mesh

    x = _inputs(30 + world)
    mesh = make_mesh({"seq": world}, jax.devices()[:world])
    kv_spec = P(None, "seq", None)
    results = run_ranks(_sp_ranks, world, tmp_path, x)
    for c, (window, cache_len) in enumerate(SP_CASES):
        fn = jax.shard_map(
            lambda qs, ks, vs: jax_decode.sp_flash_decode(
                qs, ks, vs, cache_len, "seq", window=window, interpret=True,
                packed_kv_heads=HKV),
            mesh=mesh, in_specs=(P(), kv_spec, kv_spec), out_specs=P(),
            check_vma=False)
        want = np.asarray(fn(jnp.asarray(x["q"]), jnp.asarray(x["k"]),
                             jnp.asarray(x["v"])))
        assert np.isfinite(want).all()
        for r in range(world):
            np.testing.assert_allclose(
                results[r][c], want, atol=1e-5, rtol=1e-5,
                err_msg=f"rank {r} window={window} len={cache_len}")


# ---- on the card: K2 and K6 at an offset against their plain versions ------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K2 and K6 have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_k6_offset_match_plain(cuda_device, dtype, case):
    cache_len, window = CASES[case]
    x = _inputs(40)
    q = torch.from_numpy(x["q"]).to(cuda_device, dtype)
    lens = torch.as_tensor(cache_len).to(cuda_device)
    kv = {n: torch.from_numpy(x[n]).to(cuda_device, dtype) for n in "kv"}
    q8 = tfd.quantize_kv(kv["k"].unflatten(2, (HKV, D)),
                         kv["v"].unflatten(2, (HKV, D)))
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for i in range(N):
        off = torch.tensor(i * S_LOC, device=cuda_device)
        k, v = _slice(kv["k"], i), _slice(kv["v"], i)
        kw = dict(window=window, return_lse=True, pos_offset=off)
        before = (tfd.FLASH_DECODE.launches, tfd.FLASH_DECODE_Q8.launches)
        got = tfd.flash_decode(q, k, v, lens, packed_kv_heads=HKV, **kw)
        got8 = tfd.flash_decode_q8(q, *(_slice(t, i) for t in q8), lens,
                                   **kw)
        want = tfd.flash_decode_plain(q, k, v, lens, packed_kv_heads=HKV,
                                      **kw)
        want8 = tfd.flash_decode_q8_plain(q, *(_slice(t, i) for t in q8),
                                          lens, **kw)
        torch.cuda.synchronize()
        assert (tfd.FLASH_DECODE.launches, tfd.FLASH_DECODE_Q8.launches) \
            == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
        torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)
        torch.testing.assert_close(got8[0].float(), want8[0].float(),
                                   **Q8_TOL if dtype == torch.float32
                                   else tol)
        torch.testing.assert_close(got8[1], want8[1], atol=1e-3, rtol=1e-4)
