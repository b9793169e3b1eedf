"""tpudist_torch's paged and int8 flash decode against the JAX package's.

On the CPU the port runs the plain versions (``paged_flash_decode_plain``:
``paged_gather_kv`` then ``flash_decode_plain``; ``flash_decode_q8_plain``);
the JAX side runs the Pallas decode kernel in interpret mode.  Same seeded
numpy inputs into both.

Tolerances:
- paged, f32: atol = rtol = 1e-5.  Both sides compute in f32 and differ
  only in summation order.
- ``quantize_kv``: bit-identical (the same elementwise f32 ops).
- int8, f32 queries: atol = rtol = 1e-3.  Both round ``p · v_scale`` to
  bf16 before the value product, against the same max (at S = 96 the
  Pallas kernel walks one block).  The scores feeding ``p`` are summed in
  other orders, so a probability can land one bf16 step (2^-8 relative)
  away, moving an output by 2^-8 of that key's share of ``|v|``; the
  seeded inputs here differ by under 2e-7.  The LSE has no bf16 step:
  1e-5.
- int8 split walk (``_flash_decode_q8_split_plain``): each split rounds
  ``p · v_scale`` against its own max, the Pallas kernel against the
  row's, so every term may round the other way: each output is held
  within ``2^-8 · Σ p|v_scale·v| / Σ p`` (the two roundings' bound,
  from the row's softmax in f64) plus 1e-5; the LSE within 1e-5.

The ``cuda`` tests hold kernel K5 against its plain version (and
bit-for-bit against K2 over the gathered view) and K6 against its plain
version on the card.  The JAX package is imported inside a fixture.
"""

import numpy as np
import pytest
import torch

from tpudist_torch.ops import flash_decode as tfd

TOL = dict(atol=1e-5, rtol=1e-5)
Q8_TOL = dict(atol=1e-3, rtol=1e-3)
B, H, HKV, CAP = 3, 4, 2, 8


def _paged_inputs(seed, bs, d, s_q, m=6):
    """A pool with a shuffled table: each row's live blocks are a random
    draw of distinct pool blocks, the entries past them 0 (dead)."""
    rng = np.random.default_rng(seed)
    n_pool = B * m + 3
    lens = np.array([m * bs, 2 * bs + 3, 1], np.int32)
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    table = np.zeros((B, m), np.int32)
    used = 0
    for r in range(B):
        live = -(-int(lens[r]) // bs)
        table[r, :live] = perm[used:used + live]
        used += live
    return dict(
        q=rng.standard_normal((B, s_q, H, d), np.float32),
        k_pool=rng.standard_normal((n_pool, bs, HKV * d), np.float32),
        v_pool=rng.standard_normal((n_pool, bs, HKV * d), np.float32),
        table=table, lens=lens,
        side_k=rng.standard_normal((B, CAP, HKV * d), np.float32),
        side_v=rng.standard_normal((B, CAP, HKV * d), np.float32))


@pytest.fixture(scope="module")
def jax_decode():
    """The JAX package's flash-decode module (Pallas, interpret mode)."""
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    import importlib
    return importlib.import_module("tpudist.ops.flash_decode")


def _paged(fn, to, x, side_len, **kw):
    side = {} if side_len is None else dict(
        side_k=to(x["side_k"]), side_v=to(x["side_v"]), side_len=side_len)
    return fn(to(x["q"]), to(x["k_pool"]), to(x["v_pool"]), to(x["table"]),
              to(x["lens"]), packed_kv_heads=HKV, **side, **kw)


@pytest.mark.parametrize("s_q,side_len", [(1, None), (1, 0), (1, 5),
                                          (3, 5)],
                         ids=["no_side", "side0", "side5", "multi_query"])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("bs", [8, 16])
def test_paged_matches_jax(jax_decode, bs, d, s_q, side_len):
    import jax.numpy as jnp

    x = _paged_inputs(100 * bs + d + s_q, bs, d, s_q)
    want = _paged(jax_decode.paged_flash_decode, jnp.asarray, x, side_len,
                  interpret=True)
    got = _paged(tfd.paged_flash_decode, torch.from_numpy, x, side_len)
    assert got.shape == (B, s_q, H, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_gather_matches_jax(jax_decode):
    import jax.numpy as jnp

    x = _paged_inputs(3, 8, 16, 1)
    want = jax_decode.paged_gather_kv(jnp.asarray(x["k_pool"]),
                                      jnp.asarray(x["table"]))
    got = tfd.paged_gather_kv(torch.from_numpy(x["k_pool"]),
                              torch.from_numpy(x["table"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_equals_dense_over_gathered_view():
    """The paged function is the dense one over the gathered view (the
    identity K5 holds bit for bit on the card)."""
    x = {k: torch.from_numpy(v) for k, v in _paged_inputs(9, 16, 32,
                                                          1).items()}
    side = dict(side_k=x["side_k"], side_v=x["side_v"], side_len=4)
    got = tfd.paged_flash_decode(x["q"], x["k_pool"], x["v_pool"],
                                 x["table"], x["lens"], packed_kv_heads=HKV,
                                 **side)
    want = tfd.flash_decode(
        x["q"], tfd.paged_gather_kv(x["k_pool"], x["table"]),
        tfd.paged_gather_kv(x["v_pool"], x["table"]), x["lens"],
        packed_kv_heads=HKV, **side)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{fn.__name__} raised nothing")


@pytest.mark.parametrize("case", ["pool_rank", "minor_dim", "heads",
                                  "block", "scalar_len", "table_rows",
                                  "side_rank", "multi_query_no_side"])
def test_paged_errors_match_jax(jax_decode, case):
    """The JAX function's contract errors, raised alike."""
    import jax.numpy as jnp

    x = _paged_inputs(1, 16, 16, 3 if case == "multi_query_no_side" else 1)
    kw = dict(packed_kv_heads=HKV)
    if case == "pool_rank":
        x["k_pool"] = x["k_pool"][..., None]
    elif case == "minor_dim":
        kw["packed_kv_heads"] = 4
    elif case == "heads":                 # 3 query heads over 2 KV heads
        x["q"] = x["q"][:, :, :3]
    elif case == "block":
        x["k_pool"] = x["k_pool"][:, :12]
    elif case == "scalar_len":
        x["lens"] = np.int32(5)
    elif case == "table_rows":
        x["table"] = x["table"][:2]
    if case == "side_rank":
        kw.update(side_k=x["side_k"][..., None], side_v=x["side_v"],
                  side_len=1)

    def call(fn, to, **extra):
        args = {k: (to(v) if isinstance(v, np.ndarray) else v)
                for k, v in kw.items()}
        lens = (to(x["lens"]) if isinstance(x["lens"], np.ndarray)
                else torch.tensor(5) if to is torch.from_numpy else 5)
        return _error(fn, to(x["q"]), to(x["k_pool"]), to(x["k_pool"]),
                      to(x["table"]), lens, **args, **extra)

    want = call(jax_decode.paged_flash_decode, jnp.asarray, interpret=True)
    got = call(tfd.paged_flash_decode, torch.from_numpy)
    assert got.split(";")[0].split("(")[0] == want.split(";")[0].split("(")[0]


# ---- int8 ------------------------------------------------------------------

S8, D8 = 96, 16


def _q8_inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    kv = lambda: rng.standard_normal((B, S8, HKV, D8)).astype(dtype)  # noqa
    return dict(q=rng.standard_normal((B, 1, H, D8), np.float32),
                k=kv(), v=kv())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical(jax_decode, dtype):
    import jax.numpy as jnp

    x = _q8_inputs(4)
    jk, jv = (jnp.asarray(x[n]).astype(dtype) for n in ("k", "v"))
    tk, tv = (torch.from_numpy(x[n]).to(getattr(torch, dtype))
              for n in ("k", "v"))
    want = jax_decode.quantize_kv(jk, jv)
    got = tfd.quantize_kv(tk, tv)
    for g, w in zip(got, want):
        assert g.dtype == {"int8": torch.int8,
                           "float32": torch.float32}[str(w.dtype)]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


Q8_CASES = {
    "per_row": (np.array([96, 41, 1], np.int32), {}),
    "scalar": (70, {}),
    "window": (80, {"window": 24}),
    "lse_per_row": (np.array([5, 96, 33], np.int32), {"return_lse": True}),
    "lse_window": (57, {"window": 16, "return_lse": True}),
}


@pytest.mark.parametrize("case", sorted(Q8_CASES))
def test_q8_matches_jax(jax_decode, case):
    import jax.numpy as jnp

    cache_len, kw = Q8_CASES[case]
    x = _q8_inputs(sorted(Q8_CASES).index(case) + 20)
    jq = jax_decode.quantize_kv(jnp.asarray(x["k"]), jnp.asarray(x["v"]))
    want = jax_decode.flash_decode_q8(
        jnp.asarray(x["q"]), *jq, jnp.asarray(cache_len), interpret=True,
        **kw)
    tq = tfd.quantize_kv(torch.from_numpy(x["k"]), torch.from_numpy(x["v"]))
    got = tfd.flash_decode_q8(torch.from_numpy(x["q"]), *tq,
                              torch.as_tensor(cache_len), **kw)
    if kw.get("return_lse"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Q8_TOL)


def test_q8_errors():
    x = _q8_inputs(0)
    q = torch.from_numpy(x["q"])
    kq, ks, vq, vs = tfd.quantize_kv(torch.from_numpy(x["k"]),
                                     torch.from_numpy(x["v"]))
    lens = torch.tensor([4, 5, 6], dtype=torch.int32)
    # a sequence-sharded int8 cache is ported: slot j is position 32 + j
    # (tests/test_torch_sharded_decode.py holds it against tpudist's)
    out = tfd.flash_decode_q8(q, kq, ks, vq, vs, 40, pos_offset=32)
    assert out.shape == q.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="per-row"):
        tfd.flash_decode_q8(q, kq, ks, vq, vs, lens, window=4)
    with pytest.raises(ValueError, match="packed"):
        tfd.flash_decode_q8(q, kq.flatten(2), ks, vq.flatten(2), vs, 9)
    with pytest.raises(ValueError, match="one query"):
        tfd.flash_decode_q8(q.expand(-1, 2, -1, -1), kq, ks, vq, vs, 9)


# ---- the split walks of K5 and K6 in plain PyTorch --------------------------

SPLIT_GROUPS = {"g1_d16": (1, 16), "g4_d16": (4, 16), "g1_d64": (1, 64),
                "g4_d64": (4, 64)}
# rows one below, at and one past a 32-key split boundary
SPLIT_LENS = np.array([31, 64, 65], np.int32)


def _at_split(x, ck):
    """A length or position written at 32-key splits, moved to ``ck``-key
    splits: the same distance from its nearest split boundary (the
    helper of tests/test_torch_flash_decode.py's card tests)."""
    if isinstance(x, np.ndarray):
        return np.array([_at_split(int(v), ck) for v in x], np.int32)
    n = round(x / 32)
    return n * ck + x - n * 32


def _paged_split_inputs(seed, bs, g, d, split=32):
    """4 query heads over 4 // g KV heads; a ``3·split``-key pool table
    per row (``bs`` 8, 16 or 24: 24 does not divide a split), its live
    blocks a shuffled draw of distinct pool blocks; SPLIT_LENS moved to
    ``split``-key splits."""
    rng = np.random.default_rng(seed)
    h_kv, m = H // g, 3 * split // bs
    n_pool = B * m + 1
    table = rng.permutation(np.arange(1, n_pool)).astype(np.int32).reshape(
        B, m)
    t = lambda *shape: rng.standard_normal(shape, np.float32)  # noqa: E731
    return h_kv, dict(q=t(B, 1, H, d), k_pool=t(n_pool, bs, h_kv * d),
                      v_pool=t(n_pool, bs, h_kv * d), table=table,
                      lens=_at_split(SPLIT_LENS, split),
                      side_k=t(B, CAP, h_kv * d),
                      side_v=t(B, CAP, h_kv * d))


@pytest.mark.parametrize("side_len", [None, 5], ids=["no_side", "side5"])
@pytest.mark.parametrize("group", sorted(SPLIT_GROUPS))
@pytest.mark.parametrize("bs", [8, 16, 24])
def test_paged_split_walk_matches_jax(jax_decode, bs, group, side_len):
    """K5's split walk at 32-key splits against tpudist's
    paged_flash_decode (Pallas, interpret mode)."""
    import jax.numpy as jnp

    g, d = SPLIT_GROUPS[group]
    h_kv, x = _paged_split_inputs(bs + d + g, bs, g, d)
    split = 32

    def call(fn, to, **kw):
        side = {} if side_len is None else dict(
            side_k=to(x["side_k"]), side_v=to(x["side_v"]),
            side_len=side_len)
        return fn(to(x["q"]), to(x["k_pool"]), to(x["v_pool"]),
                  to(x["table"]), to(x["lens"]), packed_kv_heads=h_kv,
                  **side, **kw)

    want = call(jax_decode.paged_flash_decode, jnp.asarray, interpret=True)
    got = call(tfd._paged_flash_decode_split_plain, torch.from_numpy,
               split_keys=split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# name: (cache_len, kwargs)
Q8_SPLIT_CASES = {
    "per_row_boundaries": (np.array([31, 32, 33], np.int32), {}),
    "scalar_one_past": (65, {"return_lse": True}),
    "window_at_boundary": (64, {"window": 33}),
    "pos_offset_dead": (40, {"pos_offset": 64, "return_lse": True}),
}


@pytest.mark.parametrize("group", sorted(SPLIT_GROUPS))
@pytest.mark.parametrize("case", sorted(Q8_SPLIT_CASES))
def test_q8_split_walk_matches_jax(jax_decode, case, group):
    """K6's split walk at 32-key splits against tpudist's
    flash_decode_q8 (Pallas, interpret mode)."""
    import jax.numpy as jnp

    g, d = SPLIT_GROUPS[group]
    cache_len, kw = Q8_SPLIT_CASES[case]
    rng = np.random.default_rng(sorted(Q8_SPLIT_CASES).index(case) + 40)
    h_kv = H // g
    q = rng.standard_normal((B, 1, H, d), np.float32)
    k, v = (rng.standard_normal((B, S8, h_kv, d)).astype(np.float32)
            for _ in range(2))
    split = 32
    jq = jax_decode.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    want = jax_decode.flash_decode_q8(jnp.asarray(q), *jq,
                                      jnp.asarray(cache_len),
                                      interpret=True, **kw)
    tq = tfd.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    got = tfd._flash_decode_q8_split_plain(
        torch.from_numpy(q), *tq, torch.as_tensor(cache_len),
        split_keys=split, **kw)
    if kw.get("return_lse"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        got, want = got[0], want[0]
    bound = _q8_rounding_bound(torch.from_numpy(q), *tq, cache_len, kw)
    assert (np.abs(got.numpy() - np.asarray(want))
            <= bound + TOL["atol"]).all()


def _q8_rounding_bound(q, kq, ks, vq, vs, cache_len, kw):
    """Per output element, how far two int8 decodes may land apart when
    each rounds ``p · v_scale`` to bf16 against its own max: a split's
    ``p`` is the whole row's times ``exp(M - m_split)``, so each term's
    rounding moves it by at most 2^-9 of its value on either side, and
    the outputs by at most ``2^-8 · Σ p|v_scale·v| / Σ p``, computed here
    in f64 from the row's softmax."""
    b, _, h, d = q.shape
    s, h_kv = kq.shape[1], kq.shape[2]
    qf = q.to(torch.bfloat16).double().reshape(b, h_kv, h // h_kv, d)
    keep = tfd._global_keep(s, torch.as_tensor(cache_len), kw.get("window"),
                            kw.get("pos_offset", 0), q.device)
    sc = torch.einsum("bjgd,bsjd->bjgs", qf, kq.double()) * (
        ks[..., 0].double() * d ** -0.5).permute(0, 2, 1)[:, :, None]
    sc = sc.masked_fill(~keep, float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True).clamp_min(-1e30))
    vv = (vs.double() * vq.double()).abs()               # [B, S, Hkv, D]
    num = torch.einsum("bjgs,bsjd->bjgd", p, vv)
    den = p.sum(-1, keepdim=True)
    bound = torch.where(den > 0, 2.0 ** -8 * num / den.clamp_min(1e-300),
                        torch.zeros_like(num))
    return bound.reshape(b, 1, h, d).numpy()


# ---- the paged model step ---------------------------------------------------

def test_paged_model_step_matches_dense_sided_step():
    """A TransformerLM decode step over a paged slot cache whose pool holds
    the dense cache's rows through a shuffled table gives the dense
    side-buffer step's logits (the same plain softmax over the same
    values: equal to f32 rounding)."""
    from tpudist_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        blank_cache,
    )

    cfg = TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
                            num_kv_heads=2, embed_dim=64, max_seq_len=64)
    bs, nb, cap = 8, 20, 4
    model = TransformerLM(cfg, serve_side_slots=cap, cache_layout="paged",
                          kv_block_size=bs, kv_num_blocks=nb,
                          device="cpu").init_weights(
                              torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    lens = torch.tensor([30, 9], dtype=torch.int32)
    dense = blank_cache(cfg, 2, device="cpu", per_row=True, side_slots=cap)
    paged = blank_cache(cfg, 2, device="cpu", side_slots=cap,
                        kv_block_size=bs, kv_num_blocks=nb)
    table = torch.from_numpy(rng.permutation(nb)[:16].astype(np.int32)
                             ).reshape(2, 8)
    for dl, pl in zip(dense, paged):
        for dn, pn in (("cached_key", "paged_key"),
                       ("cached_value", "paged_value")):
            dl[dn].copy_(torch.from_numpy(
                rng.standard_normal(dl[dn].shape, np.float32)))
            pl[pn][table.reshape(-1).long()] = dl[dn].reshape(16, bs, -1)
        dl["cache_index"], pl["cache_index"] = lens.clone(), lens.clone()
        pl["page_table"] = table
    with torch.no_grad():
        for t in range(3):
            tok = torch.from_numpy(rng.integers(0, 64, (2, 1)))
            pos = lens[:, None].long() + t
            want, dense = model(tok, positions=pos, cache=dense)
            got, paged = model(tok, positions=pos, cache=paged)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert int(paged[0]["side_index"]) == 3


# ---- on the card: K5 and K6 against their plain versions --------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K5/K6 have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,d,s_q,side_len", [
    (8, 16, 1, None), (16, 32, 1, 5), (16, 64, 3, 5), (24, 128, 1, 0)])
def test_k5_matches_plain(cuda_device, dtype, bs, d, s_q, side_len):
    x = _paged_inputs(bs + d, bs, d, s_q)

    def to(a):
        t = torch.from_numpy(a).to(cuda_device)
        return t if a.dtype == np.int32 else t.to(dtype)

    before = tfd.PAGED_FLASH_DECODE.launches
    got = _paged(tfd.paged_flash_decode, to, x, side_len)
    want = _paged(tfd.paged_flash_decode_plain if s_q == 1
                  else tfd.paged_flash_decode, lambda a: to(a).cpu(), x,
                  side_len)
    torch.cuda.synchronize()
    assert tfd.PAGED_FLASH_DECODE.launches == before + s_q
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)
    # bit for bit K2 over the gathered view: same splits, same order
    side = {} if side_len is None else dict(
        side_k=to(x["side_k"]), side_v=to(x["side_v"]), side_len=side_len)
    k2 = tfd.flash_decode(
        to(x["q"]), tfd.paged_gather_kv(to(x["k_pool"]), to(x["table"])),
        tfd.paged_gather_kv(to(x["v_pool"]), to(x["table"])), to(x["lens"]),
        packed_kv_heads=HKV, **side)
    assert torch.equal(got, k2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(Q8_CASES))
def test_k6_matches_plain(cuda_device, dtype, case):
    cache_len, kw = Q8_CASES[case]
    x = _q8_inputs(31)
    q = torch.from_numpy(x["q"]).to(cuda_device, dtype)
    kv = tfd.quantize_kv(torch.from_numpy(x["k"]).to(cuda_device),
                         torch.from_numpy(x["v"]).to(cuda_device))
    lens = torch.as_tensor(cache_len).to(cuda_device)
    before = tfd.FLASH_DECODE_Q8.launches
    got = tfd.flash_decode_q8(q, *kv, lens, **kw)
    want = tfd.flash_decode_q8_plain(q, *kv, lens, **kw)
    torch.cuda.synchronize()
    assert tfd.FLASH_DECODE_Q8.launches == before + 1
    if kw.get("return_lse"):
        torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)
        got, want = got[0], want[0]
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side_len", [None, 5], ids=["no_side", "side5"])
@pytest.mark.parametrize("group", sorted(SPLIT_GROUPS))
@pytest.mark.parametrize("bs", [8, 16, 24])
@pytest.mark.parametrize("split", tfd._SPLIT_SIZES)
def test_k5_split_boundaries_on_the_card(cuda_device, monkeypatch, split,
                                         dtype, bs, group, side_len):
    """K5 at each split size the kernel is held at, at rows one below, at and
    one past a split boundary, at blocks 8, 16 and 24 (24 does not divide
    a split): against the split walk at that split, bit for bit K2 over
    the gathered view, and a second call bitwise equal."""
    g, d = SPLIT_GROUPS[group]
    h_kv, x = _paged_split_inputs(bs + d + g, bs, g, d, split)
    monkeypatch.setattr(tfd, "_SPLIT_KEYS", split)

    def to(a):
        t = torch.from_numpy(a).to(cuda_device)
        return t if a.dtype == np.int32 else t.to(dtype)

    side = {} if side_len is None else dict(
        side_k=to(x["side_k"]), side_v=to(x["side_v"]), side_len=side_len)
    args = (to(x["q"]), to(x["k_pool"]), to(x["v_pool"]), to(x["table"]),
            to(x["lens"]))
    got = tfd.paged_flash_decode(*args, packed_kv_heads=h_kv, **side)
    again = tfd.paged_flash_decode(*args, packed_kv_heads=h_kv, **side)
    walk = tfd._paged_flash_decode_split_plain(
        *args, packed_kv_heads=h_kv, split_keys=split, **side)
    k2 = tfd.flash_decode(
        args[0], tfd.paged_gather_kv(args[1], args[3]),
        tfd.paged_gather_kv(args[2], args[3]), args[4],
        packed_kv_heads=h_kv, **side)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), walk.float(), **tol)
    assert torch.equal(got, again) and torch.equal(got, k2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", sorted(SPLIT_GROUPS))
@pytest.mark.parametrize("case", sorted(Q8_SPLIT_CASES))
@pytest.mark.parametrize("split", tfd._SPLIT_SIZES)
def test_k6_split_boundaries_on_the_card(cuda_device, monkeypatch, split,
                                         dtype, case, group):
    """K6 at each split size the kernel is held at, about its boundaries, a
    window ending on one and a dead pos_offset slice (Q8_SPLIT_CASES
    moved to that split): against the plain version and the split walk
    at that split, and a second call bitwise equal."""
    g, d = SPLIT_GROUPS[group]
    cache_len, kw = Q8_SPLIT_CASES[case]
    cache_len = _at_split(cache_len, split)
    kw = {k: _at_split(v, split) if k in ("window", "pos_offset") else v
          for k, v in kw.items()}
    rng = np.random.default_rng(sorted(Q8_SPLIT_CASES).index(case) + 40)
    h_kv = H // g
    q = torch.from_numpy(rng.standard_normal((B, 1, H, d), np.float32)).to(
        cuda_device, dtype)
    kv = tfd.quantize_kv(*(torch.from_numpy(
        rng.standard_normal((B, 3 * split, h_kv, d)).astype(
            np.float32)).to(cuda_device) for _ in range(2)))
    lens = torch.as_tensor(cache_len).to(cuda_device)
    monkeypatch.setattr(tfd, "_SPLIT_KEYS", split)
    got = tfd.flash_decode_q8(q, *kv, lens, **kw)
    again = tfd.flash_decode_q8(q, *kv, lens, **kw)
    want = tfd.flash_decode_q8_plain(q, *kv, lens, **kw)
    walk = tfd._flash_decode_q8_split_plain(q, *kv, lens, split_keys=split,
                                            **kw)
    torch.cuda.synchronize()
    if kw.get("return_lse"):
        for ref in (want, walk):
            torch.testing.assert_close(got[1], ref[1], atol=1e-3, rtol=1e-4)
        assert torch.equal(got[1], again[1])
        got, again, want, walk = got[0], again[0], want[0], walk[0]
    for ref in (want, walk):
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    assert torch.equal(got, again)
