"""tpudist_torch's fused MoE dispatch (kernel K7's wrapper) against the JAX
package's.

On the CPU the port runs K7's plain version (``_gmm_plain``) under its
autograd wrapper; the JAX side runs the Pallas ``_gmm_kernel`` in interpret
mode under its ``custom_vjp``.  The shapes are the JAX tests' own
(``tests/test_moe.py``: T×E×k at block 16 and 8, d=32, f=64, and the
skewed 48-token routing at d=16, f=32 with every token on experts 0 and 1).
Same inputs (numpy, seeded) into both.

Tolerances: f32 outputs within atol 2e-5 + rtol 1e-4 and gradients within
atol 1e-6 + rtol 1e-4 (both sides compute in f32; sums run in other
orders).  bf16 (same bf16 inputs): each output element within
1e-2·max|JAX| + 2e-2·|JAX| (h is rounded to bf16 between the products on
both sides, at points that may land one bf16 ulp apart).

The ``cuda`` tests hold K7 against ``_gmm_plain`` on the card, at these
shapes and at bench.py's ``bench_moe`` layer, in bf16 and f32.  The JAX
package is imported inside a fixture, so on a card host without flax they
still run (the parity tests skip there).
"""

import importlib

import numpy as np
import pytest
import torch

from tpudist_torch.models import moe as tm
from tpudist_torch.ops import moe_dispatch as td

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
# (t, e, k, block_rows, d, f, skewed)
CASES = {
    "t64_e4_k2_b16": (64, 4, 2, 16, 32, 64, False),
    "t96_e8_k2_b8": (96, 8, 2, 8, 32, 64, False),
    "t64_e4_k1_b16": (64, 4, 1, 16, 32, 64, False),
    "skewed_t48_b16": (48, 4, 2, 16, 16, 32, True),
}


def _inputs(case):
    """``(x, w_up, w_down, top_idx, top_vals)`` as numpy, seeded by the
    case; the routing is the top-k of softmaxed random gates, or every
    token on experts 0 and 1 at gate 0.5 when skewed."""
    t, e, k, _, d, f, skewed = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = rng.standard_normal((t, d), np.float32)
    w_up = rng.standard_normal((e, d, f), np.float32) * 0.1
    w_down = rng.standard_normal((e, f, d), np.float32) * 0.1
    if skewed:
        ti = np.stack([np.zeros(t, np.int64), np.ones(t, np.int64)], 1)
        tv = np.full((t, k), 0.5, np.float32)
    else:
        gates = torch.softmax(torch.from_numpy(
            rng.standard_normal((t, e), np.float32)), -1)
        tv, ti, _ = tm._gate_choices(gates, k)
        tv, ti = tv.numpy(), ti.numpy()
    return x, w_up, w_down, ti, tv


def _t(*xs):
    return [torch.from_numpy(np.array(x, copy=True)) for x in xs]


@pytest.fixture(scope="module")
def jax_dispatch():
    """The JAX package's ``moe_dispatch`` module (Pallas, interpret mode
    on the CPU)."""
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    return importlib.import_module("tpudist.ops.moe_dispatch")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_moe_mlp_matches_jax(jax_dispatch, case):
    import jax.numpy as jnp

    x, w_up, w_down, ti, tv = _inputs(case)
    bn = CASES[case][3]
    want = jax_dispatch.fused_moe_mlp(
        jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down),
        jnp.asarray(ti, jnp.int32), jnp.asarray(tv), block_rows=bn)
    xt, ut, dt, it, vt = _t(x, w_up, w_down, ti, tv)
    got = td.fused_moe_mlp(xt, ut, dt, it, vt, block_rows=bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("case", ["t64_e4_k2_b16", "skewed_t48_b16"])
def test_fused_moe_mlp_bf16_matches_jax(jax_dispatch, case):
    import jax.numpy as jnp

    x, w_up, w_down, ti, tv = _inputs(case)
    bn = CASES[case][3]
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (x, w_up, w_down)]
    want = np.asarray(jax_dispatch.fused_moe_mlp(
        *bf, jnp.asarray(ti, jnp.int32), jnp.asarray(tv),
        block_rows=bn).astype(jnp.float32))
    xt, ut, dt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .bfloat16() for a in bf)
    got = td.fused_moe_mlp(xt, ut, dt, *_t(ti, tv), block_rows=bn)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= 1e-2 * np.abs(want).max() + 2e-2 * np.abs(want)).all(), \
        err.max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_moe_mlp_grads_match_jax(jax_dispatch, case):
    """The port's ``_FusedMoE`` backward (remat through ``_ragged_moe``)
    against ``jax.grad`` through the JAX ``custom_vjp``: gradients of
    ``sum(out · cotangent)`` for x, w_up, w_down and top_vals."""
    import jax
    import jax.numpy as jnp

    x, w_up, w_down, ti, tv = _inputs(case)
    bn = CASES[case][3]
    cot = np.random.default_rng(99).standard_normal(x.shape, np.float32)

    def loss(xx, wu, wd, vv):
        out = jax_dispatch.fused_moe_mlp(xx, wu, wd,
                                         jnp.asarray(ti, jnp.int32), vv,
                                         block_rows=bn)
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w_up, w_down, tv)))
    leaves = [a.requires_grad_() for a in _t(x, w_up, w_down, tv)]
    (it,) = _t(ti)
    out = td.fused_moe_mlp(leaves[0], leaves[1], leaves[2], it, leaves[3],
                           block_rows=bn)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, leaf, w in zip(("x", "w_up", "w_down", "top_vals"), leaves,
                             want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_jax(jax_dispatch, case):
    """The kernel's inputs: sorted rows, the f32 gate with 0 on pad
    slots and the block→expert map equal the JAX function's (the JAX
    expressions of ``_fused_moe_fwd_only``, ``moe_dispatch.py:115-127``)."""
    import jax.numpy as jnp
    from tpudist.models.moe import _counting_sort

    x, _, _, ti, tv = _inputs(case)
    _, e, k, bn = CASES[case][:4]
    pos, order, _, starts, np_pad = _counting_sort(
        jnp.asarray(ti.reshape(-1), jnp.int32), e, block_rows=bn)
    nb = np_pad // bn
    want_xs = jnp.asarray(x)[order // k]
    want_gate = jnp.zeros((np_pad, 1), jnp.float32).at[pos, 0].set(
        jnp.asarray(tv).reshape(-1))
    ids = jnp.zeros((nb,), jnp.int32).at[
        jnp.minimum(starts // bn, nb - 1)].add(1)
    want_be = jnp.clip(jnp.cumsum(ids) - 1, 0, e - 1)
    xt, it, vt = _t(x, ti, tv)
    got_pos, xs, gate, be, live = td._fused_layout(xt, it, vt, e, bn)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(want_xs))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(want_gate))
    np.testing.assert_array_equal(be.numpy(), np.asarray(want_be))
    sizes = np.bincount(ti.reshape(-1), minlength=e)
    assert int(live) == int(starts[-1]) + -(-int(sizes[-1]) // bn) * bn


def test_cpu_call_takes_the_plain_path():
    """A CPU tensor runs ``_gmm_plain``: K7's launch count stays put."""
    before = td.MOE_GMM.launches
    x, w_up, w_down, ti, tv = _t(*_inputs("t96_e8_k2_b8"))
    x.requires_grad_()
    td.fused_moe_mlp(x, w_up, w_down, ti, tv, block_rows=8).sum().backward()
    assert x.grad is not None
    assert td.MOE_GMM.launches == before


def test_other_devices_raise():
    x = torch.zeros(8, 16, device="meta")
    w = torch.zeros(2, 16, 16, device="meta")
    idx = torch.zeros(8, 2, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        td.fused_moe_mlp(x, w, w, idx, x[:, :2], block_rows=8)


# ---- on the card: K7 against its plain version -----------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K7 has no CPU mode)")
    return torch.device("cuda")


def _card_layout(dev, dtype, t, e, k, bn, d, f, skewed, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t, d, generator=g, device=dev).to(dtype)
    w_up = (torch.randn(e, d, f, generator=g, device=dev) / d ** 0.5).to(dtype)
    w_down = (torch.randn(e, f, d, generator=g, device=dev)
              / f ** 0.5).to(dtype)
    if skewed:
        ti = torch.stack([torch.zeros(t, dtype=torch.long, device=dev),
                          torch.ones(t, dtype=torch.long, device=dev)], 1)
        tv = torch.full((t, k), 0.5, device=dev)
    else:
        gates = torch.softmax(torch.randn(t, e, generator=g, device=dev), -1)
        tv, ti, _ = tm._gate_choices(gates, k)
    _, xs, gate, be, live = td._fused_layout(x, ti, tv, e, bn)
    return xs, gate, be, live, w_up, w_down


CARD_CASES = dict(CASES, bench_moe=(4096, 8, 2, 128, 512, 2048, False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain(cuda_device, dtype, case):
    """Each element within 1e-2·max|plain| + 2e-2·|plain| in bf16 (h is
    rounded to bf16 at the same point, the products sum in other orders),
    2e-5 + 1e-4·|plain| in f32 (exact FMAs against f32 GEMMs)."""
    t, e, k, bn, d, f, skewed = CARD_CASES[case]
    xs, gate, be, live, w_up, w_down = _card_layout(cuda_device, dtype, t, e,
                                                    k, bn, d, f, skewed)
    before = td.MOE_GMM.launches
    ys = td._gmm(be, xs, gate, w_up, w_down, bn, live)
    torch.cuda.synchronize()
    assert td.MOE_GMM.launches == before + 1
    want = td._gmm_plain(be, xs, gate, w_up, w_down, bn).float()
    if dtype == torch.bfloat16:
        lim = 1e-2 * want.abs().max() + 2e-2 * want.abs()
    else:
        lim = 2e-5 + 1e-4 * want.abs()
    ratio = ((ys.float() - want).abs() / lim).max().item()
    assert ratio <= 1.0, f"worst error/limit ratio {ratio}"


@pytest.mark.cuda
def test_fused_moe_mlp_on_the_card(cuda_device):
    """The whole layer on the card — K7 forward, the ragged remat
    backward — against the same call on the CPU (the plain version)."""
    x, w_up, w_down, ti, tv = _t(*_inputs("t64_e4_k2_b16"))
    outs, grads = [], []
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [a.to(dev).requires_grad_() for a in (x, w_up, w_down, tv)]
        before = td.MOE_GMM.launches
        out = td.fused_moe_mlp(leaves[0], leaves[1], leaves[2], ti.to(dev),
                               leaves[3], block_rows=16)
        out.square().sum().backward()
        assert td.MOE_GMM.launches == before + (dev.type == "cuda")
        outs.append(out.detach().cpu())
        grads.append([a.grad.cpu() for a in leaves])
    torch.testing.assert_close(outs[0], outs[1], atol=2e-5, rtol=1e-4)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d,f,bn,dtype,match", [
    (24, 64, 16, torch.bfloat16, "multiple of 16 up to 512"),
    (1024, 64, 16, torch.bfloat16, "multiple of 16 up to 512"),
    (32, 40, 16, torch.bfloat16, "d_ff a multiple of 16"),
    (32, 64, 12, torch.bfloat16, "block_rows a multiple of 8"),
    (32, 64, 16, torch.float16, "float32 or bfloat16"),
])
def test_unsupported_shapes_raise_on_the_card(cuda_device, d, f, bn, dtype,
                                              match):
    """A shape K7 cannot serve raises on a CUDA tensor — never the plain
    version — and launches nothing."""
    x = torch.randn(16, d, device=cuda_device).to(dtype)
    w_up = torch.randn(4, d, f, device=cuda_device).to(dtype)
    w_down = torch.randn(4, f, d, device=cuda_device).to(dtype)
    ti = torch.zeros(16, 2, dtype=torch.long, device=cuda_device)
    tv = torch.full((16, 2), 0.5, device=cuda_device)
    before = td.MOE_GMM.launches
    with pytest.raises(ValueError, match=match):
        td.fused_moe_mlp(x, w_up, w_down, ti, tv, block_rows=bn)
    assert td.MOE_GMM.launches == before


# ---- the live-row count: where the layout's trailing pad blocks start ------

# (t, e, k, block_rows, routing): routing "random" (top-k of softmaxed
# gates), "skewed" (every token on experts 0 and 1: the last experts
# empty), "middle_empty" (experts 1 and 2 never chosen), "last_only"
# (every choice on the last expert)
LIVE_CASES = {
    "random_b16": (64, 4, 2, 16, "random"),
    "random_b128": (300, 8, 2, 128, "random"),
    "skewed_b16": (48, 4, 2, 16, "skewed"),
    "middle_empty_b8": (40, 6, 2, 8, "middle_empty"),
    "last_only_b64": (70, 4, 1, 64, "last_only"),
}


def _routing(case):
    t, e, k, _, kind = LIVE_CASES[case]
    rng = np.random.default_rng(100 + sorted(LIVE_CASES).index(case))
    logits = rng.standard_normal((t, e)).astype(np.float32)
    if kind == "skewed":
        ti = np.stack([np.zeros(t, np.int64), np.ones(t, np.int64)], 1)
    elif kind == "last_only":
        ti = np.full((t, k), e - 1, np.int64)
    else:
        if kind == "middle_empty":
            logits[:, 1:3] = -1e9
        ti = np.argsort(-logits, axis=1)[:, :k].astype(np.int64)
    tv = rng.uniform(0.1, 1.0, (t, k)).astype(np.float32)
    x = rng.standard_normal((t, 16)).astype(np.float32)
    return x, ti, tv


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_live_rows_matches_jax_layout(jax_dispatch, case):
    """``_fused_layout``'s live-row count is the JAX layout's
    ``starts[-1]`` plus the last group padded to the block: every block
    past it holds no slot (gate 0, expert id clipped to e - 1), and there
    are at most E of them."""
    import jax.numpy as jnp
    from tpudist.models.moe import _counting_sort

    t, e, k, bn, _ = LIVE_CASES[case]
    x, ti, tv = _routing(case)
    _, _, sizes, starts, np_pad = _counting_sort(
        jnp.asarray(ti.reshape(-1), jnp.int32), e, block_rows=bn)
    want = int(starts[-1]) + -(-int(sizes[-1]) // bn) * bn
    _, xs, gate, be, live = td._fused_layout(*_t(x, ti, tv), e, bn)
    assert live.dtype == torch.int32 and live.dim() == 0
    assert int(live) == want
    assert int(live) % bn == 0 and int(live) <= np_pad == xs.shape[0]
    assert (np_pad - int(live)) // bn <= e
    assert not gate[int(live):].any()
    assert (be[int(live) // bn:] == e - 1).all()
    # every slot lands below the count
    pos = td._fused_layout(*_t(x, ti, tv), e, bn)[0]
    assert int(pos.max()) < int(live)


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_plain_gmm_gives_zero_pad_rows(case):
    """The plain version's rows past the live count are ``0 · finite``:
    exact zeros, which K7 writes there without a product."""
    t, e, k, bn, _ = LIVE_CASES[case]
    x, ti, tv = _routing(case)
    rng = np.random.default_rng(7)
    w_up = torch.from_numpy(rng.standard_normal((e, 16, 32), np.float32))
    w_down = torch.from_numpy(rng.standard_normal((e, 32, 16), np.float32))
    _, xs, gate, be, live = td._fused_layout(*_t(x, ti, tv), e, bn)
    ys = td._gmm(be, xs, gate, w_up, w_down, bn, live)
    assert ys.shape == xs.shape
    assert (ys[int(live):] == 0).all()


# ---- on the card: the wgmma path ------------------------------------------

# (t, e, k, block_rows, d, f, routing)
WGMMA_CASES = {
    "b128_d512": (2048, 8, 2, 128, 512, 1024, "random"),
    "b64_d512": (2048, 8, 2, 64, 512, 1024, "random"),
    "b128_d256": (1024, 4, 2, 128, 256, 512, "random"),
    "b64_d256": (1024, 4, 2, 64, 256, 512, "random"),
    "f_not_multiple_of_64": (1024, 4, 2, 128, 512, 1008, "random"),
    "expert_without_rows": (1024, 4, 2, 128, 256, 512, "middle_empty"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_wgmma_path_matches_plain(cuda_device, case):
    """bf16 at block_rows a multiple of 64 and d 256 or 512 takes the
    wgmma path: each element within 1e-2·max|plain| + 2e-2·|plain| (h
    rounded to bf16 at the same point, sums in other orders), the rows of
    the trailing pad blocks exactly zero, a second call bitwise equal."""
    t, e, k, bn, d, f, kind = WGMMA_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(t, d, generator=g, device=cuda_device).to(bf)
    w_up = (torch.randn(e, d, f, generator=g, device=cuda_device)
            / d ** 0.5).to(bf)
    w_down = (torch.randn(e, f, d, generator=g, device=cuda_device)
              / f ** 0.5).to(bf)
    gates = torch.softmax(torch.randn(t, e, generator=g, device=cuda_device),
                          -1)
    if kind == "middle_empty":
        gates[:, 1] = -1.0
    tv, ti, _ = tm._gate_choices(gates, k)
    _, xs, gate, be, live = td._fused_layout(x, ti, tv, e, bn)
    assert td.gmm_variant(bf, d, f, bn) == "wgmma"
    before = td.MOE_GMM.launches
    ys = td._gmm(be, xs, gate, w_up, w_down, bn, live)
    again = td._gmm(be, xs, gate, w_up, w_down, bn, live)
    torch.cuda.synchronize()
    assert td.MOE_GMM.launches == before + 2
    want = td._gmm_plain(be, xs, gate, w_up, w_down, bn).float()
    lim = 1e-2 * want.abs().max() + 2e-2 * want.abs()
    ratio = ((ys.float() - want).abs() / lim).max().item()
    assert ratio <= 1.0, f"worst error/limit ratio {ratio}"
    assert (ys[int(live):] == 0).all()
    assert torch.equal(ys, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,f,bn,want", [
    (torch.bfloat16, 512, 2048, 128, "wgmma"),
    (torch.bfloat16, 256, 512, 64, "wgmma"),
    (torch.bfloat16, 512, 2048, 16, "mma.sync"),
    (torch.bfloat16, 128, 512, 128, "mma.sync"),
    (torch.float32, 512, 2048, 128, "mma.sync"),
])
def test_variant_follows_dtype_and_shape(cuda_device, dtype, d, f, bn, want):
    """The path is chosen by dtype and shape alone, as the kernel library
    reports it."""
    assert td.gmm_variant(dtype, d, f, bn) == want


@pytest.mark.cuda
def test_variant_of_an_unserved_shape_raises(cuda_device):
    with pytest.raises(ValueError, match="no path"):
        td.gmm_variant(torch.bfloat16, 24, 64, 16)
