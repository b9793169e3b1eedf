"""tpudist_torch's GroupNorm against the JAX package's
(:mod:`tpudist.ops.group_norm`), on the same seeded numpy inputs.

* The closed form (``group_norm``) at ``tests/test_group_norm.py``'s
  shapes (odd spatial sizes, one group): forward within 1e-5, the VJP of
  ``sum(tanh(gn))`` within 1e-4.
* K9's and K10's plain versions (what a CPU tensor takes) in each mode
  against ``group_norm_act`` / ``group_norm_add_relu``, whose Pallas
  kernels run in interpret mode on the CPU: forward within 1e-5, every VJP
  output within 1e-4, ``mean``/``rstd`` against ``_fused_call_fwd``'s
  within 1e-5; at C = 64, G = 32 (two channels a group) and a 4×4 slab,
  both of which occur in ResNet50.
* bf16 inputs within tpudist's own 0.06.
* A slab over tpudist's 2 MB switch: the port's fused module (no switch)
  against tpudist's, which falls back to the closed form there.

The ``cuda`` tests hold K9 and K10 against their plain versions on the
card.  The JAX package is imported inside a fixture, so on a card host
without flax they still run.
"""

import importlib

import numpy as np
import pytest
import torch

from tpudist_torch.ops import group_norm as tg

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
EPS = 1e-6


@pytest.fixture(scope="module")
def jgn():
    """The JAX package's ``group_norm`` module (Pallas in interpret mode
    on the CPU)."""
    pytest.importorskip("flax", reason="the JAX reference needs jax + flax")
    return importlib.import_module("tpudist.ops.group_norm")


def _data(shape, seed=0):
    """``(x, scale, bias, residual, dy)`` as f32 numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _leaves(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


# ---- the closed form -------------------------------------------------------

@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 32), 32),
    ((3, 4, 4, 64), 32),
    ((2, 5, 7, 16), 4),   # odd spatial dims
    ((1, 2, 2, 8), 1),    # one group
])
def test_group_norm_matches_jax(jgn, shape, groups):
    import jax
    import jax.numpy as jnp

    x, scale, bias, _, _ = _data(shape)
    want = jgn.group_norm(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias), groups)
    gwant = jax.grad(lambda *a: jnp.sum(jnp.tanh(jgn.group_norm(*a, groups))),
                     argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias))
    xt, st, bt = _leaves(x, scale, bias)
    got = tg.group_norm(xt, st, bt, groups)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    torch.tanh(got).sum().backward()
    for t, w, name in zip((xt, st, bt), gwant, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_group_norm_bf16_io_f32_stats():
    """bf16 in and out, f32 statistics; the gradients keep their dtypes."""
    x, scale, bias, _, _ = _data((2, 8, 8, 32), seed=1)
    x16 = torch.from_numpy(x).bfloat16().requires_grad_()
    st = torch.ones(32, requires_grad=True)
    bt = torch.zeros(32, requires_grad=True)
    y = tg.group_norm(x16, st, bt, 8)
    assert y.dtype == torch.bfloat16
    y32 = tg.group_norm(x16.detach().float(), st, bt, 8)
    np.testing.assert_allclose(y.float().detach().numpy(),
                               y32.detach().numpy(), rtol=0.05, atol=0.05)
    y.float().sum().backward()
    assert x16.grad.dtype == torch.bfloat16 and st.grad.dtype == torch.float32


# ---- K9 and K10's plain versions against the Pallas kernels ---------------

FUSED_SHAPES = {
    "tpudist_data": ((3, 4, 6, 32), 8),   # tests/test_group_norm.py's
    "c64_g32_4x4": ((2, 4, 4, 64), 32),   # two channels a group, 16 rows
    "odd_5x7": ((2, 5, 7, 16), 4),
}


@pytest.mark.parametrize("mode", ["plain", "relu", "add_relu"])
@pytest.mark.parametrize("case", sorted(FUSED_SHAPES))
def test_fused_plain_matches_pallas(jgn, case, mode):
    """Forward, mean/rstd and every VJP output of the fused op, the
    port's plain versions against tpudist's Pallas kernels."""
    import jax
    import jax.numpy as jnp

    shape, groups = FUSED_SHAPES[case]
    x, scale, bias, res, dy = _data(shape, seed=sorted(FUSED_SHAPES).index(
        case))
    jargs = [jnp.asarray(a) for a in (x, scale, bias)]
    targs = _leaves(x, scale, bias)
    if mode == "add_relu":
        jargs.append(jnp.asarray(res))
        targs += _leaves(res)

        def jfn(*a):
            return jgn.group_norm_add_relu(*a, groups, EPS)

        got = tg.group_norm_add_relu(*targs, groups, EPS)
    else:
        def jfn(*a):
            return jgn.group_norm_act(*a, groups, EPS, mode)

        got = tg.group_norm_act(*targs, groups, EPS, mode)
    want, vjp = jax.vjp(jfn, *jargs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    grads = torch.autograd.grad(got, targs, torch.from_numpy(dy))
    for g, w, name in zip(grads, vjp(jnp.asarray(dy)),
                          ("dx", "dscale", "dbias", "dres")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)
    r = None if mode != "add_relu" else res
    _, jmean, jrstd = jgn._fused_call_fwd(
        *jargs[:3], None if r is None else jnp.asarray(r), groups, EPS, mode)
    _, mean, rstd = tg._fused_call_fwd(
        *(t.detach() for t in targs[:3]),
        None if r is None else torch.from_numpy(r), groups, EPS, mode)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0],
                               **FWD_TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0],
                               **FWD_TOL)


@pytest.mark.parametrize("mode", ["relu", "add_relu"])
def test_fused_bf16_matches_jax(jgn, mode):
    """bf16 input (and residual): within tpudist's 0.06 of the f32
    reference, as tpudist holds its own kernels, and of tpudist's bf16
    output."""
    import jax
    import jax.numpy as jnp

    x, scale, bias, res, _ = _data((3, 4, 6, 32), seed=3)
    g = 8
    xb, rb = (jnp.asarray(a, jnp.bfloat16) for a in (x, res))
    xt, rt = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (xb, rb))
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    js, jb = jnp.asarray(scale), jnp.asarray(bias)
    if mode == "add_relu":
        got = tg.group_norm_add_relu(xt, st, bt, rt, g, EPS)
        ref16 = jgn.group_norm_add_relu(xb, js, jb, rb, g, EPS)
        ref32 = jax.nn.relu(jgn.group_norm(jnp.asarray(x), js, jb, g)
                            + jnp.asarray(res))
    else:
        got = tg.group_norm_act(xt, st, bt, g, EPS, "relu")
        ref16 = jgn.group_norm_act(xb, js, jb, g, EPS, "relu")
        ref32 = jax.nn.relu(jgn.group_norm(jnp.asarray(x), js, jb, g))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(ref32), rtol=0.06, atol=0.06)
    np.testing.assert_allclose(got, np.asarray(ref16.astype(jnp.float32)),
                               rtol=0.06, atol=0.06)


@pytest.mark.parametrize("fused", ["relu", "add_relu"])
def test_slab_over_2mb_matches_tpudist_module(jgn, fused):
    """A 96×96×64 f32 slab (2.36 MB a sample) is over tpudist's 2 MB
    switch: tpudist's module takes the closed form there, the port's the
    fused op (no switch).  Forward and every gradient agree."""
    import jax
    import jax.numpy as jnp

    shape = (1, 96, 96, 64)
    assert 96 * 96 * 64 * 4 > jgn._FUSED_SLAB_LIMIT_BYTES
    x, scale, bias, res, dy = _data(shape, seed=5)
    mod = jgn.GroupNorm(num_groups=32, fused=fused)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    jargs = [jnp.asarray(x)] + ([jnp.asarray(res)] if fused == "add_relu"
                                else [])

    def jfn(p, *a):
        return mod.apply({"params": p}, *a)

    want, vjp = jax.vjp(jfn, params, *jargs)
    jgrads = vjp(jnp.asarray(dy))
    port = tg.GroupNorm(64, 32, fused=fused, device="cpu")
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    targs = _leaves(*([x] + ([res] if fused == "add_relu" else [])))
    got = port(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    grads = torch.autograd.grad(got, [port.scale, port.bias] + targs,
                                torch.from_numpy(dy))
    want_g = [jgrads[0]["scale"], jgrads[0]["bias"], *jgrads[1:]]
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_module_param_compat_and_checks(jgn):
    """The port's GroupNorm holds tpudist's param tree (``scale``/``bias``
    of [C]) and gives tpudist's output from it, in every mode; a residual
    is taken exactly in add_relu mode."""
    import jax
    import jax.numpy as jnp

    x, scale, bias, res, _ = _data((2, 4, 4, 16), seed=2)
    p = jgn.GroupNormFast(num_groups=4).init(jax.random.key(0),
                                             jnp.asarray(x))["params"]
    port = tg.GroupNormFast(16, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    for fused, extra in (("none", ()), ("relu", ()), ("add_relu", (res,))):
        want = jgn.GroupNormFast(num_groups=4, fused=fused).apply(
            {"params": params}, jnp.asarray(x),
            *(jnp.asarray(a) for a in extra))
        mod = tg.GroupNorm(16, 4, fused=fused, device="cpu")
        mod.load_state_dict({"scale": torch.from_numpy(scale),
                             "bias": torch.from_numpy(bias)})
        got = mod(torch.from_numpy(x), *(torch.from_numpy(a) for a in extra))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD_TOL)
    xt, rt = torch.from_numpy(x), torch.from_numpy(res)
    with pytest.raises(ValueError, match="residual"):
        tg.GroupNorm(16, 4, fused="relu", device="cpu")(xt, rt)
    with pytest.raises(ValueError, match="residual"):
        tg.GroupNorm(16, 4, fused="add_relu", device="cpu")(xt)
    with pytest.raises(ValueError, match="not divisible"):
        tg.GroupNorm(18, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown fused mode"):
        tg.GroupNorm(16, 4, fused="gelu", device="cpu")
    out = tg.GroupNorm(16, 4, dtype=torch.bfloat16, device="cpu")(xt)
    assert out.dtype == torch.bfloat16


def test_splits_cover_every_row():
    """The kernels' CTA split of a sample: whole rows, none empty, about
    8,192 elements a CTA, at each ResNet50 site shape."""
    for hw, c in ((4096, 64), (1024, 256), (16, 2048), (16, 512), (1, 64),
                  (12544, 64), (35, 16)):
        s = tg._splits(hw, c)
        rows = -(-hw // s)
        assert 1 <= s <= hw and (s - 1) * rows < hw <= s * rows
        if hw * c >= 2 * tg._ELEMS_PER_CTA:
            assert rows * c <= 2 * tg._ELEMS_PER_CTA


# ---- on the card: K9 and K10 against their plain versions ------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K9 and K10 have no CPU "
                    "mode)")
    return torch.device("cuda")


CARD_SHAPES = {
    "c64_g32_4x4": ((2, 4, 4, 64), 32),
    "odd_5x7": ((3, 5, 7, 32), 4),
    "layer1_tail": ((4, 32, 32, 256), 32),
    "layer4_tail": ((4, 4, 4, 2048), 32),
    "one_group": ((2, 6, 6, 64), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "relu", "add_relu"])
@pytest.mark.parametrize("case", sorted(CARD_SHAPES))
def test_kernels_match_plain(cuda_device, case, mode, dtype):
    """y, mean, rstd, dx, dscale, dbias and dres from K9/K10 against the
    plain versions on the same card inputs: f32 within 1e-5·|plain| +
    1e-5·max|plain| (sums in other orders: a dscale element sums B·H·W
    terms, so its rounding follows the terms' size, not its own); bf16
    outputs within one bf16 rounding of the f32 value (2^-8 relative)
    plus 1e-2 of the tensor's max, as dx sums rounded bf16 terms in other
    orders."""
    shape, groups = CARD_SHAPES[case]
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda_device)

    res, dy = (rnd(*shape).to(dtype) for _ in range(2))
    x = (rnd(*shape) + rnd(shape[-1])).to(dtype)   # a mean per channel
    scale, bias = 1 + 0.1 * rnd(shape[-1]), 0.1 * rnd(shape[-1])
    r = res if mode == "add_relu" else None
    k9, k10 = tg.GN_FWD.launches, tg.GN_BWD.launches
    y, mean, rstd = tg._fused_call_fwd(x, scale, bias, r, groups, EPS, mode)
    got_b = tg._fused_call_bwd(x, dy, scale, bias, mean, rstd, r, groups,
                               mode)
    torch.cuda.synchronize()
    assert (tg.GN_FWD.launches, tg.GN_BWD.launches) == (k9 + 1, k10 + 1)
    b, h, w, c = shape

    def flat(t):
        return None if t is None else t.reshape(b, h * w, c)

    py, pmean, prstd = tg._fused_fwd_plain(flat(x), scale, bias, flat(r),
                                           groups, EPS, mode)
    # the backward's plain version from the kernel's statistics, so both
    # see one mask
    pdx, pds, pdb, pdres = tg._fused_bwd_plain(flat(x), flat(dy), scale,
                                               bias, mean, rstd, flat(r),
                                               groups, mode)
    want_b = (pdx, pds.sum(0), pdb.sum(0), pdres)
    for name, a, e in (("mean", mean, pmean), ("rstd", rstd, prstd)):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5, msg=name)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -8
    for name, a, e in zip(("y", "dx", "dscale", "dbias", "dres"),
                          (y,) + got_b, (py,) + want_b):
        if e is None:
            assert a is None
            continue
        a, e = a.float().reshape(-1), e.float().reshape(-1)
        lim = rel * e.abs() + (1e-5 if dtype == torch.float32
                               else 1e-2) * e.abs().max()
        assert ((a - e).abs() <= lim).all(), (name, (a - e).abs().max())
