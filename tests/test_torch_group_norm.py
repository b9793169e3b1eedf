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


# ResNet50's GroupNorm site shapes at 128 px, (H·W, C) with their modes
# (chip_smoke.GN_SITE_SHAPES)
SITE_SHAPES = (
    ((4096, 64), ("relu",)), ((1024, 64), ("relu",)),
    ((1024, 128), ("relu",)), ((1024, 256), ("add_relu", "plain")),
    ((256, 128), ("relu",)), ((256, 256), ("relu",)),
    ((256, 512), ("add_relu", "plain")), ((64, 256), ("relu",)),
    ((64, 512), ("relu",)), ((64, 1024), ("add_relu", "plain")),
    ((16, 512), ("relu",)), ((16, 2048), ("add_relu", "plain")))
PLAN_CASES = [(128, hw, c, torch.bfloat16, mode)
              for (hw, c), modes in SITE_SHAPES for mode in modes] + [
    (64, 12544, 64, torch.bfloat16, "relu"),      # the 224 px stem
    (32, 1024, 256, torch.float32, "add_relu"),   # the f32 layer1 tail
    (2, 1, 64, torch.bfloat16, "relu"), (2, 35, 16, torch.float32, "plain"),
    (2, 5, 4096, torch.bfloat16, "add_relu")]


@pytest.mark.parametrize("backward", [False, True], ids=["K9", "K10"])
@pytest.mark.parametrize("b,hw,c,dtype,mode", PLAN_CASES)
def test_splits_cover_every_row(b, hw, c, dtype, mode, backward):
    """The planner's CTA split of a sample (``_gn_plan``): balanced whole
    rows, none empty, covering the slab; a cluster of at most 8 CTAs
    within the card's shared memory; the two-pass splits about 8,192
    elements a CTA."""
    plan = tg._gn_plan(b, hw, c, dtype, mode, backward)
    es = dtype.itemsize
    bounds = [p * hw // plan.parts for p in range(plan.parts + 1)]
    assert bounds[0] == 0 and bounds[-1] == hw
    assert all(r1 > r0 for r0, r1 in zip(bounds, bounds[1:]))
    assert max(r1 - r0 for r0, r1 in zip(bounds, bounds[1:])) == plan.rows
    assert plan.threads % 32 == 0 and plan.threads >= c * es // 16
    assert plan.smem <= 232_448
    if plan.path == "cluster":
        assert 1 <= plan.parts <= 8
        assert plan.rows * c * es <= tg._HOLD_CAP   # a CTA's rows of x
        if plan.parts > 1:   # the smallest cluster that holds the slab
            assert -(-hw // (plan.parts // 2)) * c * es > tg._HOLD_CAP
    else:
        assert plan.path == "two_pass"
        if hw * c >= 2 * tg._ELEMS_PER_CTA:
            assert plan.rows * c <= 2 * tg._ELEMS_PER_CTA


@pytest.mark.parametrize("backward", [False, True], ids=["K9", "K10"])
@pytest.mark.parametrize("b,hw,c,dtype,mode", PLAN_CASES[:-3])
def test_plan_paths_at_resnet_sites(b, hw, c, dtype, mode, backward):
    """Every ResNet50 site shape at batch 128 in bf16 takes the cluster
    path in both directions (the largest slabs, 4096 × 64 and 1024 × 256,
    with a full cluster of 8, the smallest with one CTA a sample); the
    224 px stem takes the two-pass path in both, the f32 layer1 tail too
    (1 MB of x a sample: 128 KB a CTA of a full cluster)."""
    plan = tg._gn_plan(b, hw, c, dtype, mode, backward)
    if hw == 12544 or dtype == torch.float32:
        assert plan.path == "two_pass", plan
    else:
        assert plan.path == "cluster", plan
        big = hw * c * 2 == 512 * 1024
        assert plan.parts == 8 if big else plan.parts <= 4, plan
        if hw == 16:
            assert plan.parts == 1, plan


def test_plan_forced_paths_and_checks():
    """``path`` forces a plan; the cluster path raises where a CTA's
    shared memory would not fit, and an unknown path raises."""
    stem = (64, 12544, 64, torch.bfloat16, "relu")
    forced = tg._gn_plan(*stem, True, path="cluster")
    assert (forced.path, forced.parts, forced.rows) == ("cluster", 8, 1568)
    with pytest.raises(ValueError, match="shared memory"):
        tg._gn_plan(64, 12544, 64, torch.float32, "relu", False,
                    path="cluster")
    assert tg._gn_plan(128, 1024, 256, torch.bfloat16, "relu", True,
                       path="two_pass").path == "two_pass"
    with pytest.raises(ValueError, match="unknown group_norm path"):
        tg._gn_plan(128, 1024, 256, torch.bfloat16, "relu", True,
                    path="one_pass")
    # a card with less shared memory sends the tail's backward two-pass
    assert tg._gn_plan(128, 1024, 256, torch.bfloat16, "add_relu", True,
                       60_000).path == "two_pass"


def test_cpu_calls_leave_path_counts(jgn):
    """A CPU tensor takes the plain versions: no launch, no path count."""
    x, scale, bias, _, dy = _data((2, 4, 4, 64), seed=4)
    before = {k: dict(v) for k, v in tg.PATH_LAUNCHES.items()}
    launches = (tg.GN_FWD.launches, tg.GN_BWD.launches)
    xt = torch.from_numpy(x).requires_grad_()
    y = tg.group_norm_act(xt, torch.from_numpy(scale),
                          torch.from_numpy(bias), 32, EPS, "relu")
    y.backward(torch.from_numpy(dy))
    assert tg.PATH_LAUNCHES == before
    assert (tg.GN_FWD.launches, tg.GN_BWD.launches) == launches


@pytest.mark.parametrize("mode", ["plain", "relu", "add_relu"])
def test_bwd_plain_per_sample_partials_match_pallas(jgn, mode):
    """K10's plain version returns one ``[C]`` row of dγ and dβ partials
    a sample; each row equals tpudist's Pallas kernel (interpret mode) on
    that sample alone, whose summed partials are the sample's own."""
    import jax.numpy as jnp

    shape, groups = (3, 4, 4, 64), 32
    x, scale, bias, res, dy = _data(shape, seed=6)
    r = res if mode == "add_relu" else None
    xt, st, bt = (torch.from_numpy(a) for a in (x, scale, bias))
    rt = None if r is None else torch.from_numpy(r)
    _, mean, rstd = tg._fused_call_fwd(xt, st, bt, rt, groups, EPS, mode)
    b, h, w, c = shape

    def flat(a):
        return None if a is None else torch.from_numpy(a).reshape(b, h * w, c)

    _, pds, pdb, _ = tg._fused_bwd_plain(flat(x), flat(dy), st, bt, mean,
                                         rstd, flat(r), groups, mode)
    assert pds.shape == pdb.shape == (b, c)
    for i in range(b):
        sl = slice(i, i + 1)
        jr = None if r is None else jnp.asarray(r[sl])
        _, jmean, jrstd = jgn._fused_call_fwd(
            jnp.asarray(x[sl]), jnp.asarray(scale), jnp.asarray(bias), jr,
            groups, EPS, mode)
        _, jds, jdb, _ = jgn._fused_call_bwd(
            jnp.asarray(x[sl]), jnp.asarray(dy[sl]), jnp.asarray(scale),
            jnp.asarray(bias), jmean, jrstd, jr, groups, mode)
        np.testing.assert_allclose(pds[i].numpy(), np.asarray(jds),
                                   **GRAD_TOL)
        np.testing.assert_allclose(pdb[i].numpy(), np.asarray(jdb),
                                   **GRAD_TOL)


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


def _card_inputs(shape, dtype, device, seed=0):
    """``(x, scale, bias, res, dy)`` on the card; x with a mean of its own
    in each channel."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=device)

    res, dy = (rnd(*shape).to(dtype) for _ in range(2))
    x = (rnd(*shape) + rnd(shape[-1])).to(dtype)
    return x, 1 + 0.1 * rnd(shape[-1]), 0.1 * rnd(shape[-1]), res, dy


def _hold_kernels_to_plain(x, scale, bias, res, dy, groups, mode, dtype,
                           path):
    """Both kernels on ``path`` against the plain versions on the same
    inputs, the path each took, and a second call bitwise equal:
    f32 within 1e-5·|plain| + 1e-5·max|plain| (sums in other orders: a
    dscale element sums B·H·W terms, so its rounding follows the terms'
    size, not its own); bf16 outputs within one bf16 rounding of the f32
    value (2^-8 relative) plus 1e-2 of the tensor's max, as dx sums
    rounded bf16 terms in other orders."""
    r = res if mode == "add_relu" else None
    if path == "cluster":
        b, h, w, c = x.shape
        try:
            tg._gn_plan(b, h * w, c, dtype, mode, True,
                        tg._smem_optin(x.device), groups, "cluster")
        except ValueError:
            pytest.skip("the cluster path does not fit this slab's "
                        "backward in the card's shared memory")
    k9, k10 = tg.GN_FWD.launches, tg.GN_BWD.launches
    y, mean, rstd = tg._fused_call_fwd(x, scale, bias, r, groups, EPS, mode,
                                       path)
    assert tg.LAST_PATH["K9"] == path
    got_b = tg._fused_call_bwd(x, dy, scale, bias, mean, rstd, r, groups,
                               mode, path)
    assert tg.LAST_PATH["K10"] == path
    again = (tg._fused_call_fwd(x, scale, bias, r, groups, EPS, mode, path)
             + tg._fused_call_bwd(x, dy, scale, bias, mean, rstd, r, groups,
                                  mode, path))
    torch.cuda.synchronize()
    assert (tg.GN_FWD.launches, tg.GN_BWD.launches) == (k9 + 2, k10 + 2)
    for a, e in zip(again, (y, mean, rstd) + got_b):
        assert (a is None and e is None) or torch.equal(a, e)
    b, h, w, c = x.shape

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


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cluster", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "relu", "add_relu"])
@pytest.mark.parametrize("case", sorted(CARD_SHAPES))
def test_kernels_match_plain(cuda_device, case, mode, dtype, path):
    """y, mean, rstd, dx, dscale, dbias and dres from K9/K10 on each path
    against the plain versions on the same card inputs."""
    shape, groups = CARD_SHAPES[case]
    _hold_kernels_to_plain(*_card_inputs(shape, dtype, cuda_device), groups,
                           mode, dtype, path)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cluster", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,c,mode", [
    (hw, c, mode) for (hw, c), modes in SITE_SHAPES for mode in modes])
def test_kernels_match_plain_at_sites(cuda_device, hw, c, mode, dtype, path):
    """Both paths at every ResNet50 site slab (batch 2), mode and dtype
    (the cluster path is skipped where the planner's own check finds that
    its backward would not fit the card's shared memory: the f32 slabs of
    4096 × 64 and 1024 × 256)."""
    h = int(round(hw ** 0.5))
    _hold_kernels_to_plain(*_card_inputs((2, h, h, c), dtype, cuda_device,
                                         seed=hw + c), 32, mode, dtype, path)


@pytest.mark.cuda
def test_planned_paths_on_the_card(cuda_device):
    """The wrapper takes the planner's path and counts it: the layer1
    tail at batch 128 on the cluster path, the 224 px stem (batch 2) on
    the two-pass path, and the library's shared memory is the plan's
    (``_cluster_fit`` raises otherwise)."""
    tg.reset_path_launches()
    for shape, path in (((128, 32, 32, 256), "cluster"),
                        ((2, 112, 112, 64), "two_pass")):
        x, scale, bias, res, dy = _card_inputs(shape, torch.bfloat16,
                                               cuda_device)
        y, mean, rstd = tg._fused_call_fwd(x, scale, bias, res, 32, EPS,
                                           "add_relu")
        tg._fused_call_bwd(x, dy, scale, bias, mean, rstd, res, 32,
                           "add_relu")
        assert tg.LAST_PATH == {"K9": path, "K10": path}
    torch.cuda.synchronize()
    assert tg.PATH_LAUNCHES == {k: {"two_pass": 1, "cluster": 1}
                                for k in ("K9", "K10")}


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [256, 512])
@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["relu", "add_relu"])
def test_every_cluster_size_and_width(cuda_device, mode, parts, threads):
    """The cluster path forced to each cluster size and CTA width at a 32
    × 32 × 64 bf16 slab: a CTA's rows then split into commit groups that
    end inside a batch of loads (2 rows a thread at 512 threads and 8
    CTAs), which the kernels must neither skip nor repeat."""
    shape = (2, 32, 32, 64)
    x, scale, bias, res, dy = _card_inputs(shape, torch.bfloat16,
                                           cuda_device, seed=parts)
    rows = -(-1024 // parts)
    plans = [tg.GnPlan("cluster", parts, rows, threads, tg._cluster_smem(
        rows, 64, 32, 2, threads // 8, backward)) for backward in (0, 1)]
    r = res if mode == "add_relu" else None
    y, mean, rstd = tg._fused_call_fwd(x, scale, bias, r, 32, EPS, mode,
                                       plans[0])
    dx, _, _, _ = tg._fused_call_bwd(x, dy, scale, bias, mean, rstd, r, 32,
                                     mode, plans[1])
    b, h, w, c = shape
    flat = (lambda t: None if t is None else t.reshape(b, h * w, c))
    py, pmean, prstd = tg._fused_fwd_plain(flat(x), scale, bias, flat(r), 32,
                                           EPS, mode)
    pdx = tg._fused_bwd_plain(flat(x), flat(dy), scale, bias, mean, rstd,
                              flat(r), 32, mode)[0]
    torch.testing.assert_close(mean, pmean, rtol=1e-5, atol=1e-5)
    for a, e in ((y, py), (dx, pdx)):
        a, e = a.float().reshape(-1), e.float().reshape(-1)
        assert ((a - e).abs() <= 2 ** -8 * e.abs()
                + 1e-2 * e.abs().max()).all()
