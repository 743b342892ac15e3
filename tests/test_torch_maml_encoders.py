"""Port parity of the encoders' and trunc_exp's double backwards, which
second-order MAML takes through its inner loop: the plane encoder's
(kernels 5'' and 6'', `PlaneEncodeBwd`), the hash encoder's (row 7c'',
`HashEncodeBwd`: kernel 7a on the table cotangent) and trunc_exp's (row
12), against the JAX package's autodiff of its own VJPs (the
compositor's is in tests/test_torch_maml_ops.py).

For the cotangent ct of the encode and the cotangents v of its table
gradients, both sides take the gradient of <v, VJP(ct)> in (tables, ct)
(JAX: `jax.grad` of the contraction through `jax.vjp`, jit disabled; the
port: `torch.autograd.grad(..., create_graph=True)` through its autograd
Function, with the kernel wrappers and with use_kernels=False), from the
same numpy inputs. Tolerance 1e-5 of each output's max (measured <=
3.2e-7 for the plane encoder, light mode included: its bf16 residuals
and bf16 cotangents round alike on both sides at these sizes, and <=
1.5e-7 for the hash encoder; the rest is summation order). The light
plane tables differ from the exact ones by far more than that (the bf16
rounding of the cotangent), which the light cases check. Each plain
version has a float64 `torch.autograd.gradgradcheck`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import activations as JA
from nerfsys_tpu.ops import encodings as JE
from nerfsys_tpu.ops import planes as JP
from nerfsys_tpu_torch.ops import activations as TA
from nerfsys_tpu_torch.ops import encodings as TE
from nerfsys_tpu_torch.ops import planes as TP
from test_torch_grads import _planes, _x
from test_torch_hash import SMALL, _cfgs, _points

TOL = 1e-5  # of each output's max


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    if scale == 0:
        return float(np.abs(got).max())
    return float(np.abs(got - want).max() / scale)


def _t(x, grad=False):
    if x is None:
        return None
    return torch.tensor(np.ascontiguousarray(x), requires_grad=grad)


# ------------------------------- trunc_exp -----------------------------------
X_EXP = np.array([-100.0, -88.7, -20.0, -1.0, 0.0, 3.0, 50.0, 88.7, 88.8,
                  100.0], np.float32)


def test_trunc_exp_second_derivative_matches_jax():
    """d/dx of (v * g * y): y inside the clamp, y / 2 at it (JAX's tie at
    jnp.clip), 0 beyond, where the saved output's own graph would give y
    everywhere. XLA flushes the denormal exp(-88.7) to 0."""
    c = np.linspace(1e-3, 2e-3, X_EXP.size).astype(np.float32)
    v = np.full(X_EXP.size, 1e-3, np.float32)
    with jax.disable_jit():
        want = jax.grad(lambda x: jnp.sum(jax.grad(
            lambda z: jnp.sum(JA.trunc_exp(z) * c))(x) * v))(
                jnp.asarray(X_EXP))
    x = _t(X_EXP, grad=True)
    g, = torch.autograd.grad((TA.trunc_exp(x) * _t(c)).sum(), x,
                             create_graph=True)
    got, = torch.autograd.grad((g * _t(v)).sum(), x)
    want = np.asarray(want)
    big = np.abs(want) > 1e-30
    np.testing.assert_allclose(got.numpy()[big], want[big], rtol=1e-6)
    assert np.all(np.abs(got.numpy()[~big]) < 1e-30)
    inside = got.numpy()[7] / (c[7] * v[7] * np.exp(np.float32(88.7)))
    assert inside == pytest.approx(0.5, rel=1e-6)  # at the clamp: half
    assert got.numpy()[8] == 0.0 and got.numpy()[9] == 0.0  # beyond


def test_trunc_exp_first_derivative_unchanged_without_create_graph():
    x = _t(X_EXP, grad=True)
    TA.trunc_exp(x).sum().backward()
    y = torch.exp(torch.clamp(torch.tensor(X_EXP), -88.7, 88.7))
    torch.testing.assert_close(x.grad, y, rtol=0, atol=0)


def test_trunc_exp_gradgradcheck():
    x = torch.tensor([-3.0, -0.5, 0.2, 1.5, 4.0], dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradgradcheck(TA.trunc_exp, (x,))


# ------------------------------- plane encoder -------------------------------
def _plane_setup(pos_grad, lines, stacked, seed=0):
    jcfg, tcfg, params = _planes(pos_grad=pos_grad, seed=seed)
    if not lines:
        params.pop("lines")
        jcfg = dataclasses.replace(jcfg, include_lines=False)
        tcfg = dataclasses.replace(tcfg, include_lines=False)
    rng = np.random.default_rng(seed + 1)
    if stacked:
        _, _, p1 = _planes(pos_grad=pos_grad, seed=seed + 5)
        params = {k: [np.stack([a, b]) for a, b in zip(params[k], p1[k])]
                  for k in params}
        x = np.stack([_x(160, seed=2), _x(160, seed=3)])
    else:
        x = _x(300)
    ct = rng.normal(size=(*x.shape[:-1], tcfg.out_dim)).astype(np.float32)
    v = {k: [rng.normal(size=a.shape).astype(np.float32) for a in vs]
         for k, vs in params.items()}
    return jcfg, tcfg, params, x, ct, v


KEYS = ("planes", "lines")


def _jax_plane_bwd2(jcfg, params, x, ct, v):
    """jax.grad of <v, vjp(ct)> in (tables, ct), per expert when stacked
    (the reference encodes one expert's tables)."""
    if x.ndim == 3:
        outs = [_jax_plane_bwd2(jcfg, {k: [a[e] for a in vs]
                                       for k, vs in params.items()},
                                x[e], ct[e], {k: [a[e] for a in vs]
                                              for k, vs in v.items()})
                for e in range(x.shape[0])]
        return ({k: [np.stack([o[0][k][l] for o in outs])
                     for l in range(len(params[k]))] for k in params},
                np.stack([o[1] for o in outs]))

    def psi(p, c):
        _, vjp = jax.vjp(lambda q: JP.plane_encode(q, jnp.asarray(x), jcfg),
                         p)
        (g,) = vjp(c)
        return sum(jnp.sum(g[k][l] * v[k][l]) for k in v
                   for l in range(len(v[k])))

    with jax.disable_jit():
        dp, dc = jax.grad(psi, argnums=(0, 1))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ct))
    return jax.tree_util.tree_map(np.asarray, dp), np.asarray(dc)


def _port_plane_bwd2(tcfg, params, x, ct, v, use_kernels=True):
    tabs = {k: [_t(a, grad=True) for a in params[k]] for k in KEYS
            if k in params}
    c = _t(ct, grad=True)
    y = TP.plane_encode(tabs, _t(x), tcfg, use_kernels=use_kernels)
    leaves = [a for k in KEYS if k in tabs for a in tabs[k]]
    g = torch.autograd.grad(y, leaves, c, create_graph=True)
    vs = [_t(a) for k in KEYS if k in v for a in v[k]]
    psi = sum((a * b).sum() for a, b in zip(g, vs))
    d = torch.autograd.grad(psi, leaves + [c], allow_unused=True)
    d = [torch.zeros_like(w) if a is None else a
         for a, w in zip(d, leaves + [c])]
    out, i = {}, 0
    for k in KEYS:
        if k in tabs:
            out[k] = [a.numpy() for a in d[i:i + len(tabs[k])]]
            i += len(tabs[k])
    return out, d[-1].numpy()


PLANE_CASES = [(pg, ln, st) for pg in (False, True) for ln in (True, False)
               for st in (False, True)]
PLANE_IDS = [f"{'exact' if pg else 'light'}-{'lines' if ln else 'nolines'}"
             f"-{'K2' if st else 'K1'}" for pg, ln, st in PLANE_CASES]


@pytest.mark.parametrize("pos_grad,lines,stacked", PLANE_CASES,
                         ids=PLANE_IDS)
def test_plane_bwd2_matches_jax(pos_grad, lines, stacked):
    jcfg, tcfg, params, x, ct, v = _plane_setup(pos_grad, lines, stacked)
    want_p, want_c = _jax_plane_bwd2(jcfg, params, x, ct, v)
    for use_kernels in (True, False):
        got_p, got_c = _port_plane_bwd2(tcfg, params, x, ct, v, use_kernels)
        assert _rel(got_c, want_c) <= TOL
        for k in got_p:
            for a, b in zip(got_p[k], want_p[k]):
                assert _rel(a, b) <= TOL
    if not lines:  # G = scatter(ct) does not depend on the tables
        assert all(np.all(a == 0) for a in got_p["planes"])
    if not pos_grad and lines:  # the bf16 cotangents are not the exact ones
        jexact = dataclasses.replace(jcfg, pos_grad=True)
        exact_p, _ = _jax_plane_bwd2(jexact, params, x, ct, v)
        for k in KEYS:
            for a, b in zip(got_p[k], exact_p[k]):
                assert _rel(a, b) > 10 * TOL


@pytest.mark.parametrize("pos_grad,lines,stacked", PLANE_CASES,
                         ids=PLANE_IDS)
def test_plane_bwd2_plain_is_autograd_of_bwd_plain(pos_grad, lines, stacked):
    """`plane_encode_bwd2_plain` (the explicit formula the kernels follow)
    equals autograd through `plane_encode_bwd_plain`, whose light mode
    rounds its residuals with a bf16 round trip (so autograd rounds the
    cotangent that flows back through it)."""
    _, tcfg, params, x, ct, v = _plane_setup(pos_grad, lines, stacked,
                                             seed=3)
    tabs = {k: [_t(a, grad=True) for a in params[k]] for k in params}
    c = _t(ct, grad=True)
    with torch.enable_grad():
        gp, gl, _ = TP.plane_encode_bwd_plain(tabs, _t(x), c, tcfg)
        outs = gp + (gl or [])
        vs = [_t(a) for k in KEYS if k in v for a in v[k]]
        leaves = [a for k in KEYS if k in tabs for a in tabs[k]]
        d = torch.autograd.grad(sum((a * b).sum() for a, b in zip(outs, vs)),
                                leaves + [c], allow_unused=True)
    d_ct, d_pl, d_ln = TP.plane_encode_bwd2_plain(
        {k: [_t(a) for a in params[k]] for k in params}, _t(x), _t(ct),
        {k: [_t(a) for a in v[k]] for k in v}, tcfg)
    assert _rel(d_ct.numpy(), d[-1].numpy()) <= 1e-6
    got = d_pl + (d_ln or [])
    for a, b in zip(got, d[:-1]):
        b = torch.zeros_like(a) if b is None else b
        assert _rel(a.numpy(), b.numpy()) <= 1e-6
    assert (d_ln is None) == (not lines)


@pytest.mark.parametrize("pos_grad,lines,stacked", PLANE_CASES,
                         ids=PLANE_IDS)
def test_plane_bwd2_plain_sums_in_float64(pos_grad, lines, stacked):
    """`sum_dtype=torch.float64` (the card's reference for 5'' and 6''):
    the same float32 shares summed exactly, so d ct is bit-equal and the
    float64 tables lie within float32 rounding of the float32 sums."""
    _, tcfg, params, x, ct, v = _plane_setup(pos_grad, lines, stacked,
                                             seed=3)
    args = ({k: [_t(a) for a in params[k]] for k in params}, _t(x), _t(ct),
            {k: [_t(a) for a in v[k]] for k in v}, tcfg)
    ct32, pl32, ln32 = TP.plane_encode_bwd2_plain(*args)
    ct64, pl64, ln64 = TP.plane_encode_bwd2_plain(*args,
                                                  sum_dtype=torch.float64)
    assert ct64.dtype == torch.float32 and torch.equal(ct64, ct32)
    assert (ln64 is None) == (ln32 is None) == (not lines)
    for a, b in zip(pl64 + (ln64 or []), pl32 + (ln32 or [])):
        assert a.dtype == torch.float64 and a.shape == b.shape
        assert _rel(b.numpy(), a.numpy()) <= 1e-6


def test_plane_bwd2_refuses_position_gradients():
    _, tcfg, params, x, ct, _ = _plane_setup(True, True, False)
    tabs = {k: [_t(a, grad=True) for a in params[k]] for k in params}
    xt = _t(x, grad=True)
    y = TP.plane_encode(tabs, xt, tcfg)
    with pytest.raises(NotImplementedError, match="positions"):
        torch.autograd.grad(y, tabs["planes"], _t(ct), create_graph=True)


def test_plane_first_order_takes_no_bwd2(monkeypatch):
    _, tcfg, params, x, ct, _ = _plane_setup(False, True, False)
    tabs = {k: [_t(a, grad=True) for a in params[k]] for k in params}

    def spy(*a, **k):
        raise AssertionError("PlaneEncodeBwd reached without create_graph")

    monkeypatch.setattr(TP.PlaneEncodeBwd, "apply", spy)
    TP.plane_encode(tabs, _t(x), tcfg).backward(_t(ct))
    assert all(a.grad is not None for vs in tabs.values() for a in vs)


def test_plane_gradgradcheck():
    """The plain encoder in float64, in the tables (bilinear with lines:
    a non-zero second derivative)."""
    cfg = TP.PlaneEncodingConfig(levels=2, base_res=4, growth=2.0,
                                 features=2)
    gen = torch.Generator().manual_seed(0)
    params = TP.plane_encoding_init(cfg, gen, device="cpu")
    tabs = [t.double().requires_grad_(True)
            for t in params["planes"] + params["lines"]]
    x = torch.rand(6, 3, generator=gen, dtype=torch.float64) * 0.9 + 0.05

    def f(*ts):
        p = {"planes": list(ts[:2]), "lines": list(ts[2:])}
        return TP.plane_encode_plain(p, x, cfg)

    assert torch.autograd.gradgradcheck(f, tuple(tabs))


def test_plane_bwd2_wrapper_refuses_grad():
    _, tcfg, params, x, ct, v = _plane_setup(False, True, False)
    with pytest.raises(RuntimeError, match="no backward"):
        TP.plane_encode_bwd2_kernel(
            {k: [_t(a, grad=True) for a in params[k]] for k in params},
            _t(x), _t(ct), {k: [_t(a) for a in v[k]] for k in v}, tcfg)


# ------------------------------- hash encoder --------------------------------
HASH_CASES = [(False, {}), (True, {}), (False, {"interpolation":
                                                "Smoothstep"}),
              (True, {"interpolation": "Smoothstep"}),
              (False, {"tcnn_layout": True}),
              (False, {"interpolation": "Nearest"})]
HASH_IDS = ["fused", "packed", "fused-smoothstep", "packed-smoothstep",
            "fused-tcnn", "nearest"]


@pytest.mark.parametrize("packed,kw", HASH_CASES, ids=HASH_IDS)
def test_hash_bwd2_matches_jax(packed, kw):
    """d ct is the fp32 encode of the table cotangent (7a, on the packed
    path too: its VJP gathers in float32); the table gets nothing."""
    jc, tc = _cfgs(**SMALL, **kw)
    rng = np.random.default_rng(0)
    table = rng.normal(0, 0.1, (jc.levels * jc.table_size, 2)).astype(
        np.float32)
    x = _points(200)
    ct = rng.normal(size=(200, jc.levels * 2)).astype(np.float32)
    v = rng.normal(size=table.shape).astype(np.float32)
    enc = JE.hash_grid_encode_packed if packed else JE.hash_grid_encode_fused

    def psi(tab, c):
        _, vjp = jax.vjp(lambda q: enc(q, jnp.asarray(x), jc), tab)
        (g,) = vjp(c)
        return jnp.sum(g * v)

    with jax.disable_jit():
        want_t, want_c = jax.grad(psi, argnums=(0, 1))(jnp.asarray(table),
                                                       jnp.asarray(ct))
    assert np.all(np.asarray(want_t) == 0)
    for use_kernels in (True, False):
        tt, c = _t(table, grad=True), _t(ct, grad=True)
        y = TE.hash_encode(tt, _t(x), tc, packed=packed,
                           use_kernels=use_kernels)
        g, = torch.autograd.grad(y, tt, c, create_graph=True)
        d_t, d_c = torch.autograd.grad((g * _t(v)).sum(), [tt, c],
                                       allow_unused=True)
        assert d_t is None
        assert _rel(d_c.numpy(), np.asarray(want_c)) <= TOL
        # 7c'' is 7a: the fp32 encode of the cotangent, bit for bit
        want = TE.hash_encode_plain(_t(v), _t(x), tc)
        torch.testing.assert_close(d_c, want, rtol=0, atol=0)


def test_hash_bwd2_stacked_experts():
    """Stacked (K, L * 2^T, F) tables: d ct is each expert's encode of its
    own slab of the cotangent."""
    _, tc = _cfgs(**SMALL)
    rng = np.random.default_rng(1)
    table = rng.normal(0, 0.1, (2, tc.levels * tc.table_size, 2)).astype(
        np.float32)
    x = np.stack([_points(64, seed=2), _points(64, seed=3)])
    ct = rng.normal(size=(2, 64, tc.out_dim)).astype(np.float32)
    v = rng.normal(size=table.shape).astype(np.float32)
    tt, c = _t(table, grad=True), _t(ct, grad=True)
    g, = torch.autograd.grad(TE.hash_encode(tt, _t(x), tc), tt, c,
                             create_graph=True)
    d_c, = torch.autograd.grad((g * _t(v)).sum(), c)
    for e in range(2):
        want = TE.hash_encode_plain(_t(v[e]), _t(x[e]), tc)
        torch.testing.assert_close(d_c[e], want, rtol=0, atol=0)


def test_hash_gradgradcheck():
    """The plain fp32 encode in float64 (linear in the table: its second
    derivative is 0)."""
    _, tc = _cfgs(levels=2, min_res=2, max_res=4, log2_hashmap_size=4)
    gen = torch.Generator().manual_seed(0)
    table = (torch.rand(tc.levels * tc.table_size, 2, generator=gen,
                        dtype=torch.float64) - 0.5).requires_grad_(True)
    x = torch.rand(5, 3, generator=gen) * 0.9 + 0.05
    assert torch.autograd.gradgradcheck(
        lambda t: TE.hash_encode_plain(t, x, tc), (table,))
