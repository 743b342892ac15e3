"""Port parity: the plane encoder under bfloat16 line matmuls (kernels 1b
and 5b's plain versions) against the JAX package's own pieces.

The reference's bfloat16 line matmuls (`_linear_rows_mm` with
lines_mm_dtype='bfloat16') round the (N, R) hat stencil and the line table
to bfloat16 and contract them in float32 on the TPU; JAX on the CPU
computes that dot in float32 (nerfsys_tpu/ops/planes.py:237-240), so it
cannot be the oracle as it runs. The oracle here builds the TPU's
arithmetic from the package's own functions, run eagerly: the stencil
`_weight_profile(w0, fw, R, bfloat16)` against `table.astype(bfloat16)`,
both upcast to float32 in a HIGHEST-precision dot. A product of two
bfloat16 values is exact in float32 and a stencil row has two nonzeros,
so that dot rounds once, as the TPU's does. The plane values are JAX's
`_bilinear_rows` (packed corners).

Tolerances: the forward bit for bit (measured: every value equal); the
light backward within 1e-6 of each gradient's max against JAX's
`_plane_encode_mm_light_bwd` on the oracle's residuals (float32
contraction, as on every backend but the TPU; the port sums with
index_add_ in another order: measured <= 2.9e-7 at these sizes).

The second derivative (kernel 5''b's plain version, MAML's) is held to
`jax.vjp` of `_plane_encode_mm_light_bwd` on the residuals of
`_plane_encode_mm_light_fwd`, with the package's `_linear_rows_mm`
replaced in this process by the oracle above. The oracle rounds the line
table with a straight-through, t + stop_gradient(bf16(t) - t) (exact in
float32): the port sums the line-table cotangent in float32, where the
TPU's autodiff types it bfloat16 (ROADMAP Queue 3). Tolerance 1e-5 of
each output's max (measured <= 2.4e-7); the port lies >= 1e-3 of the max
away from the cast oracle (t.astype(bf16), whose cotangent rounds) in
d lines (measured 2.4e-3-3.3e-3) and from the float32 lines' result in
d lines (1.6e-3-1.9e-3) and d ct (5.8e-3-6.2e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import planes as J
from nerfsys_tpu_torch.ops import planes as T
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

N = 512


def _configs(base, F, levels, pos_grad=False):
    kw = dict(levels=levels, base_res=base, growth=2.0, features=F,
              pos_grad=pos_grad, lines_matmul=True, lines_mm_dtype="bfloat16")
    return J.PlaneEncodingConfig(matmul_bwd=True, **kw), \
        T.PlaneEncodingConfig(**kw)


def _points(n, seed=0):
    x = np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)
    x[:4] = 1.0  # u0 = R-1 where float32(R-1-1e-6) rounds up (R >= 128)
    x[4:7] = 0.0
    x[8] = [1.0, 0.5, 0.0]
    x[9] = [1.2, -0.3, 0.5]  # outside [0, 1]: clipped
    return x


def _oracle(params, x, cfg):
    """(features, plane values, line values) with the TPU's bfloat16 line
    matmuls, from the package's own pieces, eagerly."""
    x = jnp.clip(jnp.asarray(x), 0.0, 1.0)
    feats, bvals, lvals = [], [], []
    with jax.disable_jit():
        for l, R in enumerate(cfg.level_resolutions()):
            coords = x * (R - 1)
            for o, (a, b, c) in enumerate(J._ORIENTATIONS):
                bv = J._bilinear_rows(jnp.asarray(params["planes"][l][o]),
                                      coords[:, a], coords[:, b], R,
                                      packed=True)
                w = coords[:, c]
                w0f = jnp.floor(jnp.clip(w, 0.0, R - 1 - 1e-6))
                aw = J._weight_profile(w0f.astype(jnp.int32), w - w0f, R,
                                       jnp.bfloat16)
                tb = jnp.asarray(params["lines"][l][o]).astype(jnp.bfloat16)
                lv = jnp.dot(aw.astype(jnp.float32), tb.astype(jnp.float32),
                             precision=jax.lax.Precision.HIGHEST)
                feats.append(bv * lv)
                bvals.append(bv)
                lvals.append(lv)
    return jnp.concatenate(feats, -1), bvals, lvals


CASES = [(8, 4, 2), (128, 2, 1)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "R%d-F%d-L%d" % c)
def case(request):
    """One oracle build serves the forward, backward and routing cases."""
    base, F, levels = request.param
    jcfg, tcfg = _configs(base, F, levels)
    params = jax.tree_util.tree_map(
        np.asarray, J.plane_encoding_init(jax.random.PRNGKey(levels), jcfg))
    tparams = {k: [torch.tensor(v) for v in vs] for k, vs in params.items()}
    x = _points(N, seed=base)
    want, bvals, lvals = _oracle(params, x, jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tparams=tparams, x=x,
                want=np.asarray(want), bvals=bvals, lvals=lvals)


def test_forward_equals_the_bf16_oracle(case):
    tcfg, tparams, x = case["tcfg"], case["tparams"], case["x"]
    got = T.plane_encode_plain(tparams, torch.tensor(x), tcfg).numpy()
    np.testing.assert_array_equal(got, case["want"])
    # the kernel wrapper and the autograd entry route CPU tensors to it
    np.testing.assert_array_equal(
        T.plane_encode(tparams, torch.tensor(x), tcfg).detach().numpy(),
        got)
    # and it is not the float32 lines' function
    f32 = T.plane_encode_plain(tparams, torch.tensor(x), dataclasses.replace(
        tcfg, lines_mm_dtype="float32")).numpy()
    assert np.mean(f32 != got) > 0.5


def test_light_backward_matches_jax_on_the_oracle_residuals(case):
    jcfg, tcfg, x = case["jcfg"], case["tcfg"], case["x"]
    ct = np.random.default_rng(1).normal(
        size=case["want"].shape).astype(np.float32)
    L = jcfg.levels
    dt = {k: [jnp.zeros((0,), jnp.float32)] * L for k in ("planes", "lines")}
    res = (jnp.asarray(x), [b.astype(jnp.bfloat16) for b in case["bvals"]],
           [v.astype(jnp.bfloat16) for v in case["lvals"]], dt)
    with jax.disable_jit():
        jg, jgx = J._plane_encode_mm_light_bwd(jcfg, res, jnp.asarray(ct))
    gp, gl, gx = T.plane_encode_bwd_plain(case["tparams"], torch.tensor(x),
                                          torch.tensor(ct), tcfg)
    for want, got in zip(jg["planes"] + jg["lines"], gp + gl):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-6 * float(np.abs(want).max()), err
    assert not gx.any() and not np.asarray(jgx).any()
    # the float32 lines' residuals give other line gradients: the bf16
    # recompute is what matched
    f32 = T.plane_encode_bwd_plain(case["tparams"], torch.tensor(x),
                                   torch.tensor(ct), dataclasses.replace(
                                       tcfg, lines_mm_dtype="float32"))
    assert any(not torch.equal(a, b) for a, b in zip(f32[0], gp))


def test_exact_backward_ignores_the_line_dtype(case):
    """The reference's exact VJP regathers its lines in float32
    (ops/planes.py:492-497): kernel 6's function for either dtype."""
    tcfg = dataclasses.replace(case["tcfg"], pos_grad=True)
    x, tp = torch.tensor(case["x"]), case["tparams"]
    ct = torch.ones(N, tcfg.out_dim)
    got = T.plane_encode_bwd_plain(tp, x, ct, tcfg)
    want = T.plane_encode_bwd_plain(tp, x, ct, dataclasses.replace(
        tcfg, lines_matmul=False))
    for a, b in zip(got[0] + got[1] + [got[2]], want[0] + want[1] + [want[2]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_line_matmul_flags(dtype):
    """lines_bf16 needs both keys (the reference reads the dtype only under
    lines_matmul) and lines; float32 line matmuls are kernel 1's function;
    any other dtype raises."""
    base = T.PlaneEncodingConfig(levels=1, base_res=8, features=4)
    cfg = dataclasses.replace(base, lines_matmul=True, lines_mm_dtype=dtype)
    assert cfg.lines_bf16 == (dtype == "bfloat16")
    assert not dataclasses.replace(base, lines_mm_dtype=dtype).lines_bf16
    assert not dataclasses.replace(cfg, include_lines=False).lines_bf16
    with pytest.raises(ValueError, match="lines_mm_dtype"):
        dataclasses.replace(base, lines_mm_dtype="float16")
    params = T.plane_encoding_init(base, torch.Generator().manual_seed(0),
                                   device="cpu")
    x = torch.rand(64, 3, generator=torch.Generator().manual_seed(1))
    same = torch.equal(T.plane_encode_plain(params, x, cfg),
                       T.plane_encode_plain(params, x, base))
    assert same == (dtype == "float32")


def _mm_oracle(straight: bool):
    """`_linear_rows_mm` with the TPU's bfloat16 arithmetic: the oracle's
    stencil and table; the table rounded by a straight-through (its
    cotangent passes in float32) or by a cast (rounded to bfloat16)."""
    def rows(table, w, R, cfg):
        w0f = jnp.floor(jnp.clip(w, 0.0, R - 1 - 1e-6))
        aw = J._weight_profile(w0f.astype(jnp.int32), w - w0f, R,
                               jnp.bfloat16)
        tb16 = table.astype(jnp.bfloat16).astype(jnp.float32)
        tb = (table + jax.lax.stop_gradient(tb16 - table) if straight
              else tb16)
        return jnp.dot(aw.astype(jnp.float32), tb,
                       precision=jax.lax.Precision.HIGHEST)
    return rows


def _jax_light_bwd2(jcfg, params, x, ct, v, rows=None):
    """d (tables, ct) of <v, light VJP(ct)> through JAX's light custom VJP
    pieces, `_linear_rows_mm` replaced by `rows` (None: the package's
    own, float32 lines on the CPU)."""
    def psi(p, c):
        _, res = J._plane_encode_mm_light_fwd(p, jnp.asarray(x), jcfg)
        g, _ = J._plane_encode_mm_light_bwd(jcfg, res, c)
        return sum(jnp.sum(g[k][l] * v[k][l]) for k in v
                   for l in range(len(v[k])))

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        if rows is not None:
            mp.setattr(J, "_linear_rows_mm", rows)
        dp, dc = jax.grad(psi, argnums=(0, 1))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ct))
    return [np.asarray(a) for a in dp["planes"] + dp["lines"]], np.asarray(dc)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_second_derivative_matches_the_straight_through_oracle(case):
    """Kernel 5''b's plain version (`plane_encode_bwd2_plain` under
    bfloat16 lines) and the port's autograd path through
    `PlaneEncodeBwd` against the oracle's second derivative: d ct, d
    planes and d lines within 1e-5 of each max; the cast oracle and the
    float32 lines lie >= 1e-3 away."""
    jcfg, tcfg, params, x = case["jcfg"], case["tcfg"], case["params"], \
        case["x"]
    rng = np.random.default_rng(5)
    ct = rng.normal(size=case["want"].shape).astype(np.float32)
    v = {k: [rng.normal(size=a.shape).astype(np.float32) for a in vs]
         for k, vs in params.items()}
    want_t, want_c = _jax_light_bwd2(jcfg, params, x, ct, v,
                                     _mm_oracle(straight=True))
    tv = {k: [torch.tensor(a) for a in vs] for k, vs in v.items()}
    d_ct, d_pl, d_ln = T.plane_encode_bwd2_plain(
        case["tparams"], torch.tensor(x), torch.tensor(ct), tv, tcfg)
    got_t = [a.numpy() for a in d_pl + d_ln]
    assert _rel(d_ct.numpy(), want_c) <= 1e-5
    for a, b in zip(got_t, want_t):
        assert _rel(a, b) <= 1e-5
    # the autograd path (PlaneEncodeBwd, the wrapper's CPU route) agrees
    tabs = [torch.tensor(a, requires_grad=True)
            for a in params["planes"] + params["lines"]]
    c = torch.tensor(ct, requires_grad=True)
    y = T.PlaneEncode.apply(tcfg, True, torch.tensor(x), *tabs)
    g = torch.autograd.grad(y, tabs, c, create_graph=True)
    d = torch.autograd.grad(sum((a * b).sum() for a, b in zip(
        g, tv["planes"] + tv["lines"])), tabs + [c])
    assert torch.equal(d[-1], d_ct)
    assert all(torch.equal(a, b) for a, b in zip(d[:-1], d_pl + d_ln))
    # the cast oracle rounds the line cotangent; float32 lines differ more
    L = jcfg.levels
    cast_t, cast_c = _jax_light_bwd2(jcfg, params, x, ct, v,
                                     _mm_oracle(straight=False))
    f32_t, f32_c = _jax_light_bwd2(jcfg, params, x, ct, v)
    assert max(_rel(a, b) for a, b in zip(got_t[L:], cast_t[L:])) >= 1e-3
    assert max(_rel(a, b) for a, b in zip(got_t[L:], f32_t[L:])) >= 1e-3
    assert _rel(d_ct.numpy(), f32_c) >= 1e-3


def test_exact_second_derivative_ignores_the_line_dtype(case):
    """The repair: under bfloat16 line matmuls the exact VJP's derivative
    (kernel 6'') runs, and equals the float32 lines' bit for bit (the
    exact VJP regathers float32 lines)."""
    tcfg = dataclasses.replace(case["tcfg"], pos_grad=True)
    x = torch.tensor(case["x"])
    rng = np.random.default_rng(6)
    ct = torch.tensor(rng.normal(size=case["want"].shape).astype(np.float32))
    v = [torch.tensor(rng.normal(size=t.shape).astype(np.float32))
         for t in T._tables(case["tparams"])]
    outs = []
    for c in (tcfg, dataclasses.replace(tcfg, lines_mm_dtype="float32")):
        tabs = [t.clone().requires_grad_(True)
                for t in T._tables(case["tparams"])]
        cc = ct.clone().requires_grad_(True)
        y = T.PlaneEncode.apply(c, True, x, *tabs)
        g = torch.autograd.grad(y, tabs, cc, create_graph=True)
        outs.append(torch.autograd.grad(
            sum((a * b).sum() for a, b in zip(g, v)), tabs + [cc]))
    assert tcfg.lines_bf16
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_second_derivative_raises_under_bf16_lines():
    """Under bfloat16 line matmuls the second derivative in the tables runs
    (kernel 5''b's function on CPU tensors); one with positions that
    require grad raises, as it does under float32 lines."""
    cfg = T.PlaneEncodingConfig(levels=1, base_res=8, features=4,
                                pos_grad=False, lines_matmul=True,
                                lines_mm_dtype="bfloat16")
    params = T.plane_encoding_init(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    tables = [t.requires_grad_(True) for t in T._tables(params)]
    x = torch.rand(32, 3, generator=torch.Generator().manual_seed(2))
    out = T.PlaneEncode.apply(cfg, True, x, *tables)
    g = torch.autograd.grad(out.square().sum(), tables, create_graph=True)
    d = torch.autograd.grad(sum(t.square().sum() for t in g), tables)
    assert all(bool(t.abs().sum() > 0) for t in d)
    xg = x.clone().requires_grad_(True)
    out = T.PlaneEncode.apply(cfg, True, xg, *tables)
    with pytest.raises(NotImplementedError, match="positions"):
        torch.autograd.grad(out.square().sum(), tables, create_graph=True)
