"""Adversarial inputs of the plane encoder (kernels 1, 5 and 6's module)
against JAX, and the launch plans of kernels 1, 5 and 6.

The same numpy points, tables and cotangents go through
nerfsys_tpu.ops.planes (`plane_encode` and `jax.vjp` of it, jit disabled)
and through the port's plain versions on the CPU (`plane_encode_plain`,
`plane_encode_bwd_plain` through `PlaneEncode`). The inputs are the ones
chip_smoke.py holds the kernels to on the card: every point in one cell,
coordinates of exactly 0 and 1 and outside [0, 1], a point count that is
no multiple of the kernels' tile, no lines, F=2 (the kernels' scalar
variant), base 128 (where x = 1 selects the last cell), and stacked
experts. Tolerances: the forward 1e-6 absolute (features O(0.3), the same
float32 operations on both sides); table and position gradients 1e-5 of
each gradient's max (sums in another order: the JAX one-hot contraction
against `index_add_`).

The plans are plain functions of the shapes: the tests check that bench
width privatises all three line levels within an H100 block's shared
memory, that larger configurations privatise only what fits, that the
exact plan (kernel 6) also holds its position partials or refuses, and,
by walking the kernels' loops, that tiles and blocks visit every (point,
level x orientation) exactly once, tails included, and that kernel 6
writes every partial slot and every point's position gradient once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import planes as JP
from nerfsys_tpu_torch.ops import planes as TP
from test_torch_grads import _jax_plane_vjp, _rel
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

# (levels, base, F, lines): a vector config, no lines, the scalar variant's
# F=2, and base 128 (float32(R-1-1e-6) == R-1: x = 1 selects u0 = R-1)
CONFIGS = {
    "F=4": (2, 8, 4, True),
    "no_lines": (2, 8, 4, False),
    "F=2": (2, 16, 2, True),
    "base128": (1, 128, 2, True),
}
N_POINTS = 128 + 37  # a full tile of 128 and a tail of 37


def _points(kind, n=N_POINTS, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "one_cell":  # every point on the same rows
        return np.tile(np.array([[0.31731, 0.60213, 0.44897]], np.float32),
                       (n, 1))
    x = rng.uniform(size=(n, 3)).astype(np.float32)
    pick = rng.integers(0, 5, size=(n, 3))
    special = np.array([0.0, 1.0, -0.25, 1.5], np.float32)
    x = np.where(pick < 4, special[np.minimum(pick, 3)], x)
    x[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.5, -0.25, 1.0]]
    return x


def _configs(name, pos_grad, seed=0):
    levels, base, F, lines = CONFIGS[name]
    kw = dict(levels=levels, base_res=base, growth=2.0, features=F,
              include_lines=lines, pos_grad=pos_grad)
    jcfg = JP.PlaneEncodingConfig(matmul_bwd=True, bwd_chunk=256, **kw)
    tcfg = TP.PlaneEncodingConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, JP.plane_encoding_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    # planes of size O(1), so that bf16 rounding is not below the noise
    params["planes"] = [rng.normal(size=p.shape).astype(np.float32)
                        for p in params["planes"]]
    return jcfg, tcfg, params


def _tables(params, requires_grad=False):
    return {k: [torch.tensor(v, requires_grad=requires_grad) for v in vs]
            for k, vs in params.items()}


@pytest.mark.parametrize("kind", ["one_cell", "bounds"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_plane_encode_edges_match_jax(kind, config):
    jcfg, tcfg, params = _configs(config, pos_grad=False)
    x = _points(kind)
    with jax.disable_jit():
        want = np.asarray(JP.plane_encode(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
            jcfg))
    got = TP.plane_encode_plain(_tables(params), torch.tensor(x), tcfg)
    assert got.shape == (N_POINTS, tcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pos_grad", [False, True])
@pytest.mark.parametrize("kind", ["one_cell", "bounds"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_plane_backward_edges_match_jax(pos_grad, kind, config):
    jcfg, tcfg, params = _configs(config, pos_grad=pos_grad)
    x = _points(kind)
    ct = np.random.default_rng(1).normal(
        size=(N_POINTS, tcfg.out_dim)).astype(np.float32)
    gp, gx, _ = _jax_plane_vjp(jcfg, params, x, ct)
    tables = _tables(params, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    TP.plane_encode(tables, xt, tcfg).backward(torch.tensor(ct))
    for key in tables:
        for l in range(jcfg.levels):
            assert _rel(tables[key][l].grad.numpy(), gp[key][l]) <= 1e-5
    if pos_grad:
        if CONFIGS[config][1] >= 128 and kind == "bounds":
            # x = 1 selects u0 = R-1: JAX's exact VJP differentiates across
            # the last cell's edge into a wrapped row (base + 1, base + R);
            # the port's clamped neighbour gives a zero derivative there
            edge = x == 1.0
            assert np.all(xt.grad.numpy()[edge] == 0)
            assert np.any(gx[edge] != 0)
            gx = np.where(edge, 0.0, gx)
        assert _rel(xt.grad.numpy(), gx) <= 1e-5
        outside = (x < 0) | (x > 1)
        assert np.all(xt.grad.numpy()[outside] == 0)
    else:
        assert np.all(xt.grad.numpy() == 0)
        if CONFIGS[config][3]:  # with lines the bf16 residuals show
            jexact, _, _ = _configs(config, pos_grad=True)
            exact, _, _ = _jax_plane_vjp(jexact, params, x, ct)
            gap = min(_rel(tables[k][l].grad.numpy(), exact[k][l])
                      for k in tables for l in range(jcfg.levels))
            assert gap > 10 * 1e-5


@pytest.mark.parametrize("pos_grad", [False, True])
def test_plane_backward_stacked_k4_edges(pos_grad):
    """Four experts' stacked tables at once (as kernel 5 takes them), the
    bounds points: each expert's gradients equal JAX's for it alone."""
    per = [_configs("F=4", pos_grad, seed=s) for s in range(4)]
    jcfg, tcfg = per[0][0], per[0][1]
    x = np.stack([_points("bounds", seed=s) for s in range(4)])
    ct = np.random.default_rng(2).normal(
        size=(4, N_POINTS, tcfg.out_dim)).astype(np.float32)
    stacked = {k: [torch.tensor(np.stack([p[2][k][l] for p in per]),
                                requires_grad=True)
                   for l in range(jcfg.levels)] for k in per[0][2]}
    TP.plane_encode(stacked, torch.tensor(x), tcfg).backward(
        torch.tensor(ct))
    for e, (_, _, params) in enumerate(per):
        gp, _, _ = _jax_plane_vjp(jcfg, params, x[e], ct[e])
        for key in stacked:
            for l in range(jcfg.levels):
                assert _rel(stacked[key][l].grad[e].numpy(),
                            gp[key][l]) <= 1e-5


# ---------------------------------------------------------------------------
# launch plans

BENCH = ([128, 256, 512], 8)  # bench.py's encoder: L=3 base 128 growth 2
L5 = ([128, 256, 512, 1024, 2048], 8)  # its line tables: 380,928 bytes


def test_bench_width_privatises_every_line_level():
    """All three of bench width's line levels fit in one block's shared
    memory beside the cotangent buffers; by default (LINE_BUDGET) the plan
    privatises the coarsest alone."""
    res, F = BENCH
    full = TP.plane_bwd_plan(128_000, 1, res, F, True, num_sms=132,
                                   line_budget=None)
    assert full.private_levels == [0, 1, 2]
    assert full.smem <= TP.SMEM_BLOCK_BYTES == 232_448
    assert full.smem == 124_416  # 2 x 64 x 75 floats + 3 x 896 x 8 floats
    plan = TP.plane_bwd_plan(128_000, 1, res, F, True, num_sms=132)
    assert plan.private_levels == [0]
    assert plan.smem == 50_688  # 2 x 64 x 75 floats + 3 x 128 x 8 floats
    assert plan.vec and (plan.tile, plan.threads) == (64, 256)
    assert plan.blocks == 528  # 4 resident an SM by shared memory
    fwd = TP.plane_fwd_plan(2_097_152, res, F)
    assert (fwd.tile, fwd.threads, fwd.blocks, fwd.smem, fwd.vec) == (
        128, 384, 16_384, 38_400, True)


def test_large_config_privatises_only_what_fits():
    res, F = L5
    assert sum(3 * r * F * 4 for r in res) == 380_928
    plan = TP.plane_bwd_plan(128_000, 1, res, F, True, num_sms=132,
                                   line_budget=None)
    assert plan.private_levels == [0, 1, 2]
    assert plan.line_ofs[3:] == (-1, -1)
    assert plan.smem <= TP.SMEM_BLOCK_BYTES
    used = [plan.line_ofs[l] for l in plan.private_levels]
    assert used == sorted(used) and all(o % 4 == 0 for o in used)
    # each private level ends where the next begins: no overlap
    ends = [plan.line_ofs[l] + 3 * res[l] * F for l in plan.private_levels]
    assert ends[:-1] == used[1:]
    assert plan.smem == 8 * plan.tile * (3 * 5 * F + 3) + 4 * ends[-1]
    default = TP.plane_bwd_plan(128_000, 1, res, F, True, num_sms=132)
    assert default.private_levels == [0]


@pytest.mark.parametrize("budget,lines,want", [
    (0, True, []), (12_288, True, [0]), (None, False, [])])
def test_line_budget_and_no_lines(budget, lines, want):
    res, F = BENCH
    plan = TP.plane_bwd_plan(128_000, 1, res, F, lines, num_sms=132,
                                   line_budget=budget)
    assert plan.private_levels == want


def test_scalar_variant_and_refusals():
    assert not TP.plane_fwd_plan(100, [16, 32], 2).vec
    assert not TP.plane_bwd_plan(100, 1, [16, 32], 2, True, 132).vec
    assert not TP.plane_fwd_plan(100, [16, 32], 4, vec_ok=False).vec
    with pytest.raises(ValueError):
        TP.plane_fwd_plan(100, [8] * 9, 4)  # more levels than the struct
    with pytest.raises(ValueError):
        TP.plane_bwd_plan(100, 1, [16384], 8, True, 132)  # R^2 F


def _walk(plan, n, k, levels, persistent):
    """Visits of every (expert, point, level x orientation) by the kernels'
    loops: blocks over tiles (kernel 1: one each, its lanes spread over the
    tile's runs of 32 points; kernel 5: persistent strides, its lanes on
    one run), warps over tasks, the tail masked."""
    lo_n = 3 * levels
    runs = plan.tile // 32
    warps = plan.threads // 32
    tiles = -(-n // plan.tile)
    seen = np.zeros((k, n, lo_n), np.int64)
    lane = np.arange(32)
    for e in range(k):
        for bx in range(plan.blocks):
            for t in (range(bx, tiles, plan.blocks) if persistent else [bx]):
                p0 = t * plan.tile
                np_ = min(plan.tile, n - p0)
                for w in range(warps):
                    for task in range(w, lo_n * runs, warps):
                        lo, g = divmod(task, runs)
                        p = (g * 32 + lane if persistent else
                             (lane % runs) * 32 + lane // runs
                             + g * (32 // runs))
                        seen[e, p0 + p[p < np_], lo] += 1
    return seen


@pytest.mark.parametrize("n", [1, 127, 128, 129, 128 * 40 - 37])
def test_plans_visit_every_point_once(n):
    res, F = BENCH
    fwd = TP.plane_fwd_plan(n, res, F)
    assert (fwd.blocks - 1) * fwd.tile < n <= fwd.blocks * fwd.tile
    assert np.all(_walk(fwd, n, 2, len(res), persistent=False) == 1)
    for sms in (1, 3, 132):
        bwd = TP.plane_bwd_plan(n, 2, res, F, True, num_sms=sms)
        assert 1 <= bwd.blocks <= -(-n // bwd.tile)
        assert np.all(_walk(bwd, n, 2, len(res), persistent=True) == 1)


# ---------------------------------------------------------------------------
# kernel 6: the exact plan (the kernel-5 body with position partials)

@pytest.mark.parametrize("res,F", [BENCH, L5, ([16, 32], 2)])
def test_exact_plan_fits_with_its_partials(res, F):
    """The exact plan adds the (tile, 3*L, 3) position partials to the
    light plan's shared memory, and still fits one H100 block."""
    light = TP.plane_bwd_plan(128_000, 1, res, F, True, num_sms=132)
    exact = TP.plane_bwd_plan(128_000, 1, res, F, True, num_sms=132,
                              exact=True)
    assert exact.exact and not light.exact and exact.sms == 132
    assert exact.tile == light.tile == 64
    partials = 4 * exact.tile * 9 * len(res)
    assert exact.smem == light.smem + partials <= TP.SMEM_BLOCK_BYTES
    assert exact.line_ofs == light.line_ofs
    assert exact.vec == (F % 4 == 0)
    if res == BENCH[0]:
        assert exact.smem == 57_600  # 50,688 + 64 x 27 floats
        assert exact.blocks == 396  # 3 resident an SM by shared memory


def test_exact_plan_refuses_a_tile_that_cannot_fit():
    """L=8, F=37: a 32-point tile's buffers fit the light plan (228,096
    bytes) but not with the exact plan's partials (237,312 bytes)."""
    res = [8] * 8
    light = TP.plane_bwd_plan(100, 1, res, 37, True, 132)
    assert light.tile == 32 and light.smem <= TP.SMEM_BLOCK_BYTES
    with pytest.raises(ValueError):
        TP.plane_bwd_plan(100, 1, res, 37, True, 132, exact=True)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 64 * 40 - 37])
def test_exact_plan_writes_every_partial_and_gx_once(n):
    """Kernel 6's loops: persistent blocks over tiles; in a tile each
    warp task writes its active points' three partial slots of its block
    (level x orientation), then one pass writes each point's gx."""
    res, F = BENCH
    lo_n = 3 * len(res)
    for sms in (1, 3, 132):
        plan = TP.plane_bwd_plan(n, 2, res, F, True, num_sms=sms,
                                 exact=True)
        assert np.all(_walk(plan, n, 2, len(res), persistent=True) == 1)
        tiles = -(-n // plan.tile)
        gx = np.zeros((2, n, 3), np.int64)
        for e in range(2):
            for bx in range(plan.blocks):
                for t in range(bx, tiles, plan.blocks):
                    np_ = min(plan.tile, n - t * plan.tile)
                    slots = np.zeros((plan.tile, lo_n, 3), np.int64)
                    for task in range(lo_n * (plan.tile // 32)):
                        lo, g = divmod(task, plan.tile // 32)
                        p = g * 32 + np.arange(32)
                        p = p[p < np_]
                        for ax in TP._ORIENTATIONS[lo % 3]:
                            slots[p, lo, ax] += 1
                    assert np.all(slots[:np_] == 1)
                    assert np.all(slots[np_:] == 0)
                    i = np.arange(np_ * 3)
                    gx[e, t * plan.tile + i // 3, i % 3] += 1
        assert np.all(gx == 1)
