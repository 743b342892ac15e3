"""Adversarial inputs of the hash-grid encoder (kernels 7a, 7b and 7c's
module) against JAX, and the launch plans of kernels 7a / 7b and 7c.

The same numpy points, tables and cotangents go through
nerfsys_tpu.ops.encodings (`hash_grid_encode_fused` and `jax.vjp` of it,
jit disabled: jitted XLA on the CPU contracts x * scale into fused
multiply-adds that can move a point into the neighbouring cell) and
through the port's plain versions on the CPU (`hash_encode_plain`,
`hash_encode_bwd_plain`). The inputs are the ones chip_smoke.py holds the
kernels to on the card: every point in one cell, many points in one cell
of the finest level, coordinates at world_to_unit's clip bounds (1e-6 and
1 - 1e-6) and at exactly 0 and 1, a point count that is no multiple of
the kernels' tiles and a single point, F = 1, 2, 4 and 8, and four
stacked experts. Small widths: L=4 levels, 2^12 rows a slab, resolutions
4-64. Tolerances: the forward 1e-6 of the output's max (XLA sums the 8
corner products as a matmul, in its own order); the table gradient 1e-5
of its max (scatter-adds in another order). The packed bfloat16-pair
forward (`hash_encode_packed_plain`, 7b's oracle) is held to
`hash_grid_encode_packed` on the same points at F = 2, Linear, Smoothstep
and the tcnn layout, to 1e-6 of the output's max (each bf16 product
rounds alike on both sides; XLA's 0/1 matmul sums them in its own order).
7b runs 7a's plans: the tests check that a packed config gets the same
plan at every shape.

The plans are plain functions of the shapes: the tests walk the kernels'
loops to show that tiles, level groups, warps and lanes visit every
(expert, point, level) exactly once under either lane map, tails
included; that shared memory stays within an H100 block's 232,448 bytes,
and within the 48 KB a block has without opting in at the runner's
shapes; and that what the plans refuse raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import encodings as JE
from nerfsys_tpu_torch.ops import encodings as TE

SMALL = dict(levels=4, min_res=4, max_res=64, log2_hashmap_size=12)
# the runner's default grid (container_config_from_args's flag defaults)
RUNNER = dict(levels=16, min_res=16, max_res=4096, log2_hashmap_size=20,
              features_per_level=2)
FWD_TOL = 1e-6  # of the output's max: XLA's corner-sum order
GRAD_TOL = 1e-5  # of the gradient's max: scatter-add order
KINDS = ("one_cell", "fine_cell", "bounds", "tail", "single")


def _points(kind, seed=0):
    """Adversarial points in [0, 1]^3 (numpy, float32)."""
    rng = np.random.default_rng(seed)
    if kind == "one_cell":  # every point on the same 8 rows at every level
        return np.tile(np.array([[0.31731, 0.60213, 0.44897]], np.float32),
                       (300, 1))
    if kind == "fine_cell":  # 300 points inside one cell of the finest level
        lo = np.array([0.41, 0.27, 0.72], np.float32)
        return (lo + rng.uniform(0, 1 / 128, (300, 3))).astype(np.float32)
    if kind == "bounds":  # the clip bounds, exactly 0 and 1, uniform
        x = rng.uniform(size=(300, 3)).astype(np.float32)
        pick = rng.integers(0, 6, size=(300, 3))
        special = np.array([1e-6, 1 - 1e-6, 0.0, 1.0], np.float32)
        x = np.where(pick < 4, special[np.minimum(pick, 3)], x)
        x[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1e-6, 1e-6, 1e-6],
                 [1 - 1e-6, 1 - 1e-6, 1 - 1e-6]]
        return x.astype(np.float32)
    if kind == "tail":  # no multiple of any tile (32 x 2^j)
        return rng.uniform(1e-6, 1 - 1e-6, (257 + 37, 3)).astype(np.float32)
    return np.array([[0.5, 1e-6, 1 - 1e-6]], np.float32)  # "single"


def _cfgs(F, **kw):
    kw = dict(SMALL, features_per_level=F, **kw)
    return JE.HashGridConfig(**kw), TE.HashGridConfig(**kw)


def _table(jc, seed=0, experts=0):
    rng = np.random.default_rng(seed)
    lead = (experts,) if experts else ()
    return rng.uniform(-1, 1, (*lead, jc.levels * jc.table_size,
                               jc.features_per_level)).astype(np.float32)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_vjp(jc, table, x, ct):
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda t: JE.hash_grid_encode_fused(
            t, jnp.asarray(x), jc), jnp.asarray(table))
        (g,) = vjp(jnp.asarray(ct))
    return np.asarray(out), np.asarray(g)


@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_hash_edges_match_jax(kind, F):
    """Forward within 1e-6 and table gradient within 1e-5 of their max."""
    jc, tc = _cfgs(F)
    x = _points(kind, seed=F)
    table = _table(jc, seed=F)
    ct = np.random.default_rng(10 + F).normal(
        size=(x.shape[0], tc.out_dim)).astype(np.float32)
    want, gwant = _jax_vjp(jc, table, x, ct)
    got = TE.hash_encode_plain(torch.from_numpy(table), torch.from_numpy(x),
                               tc).numpy()
    assert got.shape == (x.shape[0], tc.out_dim)
    assert _max_rel(got, want) <= FWD_TOL
    g = TE.hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(ct),
                                 tc, table.shape).numpy()
    assert (gwant != 0).any()
    assert _max_rel(g, gwant) <= GRAD_TOL


@pytest.mark.parametrize("mode,tcnn", [("Smoothstep", False),
                                       ("Linear", True)])
def test_hash_bounds_other_modes_match_jax(mode, tcnn):
    """The bounds points in Smoothstep and in the tcnn layout (dense coarse
    levels, clamped corners): the same tolerances."""
    jc, tc = _cfgs(2, interpolation=mode, tcnn_layout=tcnn)
    x = _points("bounds", seed=3)
    table = _table(jc, seed=3)
    ct = np.random.default_rng(4).normal(
        size=(x.shape[0], tc.out_dim)).astype(np.float32)
    want, gwant = _jax_vjp(jc, table, x, ct)
    got = TE.hash_encode_plain(torch.from_numpy(table), torch.from_numpy(x),
                               tc).numpy()
    assert _max_rel(got, want) <= FWD_TOL
    g = TE.hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(ct),
                                 tc, table.shape).numpy()
    assert _max_rel(g, gwant) <= GRAD_TOL


def test_hash_stacked_k4_edges():
    """Four experts' stacked tables at once (as 7c takes them), the bounds
    points: each expert's forward and gradient equal JAX's for it alone."""
    jc, tc = _cfgs(2)
    tables = _table(jc, seed=5, experts=4)
    x = np.stack([_points("bounds", seed=s) for s in range(4)])
    ct = np.random.default_rng(6).normal(
        size=(4, x.shape[1], tc.out_dim)).astype(np.float32)
    got = TE.hash_encode_plain(torch.from_numpy(tables), torch.from_numpy(x),
                               tc).numpy()
    g = TE.hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(ct),
                                 tc, tables.shape).numpy()
    for e in range(4):
        want, gwant = _jax_vjp(jc, tables[e], x[e], ct[e])
        assert _max_rel(got[e], want) <= FWD_TOL
        assert _max_rel(g[e], gwant) <= GRAD_TOL


@pytest.mark.parametrize("mode,tcnn", [("Linear", False),
                                       ("Smoothstep", False),
                                       ("Linear", True)])
@pytest.mark.parametrize("kind", KINDS)
def test_packed_edges_match_jax(kind, mode, tcnn):
    """The packed forward's plain version against hash_grid_encode_packed
    on the adversarial points, within 1e-6 of the output's max; the fp32
    encode differs by more (the bf16 roundings are in play)."""
    jc, tc = _cfgs(2, interpolation=mode, tcnn_layout=tcnn, packed=True)
    x = _points(kind, seed=7)
    table = _table(jc, seed=8)
    with jax.disable_jit():
        want = np.asarray(JE.hash_grid_encode_packed(
            jnp.asarray(table), jnp.asarray(x), jc))
    got = TE.hash_encode_packed_plain(torch.from_numpy(table),
                                      torch.from_numpy(x), tc).numpy()
    assert got.shape == (x.shape[0], tc.out_dim)
    assert _max_rel(got, want) <= FWD_TOL
    fp32 = TE.hash_encode_plain(torch.from_numpy(table), torch.from_numpy(x),
                                tc).numpy()
    assert _max_rel(fp32, want) > 10 * FWD_TOL


# ---------------------------------------------------------------------------
# launch plans


def _walk_fwd(plan, n, k, levels):
    """Visits of every (expert, point, level) by 7a's loops: one block per
    tile and level group, warps over (level, run-group) tasks, lanes by the
    lane map, the tail masked."""
    runs = plan.tile // 32
    step = 32 // runs if plan.lane_map == "rays" else 32
    lane = np.arange(32)
    lane_p = ((lane % runs) * 32 + lane // runs if plan.lane_map == "rays"
              else lane)
    seen = np.zeros((k, n, levels), np.int64)
    for e in range(k):
        for bx in range(plan.blocks):
            p0 = bx * plan.tile
            if p0 >= n:
                continue
            np_ = min(plan.tile, n - p0)
            for by in range(-(-levels // plan.level_group)):
                l0 = by * plan.level_group
                nl = min(plan.level_group, levels - l0)
                for w in range(plan.threads // 32):
                    for task in range(w, nl * runs, plan.threads // 32):
                        li, g = divmod(task, runs)
                        p = lane_p + g * step
                        seen[e, p0 + p[p < np_], l0 + li] += 1
    return seen


def _walk_bwd(plan, n, k, levels):
    """Visits by 7c's loops: blocks of each level group striding over tiles
    (persistent with one group, one tile each with several), warps over
    (level, run-group) tasks, lanes by the lane map."""
    runs = plan.tile // 32
    step = 32 // runs if plan.lane_map == "rays" else 32
    lane = np.arange(32)
    lane_p = ((lane % runs) * 32 + lane // runs if plan.lane_map == "rays"
              else lane)
    tiles = -(-n // plan.tile)
    seen = np.zeros((k, n, levels), np.int64)
    for e in range(k):
        for by in range(-(-levels // plan.level_group)):
            l0 = by * plan.level_group
            nl = min(plan.level_group, levels - l0)
            for bx in range(plan.blocks):
                for t in range(bx, tiles, plan.blocks):
                    p0 = t * plan.tile
                    np_ = min(plan.tile, n - p0)
                    for w in range(plan.threads // 32):
                        for task in range(w, nl * runs, plan.threads // 32):
                            li, g = divmod(task, runs)
                            p = lane_p + g * step
                            seen[e, p0 + p[p < np_], l0 + li] += 1
    return seen


def _staging_fits(plan, F):
    """7a's staged rows, with the run shifts, end inside its shared memory
    (in floats: points, then rows of level_group * F + 1, each run of 32
    shifted by 32 / runs under the "rays" map)."""
    runs = plan.tile // 32
    shift = 32 // runs if plan.lane_map == "rays" else 0
    stride = plan.level_group * F + 1
    last = (3 * plan.tile + (plan.tile - 1) * stride + (runs - 1) * shift
            + plan.level_group * F)
    return last <= plan.smem // 4


@pytest.mark.parametrize("lane_map", TE.LANE_MAPS)
@pytest.mark.parametrize("n", [1, 31, 256, 257, 256 * 3 - 37])
def test_plans_visit_every_point_once(n, lane_map):
    tc = TE.HashGridConfig(**dict(SMALL, levels=8))
    for lg in (None, 4, 1):
        fwd = TE.hash_fwd_plan(n, tc, lane_map=lane_map, level_group=lg)
        assert (fwd.blocks - 1) * fwd.tile < n <= fwd.blocks * fwd.tile
        assert _staging_fits(fwd, 2)
        assert np.all(_walk_fwd(fwd, n, 2, tc.levels) == 1)
    for sms, lg in ((1, None), (3, None), (132, None), (132, 2), (132, 4)):
        bwd = TE.hash_bwd_plan(n, 2, tc, num_sms=sms, lane_map=lane_map,
                               level_group=lg)
        assert 1 <= bwd.blocks <= -(-n // bwd.tile)
        assert bwd.threads <= bwd.tile * bwd.level_group
        assert np.all(_walk_bwd(bwd, n, 2, tc.levels) == 1)


@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_plans_fit_shared_memory(F):
    """Every level count the kernels take, F = 1-8, with every level group:
    at most 232,448 bytes, 7c's exactly its two cotangent and point
    buffers."""
    for levels in (1, 4, 16, 32):
        tc = TE.HashGridConfig(levels=levels, min_res=16, max_res=4096,
                               log2_hashmap_size=19, features_per_level=F)
        for lg in [g for g in range(1, levels + 1) if levels % g == 0]:
            for lane_map in TE.LANE_MAPS:
                plan = TE.hash_fwd_plan(2_097_152, tc, lane_map=lane_map,
                                        level_group=lg)
                assert plan.smem <= TE.SMEM_BLOCK_BYTES == 232_448
                assert _staging_fits(plan, F)
                assert plan.vec == ((lg * F) % 4 == 0)
                assert plan.threads <= 32 * lg * plan.tile // 32
        for lg in (None, 2):
            bwd = TE.hash_bwd_plan(128_000, 1, tc, 132, level_group=lg)
            assert bwd.smem <= TE.SMEM_BLOCK_BYTES
            assert bwd.smem == 8 * bwd.tile * (bwd.level_group * F + 3)


def test_runner_default_plans():
    """The runner's default grid: 7a's tiles of 256 points (8 rays of 32
    samples) in one level group, 512 threads, 36,992 shared bytes, 16-byte
    stores at a query set, tiles of 128 and 512 in groups of 4 levels at an
    inner step and a serve chunk; 7c's groups of 2 levels in 64-point
    tiles, or one group of persistent blocks, 8 of 256 threads an SM."""
    tc = TE.HashGridConfig(**RUNNER)
    fwd = TE.hash_fwd_plan(2_097_152, tc, k=4, num_sms=132)  # a chunk
    assert (fwd.tile, fwd.threads, fwd.blocks, fwd.smem) == (
        512, 512, 4096, 4 * (3 * 512 + 512 * 9 + 32))
    assert fwd.vec and fwd.level_group == 4 and fwd.lane_map == "rays"
    step = TE.hash_fwd_plan(128_000, tc, k=1, num_sms=132)  # inner step
    assert (step.tile, step.level_group, step.blocks) == (128, 4, 1000)
    query = TE.hash_fwd_plan(64_000, tc, k=1, num_sms=132)  # fits a wave
    assert (query.tile, query.level_group, query.threads) == (256, 16, 512)
    assert query.smem == 36_992
    one = TE.hash_fwd_plan(2_097_152, tc, k=4, level_group=16)
    assert (one.tile, one.level_group, one.blocks) == (256, 16, 8192)
    default = TE.hash_bwd_plan(128_000, 1, tc, 132)
    assert (default.tile, default.threads, default.blocks, default.smem) == (
        64, 128, 2000, 8 * 64 * 7)
    assert default.level_group == 2
    assert default.lane_map == "samples" and default.vec
    one = TE.hash_bwd_plan(128_000, 1, tc, 132, level_group=None)
    assert one.level_group == 16 and one.smem == 8 * 64 * 35
    assert one.blocks == 132 * 8  # persistent: 8 blocks of 256 an SM
    # a level count that 2 does not divide takes one group
    odd = TE.HashGridConfig(**dict(RUNNER, levels=3))
    assert TE.hash_bwd_plan(1000, 1, odd, 132).level_group == 3


def test_default_plan_structs_are_cached():
    """The wrappers' default plans and level tables are built once per
    shape and config, and equal the plan functions' own."""
    tc = TE.HashGridConfig(**RUNNER)
    a = TE._fwd_struct(4096, 2, tc, 132, True)
    assert a is TE._fwd_struct(4096, 2, tc, 132, True)
    plan = TE.hash_fwd_plan(4096, tc, 2, 132)
    assert (a.tile, a.threads, a.blocks, a.smem, a.level_group) == (
        plan.tile, plan.threads, plan.blocks, plan.smem, plan.level_group)
    b = TE._bwd_struct(4096, 2, tc, 132, True)
    bp = TE.hash_bwd_plan(4096, 2, tc, 132)
    assert (b.tile, b.threads, b.blocks, b.level_group) == (
        bp.tile, bp.threads, bp.blocks, bp.level_group)
    assert TE._level_table(tc) is TE._level_table(TE.HashGridConfig(**RUNNER))


def test_plan_refusals_raise():
    tc = TE.HashGridConfig(**RUNNER)
    with pytest.raises(ValueError, match="level_group"):
        TE.hash_fwd_plan(1000, tc, level_group=3)
    with pytest.raises(ValueError, match="lane_map"):
        TE.hash_fwd_plan(1000, tc, lane_map="pixels")
    with pytest.raises(ValueError, match="lane_map"):
        TE.hash_bwd_plan(1000, 1, tc, 132, lane_map="pixels")
    # the kernels' structs take at most 32 levels and F in (1, 2, 4, 8)
    with pytest.raises(ValueError):
        TE._level_table(dataclasses.replace(tc, levels=33))
    with pytest.raises(ValueError, match="unsupported device"):
        TE.hash_encode_planned(torch.zeros(16 * 2**20, 2),
                               torch.zeros(4, 3), tc)
    with pytest.raises(ValueError, match="unsupported device"):
        TE.hash_encode_bwd_planned(torch.zeros(4, 3), torch.zeros(4, 32), tc,
                                   (16 * 2**20, 2))


def test_plan_struct_round_trip():
    """The ctypes struct carries the plan's fields in the kernel's order."""
    tc = TE.HashGridConfig(**RUNNER)
    plan = TE.hash_bwd_plan(128_000, 1, tc, 132, level_group=None)
    s = plan.as_struct()
    assert (s.tile, s.threads, s.blocks, s.smem, s.lane_map, s.vec,
            s.level_group) == (64, 256, plan.blocks, plan.smem, 0, 1, 16)
    f = TE.hash_fwd_plan(1000, tc, level_group=4).as_struct()
    assert (f.lane_map, f.level_group, f.vec) == (1, 4, 1)
    assert [n for n, _ in type(s)._fields_] == [
        "tile", "threads", "blocks", "smem", "lane_map", "vec",
        "level_group"]


# the runner's shapes: a serve chunk, an inner step, a query set, a tail
SHAPES = [(2_097_152, 4), (128_000, 1), (64_000, 1), (4_001, 4)]


@pytest.mark.parametrize("n,k", SHAPES)
def test_default_plans_need_no_shared_memory_opt_in(n, k):
    """The default plans of 7a and 7c stay within the 48 KB of shared
    memory a block has without `cudaFuncSetAttribute` (the entry points
    call it only above that), in both layouts and every mode."""
    for kw in ({}, dict(tcnn_layout=True), dict(interpolation="Nearest"),
               dict(features_per_level=8)):
        tc = TE.HashGridConfig(**dict(RUNNER, **kw))
        assert TE.hash_fwd_plan(n, tc, k, 132).smem <= 48 * 1024
        assert TE.hash_bwd_plan(n, k, tc, 132).smem <= 48 * 1024


@pytest.mark.parametrize("n,k", SHAPES)
def test_packed_forward_takes_7a_plans(n, k):
    """7b is 7a's kernel body: a packed config gets 7a's plan (and its own
    cached struct, equal to the fp32 one) at every shape the paths use."""
    tc = TE.HashGridConfig(**RUNNER)
    pc = dataclasses.replace(tc, packed=True)
    for lane_map in TE.LANE_MAPS:
        assert TE.hash_fwd_plan(n, pc, k, 132, lane_map=lane_map) == \
            TE.hash_fwd_plan(n, tc, k, 132, lane_map=lane_map)
    a, b = TE._fwd_struct(n, k, pc, 132, True), TE._fwd_struct(n, k, tc, 132,
                                                               True)
    assert a is not b
    assert [getattr(a, f) for f, _ in a._fields_] == [
        getattr(b, f) for f, _ in b._fields_]


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_aligned_follows_the_start_address(offset):
    """The wrappers' 16-byte test looks at where a tensor starts: a float
    view 4 floats into an aligned buffer is aligned, 1 or 2 are not; None
    counts as aligned."""
    from nerfsys_tpu_torch.utils.device import aligned

    base = torch.zeros(64)
    assert base.data_ptr() % 16 == 0
    view = base[offset:]
    assert aligned(view, None) == (offset % 4 == 0)
    assert aligned(base, view) == (offset % 4 == 0)
