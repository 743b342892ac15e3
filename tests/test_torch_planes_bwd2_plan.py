"""Kernels 5'' / 6'' (csrc/planes_bwd2.cu): the launch plan
`plane_bwd_plan(..., second=True)` and the kernel's maps, walked in numpy.

The kernel itself runs only on the card (chip_smoke's `edge
plane_encode_bwd2_light` / `edge plane_encode_bwd2` lines); here its
shared-memory layout against the plan and its persistent tile / warp /
lane map (every (expert, point, level, orientation) visited once whatever
the grid the occupancy cap leaves)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from nerfsys_tpu_torch.ops import planes as PL
from nerfsys_tpu_torch.utils.device import SMEM_BLOCK_BYTES

BENCH = PL.PlaneEncodingConfig(levels=3, base_res=128, growth=2.0,
                               features=8, pos_grad=False)
CONFIGS = {
    "bench": BENCH,
    "L=5 base 128": dataclasses.replace(BENCH, levels=5),
    "F=2": dataclasses.replace(BENCH, features=2),
    "no lines": dataclasses.replace(BENCH, include_lines=False),
    "L=8 base 16 F=4": dataclasses.replace(BENCH, levels=8, base_res=16,
                                           growth=1.5, features=4),
}


def _plan(cfg, n, k):
    return PL.plane_bwd_plan(n, k, cfg.level_resolutions(), cfg.features,
                             cfg.include_lines, 132, exact=cfg.pos_grad,
                             second=True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("n,k", [(1, 1), (33, 4), (128_000, 1),
                                 (128_000, 4)])
def test_plan_fits_the_block_with_every_line_level_global(name, n, k):
    """The kernel's layout, 2 ct buffers, 2 point buffers and the staged
    d ct, fits the plan's shared memory and the block's 227 KB; no line
    level is private, whatever kernel 5's line budget would take."""
    cfg = CONFIGS[name]
    plan = _plan(cfg, n, k)
    assert plan.second and plan.tile % 32 == 0
    assert plan.threads == PL.BWD2_TILE_THREADS
    assert 1 <= plan.blocks <= -(-n // plan.tile)
    assert plan.smem == 4 * plan.tile * (3 * cfg.out_dim + 6)
    assert plan.smem <= SMEM_BLOCK_BYTES
    assert plan.private_levels == []
    for budget in (PL.LINE_BUDGET, None):
        assert PL.plane_bwd_plan(
            n, k, cfg.level_resolutions(), cfg.features, cfg.include_lines,
            132, line_budget=budget, exact=cfg.pos_grad,
            second=True) == plan


def test_bench_plan_keeps_every_line_level_global():
    plan = _plan(BENCH, 128_000, 1)
    assert plan.private_levels == [] and plan.tile == PL.BWD_TILE
    assert plan.threads == 288 and plan.smem == 4 * 64 * (3 * 72 + 6)
    # kernel 5's plan at the same shape keeps the coarsest level private
    first = PL.plane_bwd_plan(128_000, 1, BENCH.level_resolutions(), 8,
                              True, 132)
    assert first.private_levels == [0] and first.threads == PL.BWD_THREADS


def test_launch_is_cached_per_shape():
    a = PL._bwd2_launch(128_000, 1, (128, 256, 512), 8, True, 132, True,
                        False)
    b = PL._bwd2_launch(128_000, 1, (128, 256, 512), 8, True, 132, True,
                        False)
    assert a is b
    plan, struct = a
    assert plan == _plan(BENCH, 128_000, 1)
    assert (struct.tile, struct.threads, struct.blocks, struct.smem,
            struct.vec, struct.sms) == (plan.tile, plan.threads,
                                        plan.blocks, plan.smem, 1, 132)
    assert list(struct.line_ofs)[:3] == list(plan.line_ofs)
    assert all(o == -1 for o in list(struct.line_ofs)[3:])


def _lanes_a_point(features: int, vec: bool) -> int:
    """The kernel's lanes a point: F / 4 on the 16-byte path when F is a
    power of two up to 128 (each lane one 16-byte quarter of every row),
    else 1."""
    return (features >> 2 if vec and features <= 128
            and features & (features - 1) == 0 else 1)


def _walk(n, k, plan, lo_count, grid, features=8):
    """The kernel's loops: blocks (bx, k) of a grid of `grid` x K, tiles
    t = bx, bx + grid, ...; per tile, warp w takes tasks w, w + warps, ...
    of LO * (tile / points a task), the (level, orientation) lo = task %
    LO fastest and group = task // LO; lane l of task (lo, group) is point
    group * (32 / lp) + l / lp of the tile, live when below the tile's np,
    and takes the row pieces f0 = vec * (l % lp), + vec * lp, ... (lp
    lanes a point). Returns (visits (K, N, LO, F / vec), the block of each
    (expert, point))."""
    vec = 4 if plan.vec else 1
    lp = _lanes_a_point(features, plan.vec)
    ppw = 32 // lp
    visits = np.zeros((k, n, lo_count, features // vec), np.int64)
    owner = np.full((k, n), -1, np.int64)
    tile, warps = plan.tile, plan.threads // 32
    groups = tile // ppw
    ntiles = -(-n // tile)
    lanes = np.arange(32)
    q, h = lanes // lp, lanes % lp
    # (lane, piece) pairs: lane l takes pieces h, h + lp, ... of F / vec
    lane_of = np.concatenate([np.full(len(range(hh, features // vec, lp)), l)
                              for l, hh in enumerate(h)])
    piece_of = np.concatenate([np.arange(hh, features // vec, lp) for hh in h])
    for kk in range(k):
        for bx in range(grid):
            for t in range(bx, ntiles, grid):
                np_ = min(tile, n - t * tile)
                for w in range(warps):
                    tasks = np.arange(w, lo_count * groups, warps)
                    lo = tasks % lo_count
                    p = (tasks // lo_count)[:, None] * ppw + q[lane_of][None]
                    live = p < np_
                    lo_b = np.broadcast_to(lo[:, None], p.shape)[live]
                    pc_b = np.broadcast_to(piece_of[None], p.shape)[live]
                    pts = t * tile + p[live]
                    np.add.at(visits[kk], (pts, lo_b, pc_b), 1)
                    owner[kk, pts] = bx
    return visits, owner


@pytest.mark.parametrize("n", [1, 31, 33, 64 * 1024 + 1])
@pytest.mark.parametrize("k", [1, 4])
def test_walk_visits_every_point_level_orientation_once(n, k):
    """Every (expert, point, level x orientation, row piece) once, on the
    16-byte path with 2 lanes a point (bench width, F=8), under the plan's
    grid and grids cut by the occupancy cap."""
    plan = _plan(BENCH, n, k)
    lo_count = 3 * BENCH.levels
    for grid in sorted({plan.blocks, min(plan.blocks, 3), 1}):
        visits, owner = _walk(n, k, plan, lo_count, grid)
        assert np.all(visits == 1), (grid, np.unique(visits))
        assert np.all((owner >= 0) & (owner < grid))


@pytest.mark.parametrize("features,vec", [(4, True), (16, True), (32, True),
                                          (12, True), (8, False),
                                          (2, False)])
def test_walk_covers_every_row_piece_at_other_widths(features, vec):
    """F=4: one lane a point; F=16: four; F=32: eight (4 points a warp);
    F=12 (not a power of two): one lane looping over three pieces; the
    scalar path (F=8, F=2): one lane looping over every float."""
    cfg = dataclasses.replace(BENCH, features=features)
    n = 1000
    plan = dataclasses.replace(_plan(cfg, n, 1), vec=vec)
    visits, _ = _walk(n, 1, plan, 3 * cfg.levels, 3, features=features)
    assert np.all(visits == 1)
