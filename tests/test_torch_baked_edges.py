"""Adversarial lookups of the baked grid (kernel 8's module) against JAX,
and kernel 8's launch plan and lane tree.

The same numpy tables and points go through nerfsys_tpu.models.baked
`baked_trilerp` (eager, jit disabled: jitted XLA on the CPU contracts
multiply-adds) and the port's `baked_trilerp_plain` on the CPU, for packs
2, 4 and 8, dense and sparse tables, bf16 and f32: points on the box's top
faces (at R = 64 the clip to float32(R - 1.000001) gives R - 1, weight 0),
exactly at lo and outside the box, every point in one cell, both sides of
sparse block and super-block edges, each set with a tail of 13 points past
whole warps. Tolerance 1e-6 absolute (payloads O(1), the same cell
selection and float32 lerp tree on both sides).

`baked_plan` is a plain function of the shapes. The tests check that a
team of lanes covers a row in 16-byte pieces, walk the kernel's warp /
team / lane loops to show that every (point, channel) is written exactly
once, tails included, and run the kernel's lane tree (each lane one piece,
partners swapping halves at each lane level, then the sets and rows in
registers) in numpy float32: it must equal the plain version bit for bit,
which is what the kernel promises on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import baked as JB
from nerfsys_tpu_torch.models import baked as TB
from test_torch_baked import _to_jax_table

LO = np.array([-1.0, -0.5, -1.5], np.float32)
HI = np.array([1.0, 1.5, 0.5], np.float32)
N_TAIL = 6 * 32 + 13  # whole warps and a tail
KINDS = ("top_faces", "lo_and_outside", "one_cell", "block_edges", "tail")
# (R, sparse block or 0): dense and sparse at R=16, sparse at R=64 (where
# float32(R - 1.000001) == R - 1: a point on a top face selects R - 1)
LAYOUTS = {"dense16": (16, 0), "sparse16": (16, 4), "sparse64": (64, 8)}


def _points(kind, R, block, seed=0):
    rng = np.random.default_rng(seed)
    h = (HI - LO) / np.float32(R)
    u = rng.uniform(size=(N_TAIL, 3)).astype(np.float32)
    p = LO + u * (HI - LO)
    pick = rng.integers(0, 3, size=p.shape)
    if kind == "top_faces":
        p = np.where(pick == 0, HI, p)
        p[:4] = [HI, [HI[0], LO[1], HI[2]], [LO[0], HI[1], HI[2]], LO]
    elif kind == "lo_and_outside":
        out = np.stack([LO - h, LO - 3 * h, HI + h, HI + 3 * h])
        which = out[rng.integers(0, 4, size=p.shape), [0, 1, 2]]
        p = np.where(pick == 0, LO, np.where(pick == 1, which, p))
    elif kind == "one_cell":
        p[:] = LO + np.float32(0.41) * (HI - LO)
    elif kind == "block_edges":
        B = block or 4
        edges = np.unique(np.concatenate([
            np.arange(B, R, B) - 1, np.arange(B, R, B),
            np.arange(4 * B, R, 4 * B) - 1, np.arange(4 * B, R, 4 * B)]))
        cell = edges[rng.integers(0, edges.size, size=p.shape)]
        p = LO + (cell + np.float32(0.5) + u).astype(np.float32) * h
    return p.astype(np.float32)


def _table(R, block, pack, dtype, sh_levels=2, seed=0):
    """(port baked dict, BakedConfig) with random values; sparse tables
    keep the blocks along the box's top faces and every third other one."""
    bcfg = TB.BakedConfig(resolution=R, sh_levels=sh_levels, dtype=dtype,
                          corner_pack=pack, sparse_block=block)
    rng = np.random.default_rng(seed)
    C, Cp = bcfg.channels, bcfg.padded_channels
    vals = torch.from_numpy(rng.normal(size=(R**3, C)).astype(np.float32))
    if block:
        cells = torch.arange(R**3)
        b = torch.stack([cells // (R * R), (cells // R) % R, cells % R]) \
            // block
        top = (b == R // block - 1).any(dim=0)
        keep = top | ((b[0] + 2 * b[1] + 3 * b[2]) % 3 == 0)
        vals[~keep] = 0.0
    vals = vals.to(bcfg.table_dtype)
    if block:
        table, index = TB.pack_sparse(vals, R, block, Cp, pack)
        baked = {"table": table, "block_index": index}
    else:
        baked = {"table": TB.pack_dense(vals, R, Cp, pack)}
    baked["aabb"] = torch.from_numpy(np.stack([LO, HI]))
    return baked, bcfg


def _plain(baked, bcfg, pts):
    pack = baked["table"].shape[1] // bcfg.padded_channels
    return TB.baked_trilerp_plain(
        baked["table"], baked["aabb"], torch.from_numpy(pts),
        bcfg.resolution, bcfg.channels, bcfg.padded_channels, pack,
        baked.get("block_index"), bcfg.sparse_block)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pack", [2, 4, 8])
def test_plain_matches_jax_on_adversarial_points(pack, dtype, layout, kind):
    R, block = LAYOUTS[layout]
    baked, bcfg = _table(R, block, pack, dtype)
    pts = _points(kind, R, block)
    jcfg = JB.BakedConfig(resolution=R, sh_levels=2, dtype=dtype,
                          corner_pack=pack, sparse_block=block)
    jb = {"table": _to_jax_table(baked["table"]),
          "aabb": jnp.asarray(np.stack([LO, HI]))}
    if block:
        jb["block_index"] = jnp.asarray(baked["block_index"].numpy())
    with jax.disable_jit():
        want = np.asarray(JB.baked_trilerp(jb, jcfg, jnp.asarray(pts)))
    got = _plain(baked, bcfg, pts).numpy()
    assert got.shape == (N_TAIL, bcfg.channels)
    if kind != "lo_and_outside":
        assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# launch plan

def _u(plan, pack):
    """Points whose row loads a team keeps in flight at once (its U)."""
    nr = {8: 1, 4: 2, 2: 4}[pack]
    return max(1, 8 // (nr * plan.sets))


@pytest.mark.parametrize("cp", [32, 40, 56])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("pack", [2, 4, 8])
def test_a_team_covers_a_row_in_pieces(pack, itemsize, cp):
    plan = TB.baked_plan(65536 * 32, pack, cp - 4, cp, itemsize)
    row_pieces = pack * cp * itemsize // 16
    assert plan.pieces * 16 == cp * itemsize
    assert plan.pieces <= 1 << plan.qbits < 2 * plan.pieces
    assert plan.lanes * plan.sets == pack << plan.qbits >= row_pieces
    if plan.pieces == 1 << plan.qbits:  # no padding: one piece a lane
        assert plan.lanes * plan.sets == row_pieces
    assert plan.teams * plan.lanes == 32
    assert plan.sets in (1, 2, 4) and (plan.sets == 1 or plan.lanes == 32)
    # the lane levels halve a piece's channels: 8 bf16 or 4 f32 of them
    lane_levels = {8: 3, 4: 2, 2: 1}[pack] - plan.sets.bit_length() + 1
    assert 0 <= lane_levels and (16 // itemsize) >> lane_levels >= 1
    assert plan.smem == 32 * 4 * (cp - 4) * plan.warps <= 48 * 1024
    assert (32 // plan.teams) % _u(plan, pack) == 0


def test_served_plans():
    """The serve table (pack 8, bf16, Cp 32): one warp a point, one 16-byte
    load a lane; the 128³ f32 pack-4 table: the same, read twice."""
    serve = TB.baked_plan(65536 * 32, 8, 28, 32, 2)
    assert (serve.lanes, serve.sets, serve.teams, serve.warps) == (32, 1, 1, 8)
    assert serve.blocks == 65536 * 32 // 256
    f32 = TB.baked_plan(65536 * 32, 4, 28, 32, 4)
    assert (f32.lanes, f32.sets, f32.teams) == (32, 1, 1)
    assert TB.baked_plan(100, 2, 28, 32, 2).teams == 4
    assert TB.baked_plan(100, 8, 28, 32, 4).sets == 2


@pytest.mark.parametrize("args", [
    (100, 3, 28, 32, 2),  # pack
    (100, 8, 28, 36, 2),  # Cp not whole pieces
    (100, 8, 40, 32, 4),  # C > Cp
    (100, 8, 28, 128, 4),  # a row wider than 4 pieces a lane
    (100, 2, 400, 400, 2),  # 32 points' outputs exceed 48 KB
])
def test_plan_refusals_raise(args):
    with pytest.raises(ValueError):
        TB.baked_plan(*args)


def _lanes(plan, pack, itemsize):
    """Per lane of a warp: (team, lane in team, q, real, first channel)."""
    ch = 16 // itemsize
    lb = {8: 3, 4: 2, 2: 1}[pack] - (plan.sets.bit_length() - 1)
    out = []
    for lane in range(32):
        tl, team = lane % plan.lanes, lane // plan.lanes
        q = tl & ((1 << plan.qbits) - 1)
        off = q * ch + sum(((tl >> (plan.qbits + i)) & 1) * (ch >> (i + 1))
                           for i in range(lb))
        out.append((team, tl, q, q < plan.pieces, off))
    return out, ch >> lb


@pytest.mark.parametrize("n", [1, 31, 32, 33, 256 * 3 + 13])
@pytest.mark.parametrize("cp,c", [(32, 28), (56, 49)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("pack", [2, 4, 8])
def test_walk_writes_every_output_once(pack, itemsize, cp, c, n):
    """The kernel's loops: blocks of `warps` warps over 32-point runs,
    teams over the run's points in steps of U, each real lane writing its
    kept channels below C."""
    plan = TB.baked_plan(n, pack, c, cp, itemsize)
    lanes, keep = _lanes(plan, pack, itemsize)
    seen = np.zeros((n, c), np.int64)
    for blk in range(plan.blocks):
        for w in range(plan.warps):
            base = (blk * plan.warps + w) * 32
            if base >= n:
                continue
            nv = min(32, n - base)
            for it in range(0, 32 // plan.teams, _u(plan, pack)):
                for u in range(_u(plan, pack)):
                    for team, _, _, real, off in lanes:
                        src = (it + u) * plan.teams + team
                        if real and src < nv:
                            for k in range(keep):
                                if off + k < c:
                                    seen[base + src, off + k] += 1
    assert np.all(seen == 1)


def _team_lerp(baked, bcfg, pts):
    """The kernel's lane tree in numpy float32 (one point per column)."""
    table = baked["table"]
    itemsize = table.element_size()
    R, C, Cp = bcfg.resolution, bcfg.channels, bcfg.padded_channels
    pack = table.shape[1] // Cp
    plan = TB.baked_plan(len(pts), pack, C, Cp, itemsize)
    t = table.to(torch.float32).numpy()
    w, xs, ys, iz = TB.lookup_cells(baked["aabb"], torch.from_numpy(pts), R,
                                    pack)
    row_of = TB.table_rows(R, baked.get("block_index"), bcfg.sparse_block)
    rows = [row_of(x, y, iz).numpy() for y in ys for x in xs]  # ix first
    w = w.numpy().astype(np.float32)
    wb = [w[:, 2], w[:, 1], w[:, 0]]  # block bits dz, dy, dx
    ch = 16 // itemsize
    sb = plan.sets.bit_length() - 1
    lb = {8: 3, 4: 2, 2: 1}[pack] - sb
    one = np.float32(1.0)
    # v[r][s][lane]: (CH, N) float32
    v = [[[None] * plan.lanes for _ in range(plan.sets)] for _ in rows]
    for r, rw in enumerate(rows):
        for s in range(plan.sets):
            for tl in range(plan.lanes):
                q = tl & ((1 << plan.qbits) - 1)
                blk = (s << lb) | (tl >> plan.qbits)
                if q < plan.pieces:
                    e = blk * Cp + q * ch
                    v[r][s][tl] = t[rw, e:e + ch].T.copy()
                else:
                    v[r][s][tl] = np.zeros((ch, len(pts)), np.float32)
    for i in range(lb):
        half = ch >> (i + 1)
        for r in range(len(rows)):
            for s in range(plan.sets):
                old = [a.copy() for a in v[r][s]]
                for tl in range(plan.lanes):
                    bit = (tl >> (plan.qbits + i)) & 1
                    partner = old[tl ^ (1 << (plan.qbits + i))]
                    mine = old[tl][half:2 * half] if bit else old[tl][:half]
                    # the partner sends the half this lane keeps
                    recv = partner[half:2 * half] if bit else partner[:half]
                    a, b = (recv, mine) if bit else (mine, recv)
                    v[r][s][tl][:half] = a * (one - wb[i]) + b * wb[i]
    keep = ch >> lb
    for j in range(sb):
        for r in range(len(rows)):
            for s in range(plan.sets):
                if not s & (1 << j):
                    for tl in range(plan.lanes):
                        v[r][s][tl][:keep] = (
                            v[r][s][tl][:keep] * (one - wb[lb + j])
                            + v[r][s | 1 << j][tl][:keep] * wb[lb + j])
    wx, wy = wb[2], wb[1]
    out = np.zeros((len(pts), C), np.float32)
    lanes, _ = _lanes(plan, pack, itemsize)
    for tl in range(plan.lanes):
        _, _, q, real, off = lanes[tl]
        x = [v[r][0][tl][:keep] for r in range(len(rows))]
        if pack == 8:
            val = x[0]
        elif pack == 4:
            val = x[0] * (one - wx) + x[1] * wx
        else:
            val = (x[0] * (one - wx) * (one - wy) + x[1] * wx * (one - wy)
                   + x[2] * (one - wx) * wy + x[3] * wx * wy)
        for k in range(keep):
            if real and off + k < C:
                out[:, off + k] = val[k]
    return out


@pytest.mark.parametrize("sh_levels", [3, 4])  # Cp 32, Cp 56 (padded)
@pytest.mark.parametrize("layout", ["dense16", "sparse16"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pack", [2, 4, 8])
def test_lane_tree_equals_plain_bit_for_bit(pack, dtype, layout, sh_levels):
    R, block = LAYOUTS[layout]
    baked, bcfg = _table(R, block, pack, dtype, sh_levels=sh_levels)
    pts = np.concatenate([_points(k, R, block, seed=3) for k in KINDS])
    np.testing.assert_array_equal(_team_lerp(baked, bcfg, pts),
                                  _plain(baked, bcfg, pts).numpy())
