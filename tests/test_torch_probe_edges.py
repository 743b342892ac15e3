"""Adversarial inputs of the union occupancy probe (kernel 2, its module
`nerfsys_tpu_torch.ops.occupancy`) against JAX, the kernel's algorithm
walked in numpy, its level tables and their cache, and its launch plans.

Inputs come from chip_smoke.py's `probe_edge_inputs`, the ones the kernel
is held to on the card (numpy seeds): probe points on level borders and
one ulp either side (rays with d = 0, and rays moving along x only),
points outside every level, all-dead rays, one occupied cell with the
rays aimed through it, values below 1.05e-14 (sum(val) on either side
of the 1e-12 threshold, on rays with occupied probes), P in {32, 100,
128, 256}, K=1 L=1 (the union grid), K=1 L=4 (a task probe), K=5 (two
expert groups), importance on and off, ray_floor 0 and 0.25. The JAX
side is nerfsys_tpu.ops.occupancy `occupancy_probe_cdf` with
nerfsys_tpu.models.occupancy `union_pair_fn` (jit disabled); the port's
side `occupancy_probe_cdf_plain` through `union_pair` and the kernel
wrapper on CPU tensors (its plain version).
Tolerances: occupancy bits and alive flags exactly; the cdf within 1e-6
against JAX (the same operations, XLA's cumsum order); against the numpy
walk of the kernel (a warp butterfly and a Kogge-Stone scan), within 1e-5
for the wrapper on CPU tensors (torch's reductions) and bit for bit for
the plain version in the kernel's order (`kernel_order=True`, its default
on the card).
"""
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerfsys_tpu.models.occupancy import union_pair_fn as j_union_pair_fn
from nerfsys_tpu.ops import occupancy as J
from nerfsys_tpu_torch.ops import occupancy as T

JAX_TOL = 1e-6
WALK_TOL = 1e-5
N = 133  # a tail past whole 32-ray blocks and 8-ray blocks
f32 = np.float32

CASES = cs.probe_edge_cases()
IDS = [c[0].replace(" ", "_") for c in CASES]
Statics = namedtuple("Statics", "expert_aabbs")


def _inputs(case, seed, n=N):
    _, kind, P, K, L, R, imp, rf = case
    return cs.probe_edge_inputs(kind, n, K, L, R, seed), dict(
        n_probes=P, importance=imp, ray_floor=rf)


def _jax(arrays, kw):
    occs, binary, boxes, o, d, near, far = arrays
    state = {"occs": jnp.asarray(occs), "binary": jnp.asarray(binary)}
    pair = j_union_pair_fn(state, Statics(jnp.asarray(boxes)))
    with jax.disable_jit():
        out = J.occupancy_probe_cdf(
            lambda p: pair(p)[0], jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(near), jnp.asarray(far), kw["n_probes"],
            uniform_frac=0.25, ray_floor=kw["ray_floor"],
            pair_fn=pair if kw["importance"] else None)
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_args(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_probe_matches_jax_on_edges(case):
    """The plain version (and the wrapper on CPU tensors) against JAX's
    probe over the union of the experts' grids."""
    arrays, kw = _inputs(case, seed=3)
    want = _jax(arrays, kw)
    args = _torch_args(arrays)
    for fn in (T.occupancy_probe_cdf_kernel,
               lambda *a, **k: T.occupancy_probe_cdf(*a, **k,
                                                     use_kernels=False)):
        got = fn(*args, **kw)
        np.testing.assert_array_equal(got["occ"].numpy(), want["occ"])
        np.testing.assert_array_equal(got["alive"].numpy(), want["alive"])
        np.testing.assert_allclose(got["cdf"].numpy(), want["cdf"], rtol=0,
                                   atol=JAX_TOL)
    P = kw["n_probes"]
    assert got["cdf"].shape == (N, P + 1)
    assert (got["cdf"][:, -1] == 1.0).all()


def test_edge_inputs_hit_their_cases():
    """Each adversarial kind does what it says: border points lie exactly
    on or one ulp beside a level border, the dead grid has no alive ray,
    the single cell leaves most rays one or two occupied probes, and the
    tiny values put sum(val) on either side of 1e-12 on rays with
    occupied probes."""
    cases = {c[1]: c for c in CASES}
    arrays, kw = _inputs(cases["borders"], seed=0)
    _, _, boxes, o, d, _, _ = arrays
    la = T.level_aabbs(torch.from_numpy(boxes), 4).numpy()
    edges = la.reshape(-1, 3)
    third = N // 3
    near_edge = np.zeros((third, 3), bool)
    for e in edges:
        for step in (-1, 0, 1):
            v = e.copy()
            if step:
                v = np.nextafter(v, f32(np.inf) if step > 0
                                 else f32(-np.inf))
            near_edge |= o[:third] == v
    assert near_edge.all() and not d[:third].any()
    got = T.occupancy_probe_cdf_plain(
        lambda p: T.union_pair(*_torch_args(arrays[:3]), p),
        *_torch_args(arrays[3:]), **kw)
    assert 0.2 < float(got["occ"].float().mean()) < 0.95
    arrays, kw = _inputs(cases["dead"], seed=0)
    got = T.occupancy_probe_cdf_kernel(*_torch_args(arrays), **kw)
    assert not got["alive"].any()
    arrays, kw = _inputs(cases["single"], seed=0)
    got = T.occupancy_probe_cdf_kernel(*_torch_args(arrays), **kw)
    per_ray = got["occ"].sum(dim=1)
    assert float((per_ray <= 3).float().mean()) > 0.9
    assert float((per_ray >= 1).float().mean()) > 0.9
    arrays, kw = _inputs(cases["tiny"], seed=0)
    args = _torch_args(arrays)
    occ, val = T.union_pair(*args[:3], T._probe_points(
        *args[3:], kw["n_probes"]).reshape(-1, 3))
    vsum = (val * occ).reshape(N, -1).sum(dim=1)
    below = float((vsum < 1e-12).float().mean())
    assert occ.reshape(N, -1).any(dim=1).all() and 0.2 < below < 0.8


# ---------------------------------------------------------------------------
# the kernel, walked in numpy


def _probe_values(table, occs, binary, pts, K, L, R, importance):
    """Phase 1's value of each probe point (M, 3), as csrc/occ_probe.cu
    computes it: the level by the table's bounds, the cell by the true
    division at that level, the K bits first and the values only where the
    union is set: -1 for a probe no expert occupies, else max_k val_k (0
    without importance)."""
    M = pts.shape[0]
    flat = np.full((K, M), -1, np.int64)
    for k in range(K):
        done = np.zeros(M, bool)
        for l in range(L):
            t = table[k, l]
            a, b, lo, w = t[0:3], t[3:6], t[6:9], t[9:12]
            ins = ((pts >= a) & (pts < b)).all(axis=1) & ~done
            rel = ((pts - lo).astype(f32) / w).astype(f32)
            ijk = np.clip(np.trunc((rel * f32(R)).astype(f32)), 0,
                          R - 1).astype(np.int64)
            cell = (((k * L + l) * R + ijk[:, 0]) * R + ijk[:, 1]) * R \
                + ijk[:, 2]
            flat[k] = np.where(ins, cell, flat[k])
            done |= ins
    bits, vals = binary.reshape(-1), occs.reshape(-1)
    oc = ((flat >= 0) & bits[np.maximum(flat, 0)]).any(axis=0)
    v = np.where(flat >= 0, np.maximum(vals[np.maximum(flat, 0)], f32(0)),
                 f32(0)).max(axis=0)
    return np.where(oc, v if importance else f32(0), f32(-1)).astype(f32)


def _butterfly(v):
    """__shfl_xor_sync sums over the 32 lanes (last axis): every lane ends
    with the same rounded total."""
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., lane ^ off]).astype(f32)
    return v


def _kernel_walk(arrays, kw, lane_map=None):
    """Kernel 2 as its threads compute it, in float32 numpy, at the plan
    `occ_probe_plan` gives: phase 1 fills each block's rays x stride tile
    through the plan's (ray, probe) thread map; phase 2 takes a ray a warp,
    lane l holding probes l + 32 j, per-lane partial sums over j then a
    butterfly, a Kogge-Stone scan with a carry, cdf = cum / total."""
    occs, binary, boxes, o, d, near, far = arrays
    P, imp, rf = kw["n_probes"], kw["importance"], kw["ray_floor"]
    K, L, R = occs.shape[:3]
    n = o.shape[0]
    plan = T.occ_probe_plan(n, P, K, L, lane_map)
    table = T.level_bounds(torch.from_numpy(boxes), L).numpy()
    mids = T._probe_mids(P, "cpu").numpy()
    warps = plan.threads // 32
    tile = np.full((plan.blocks, plan.rays, plan.stride), np.nan, f32)
    # phase 1: every (block, warp, lane, probe step) of the plan
    blk, warp, lane = np.meshgrid(np.arange(plan.blocks), np.arange(warps),
                                  np.arange(32), indexing="ij")
    r = lane if plan.lane_map == "rays" else warp
    p0 = warp if plan.lane_map == "rays" else lane
    dp = warps if plan.lane_map == "rays" else 32
    ray = blk * plan.rays + r
    visits = np.zeros((n, P), np.int64)
    for step in range(-(-P // dp)):
        p = p0 + step * dp
        on = (ray < n) & (p < P)
        rr, pp = ray[on], p[on]
        np.add.at(visits, (rr, pp), 1)
        t = (near[rr] + (far[rr] - near[rr]) * mids[pp]).astype(f32)
        pts = (o[rr] + d[rr] * t[:, None]).astype(f32)
        tile[blk[on], r[on], pp] = _probe_values(table, occs, binary, pts, K,
                                                 L, R, imp)
    assert (visits == 1).all()
    # phase 2: a ray a warp, lanes over its probes
    J = plan.chunks
    rows = tile[:, :, :P].reshape(-1, P)[:n]
    e = np.full((n, J * 32), f32(-1))
    e[:, :P] = rows
    e = e.reshape(n, J, 32)  # [ray, j, lane] = probe lane + 32 j
    live = (np.arange(J * 32) < P).reshape(J, 32)
    occ = e >= 0
    occf = occ.astype(f32)
    val = np.where(occ, e, f32(0))
    c_imp, c_uni = f32(1.0 - 0.25), f32(0.25)
    if imp:
        vs, os_ = np.zeros((n, 32), f32), np.zeros((n, 32), f32)
        for j in range(J):
            vs = (vs + val[:, j]).astype(f32)
            os_ = (os_ + occf[:, j]).astype(f32)
        vsum = _butterfly(vs)[:, :1]
        r_osum = (f32(1) / np.maximum(_butterfly(os_)[:, :1],
                                      f32(1e-12))).astype(f32)
        uni = np.where(occ, r_osum[:, None], f32(0))
        imp_w = np.where(vsum[:, None] > f32(1e-12),
                         (val / np.maximum(vsum[:, None], f32(1e-12))
                          ).astype(f32), uni)
        w = ((c_imp * imp_w).astype(f32) + (c_uni * uni).astype(f32))
    else:
        w = occf
    w = w.astype(f32)
    if rf > 0.0:
        ws = np.zeros((n, 32), f32)
        for j in range(J):
            ws = (ws + np.where(live[j], w[:, j], f32(0))).astype(f32)
        wsum = np.maximum(_butterfly(ws)[:, :1], f32(1e-12))[:, None]
        w = ((f32(1.0 - rf) * (w / wsum).astype(f32)).astype(f32)
             + f32(rf / P)).astype(f32)
    lane = np.arange(32)
    cum = np.zeros((n, J, 32), f32)
    carry = np.zeros((n, 1), f32)
    for j in range(J):
        x = np.where(live[j], (w[:, j] + f32(1e-12)).astype(f32), f32(0))
        for off in (1, 2, 4, 8, 16):
            y = np.zeros_like(x)
            y[:, off:] = x[:, :-off]
            x = np.where(lane >= off, (x + y).astype(f32), x)
        cum[:, j] = (x + carry).astype(f32)
        carry = (carry + x[:, 31:]).astype(f32)
    cdf = (cum / carry[:, :, None]).astype(f32).reshape(n, -1)[:, :P]
    return {"cdf": np.concatenate([np.zeros((n, 1), f32), cdf], axis=1),
            "occ": occ.reshape(n, -1)[:, :P], "alive": occ.any(axis=(1, 2))}


@pytest.mark.parametrize("lane_map", T.PROBE_LANE_MAPS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_walk_matches_plain(case, lane_map):
    """The kernel's algorithm under each lane map against the plain
    version: the same bits and alive flags, the cdf within 1e-5 of the
    wrapper on CPU tensors and bit-equal to the plain version in the
    kernel's order."""
    arrays, kw = _inputs(case, seed=11)
    want = T.occupancy_probe_cdf_kernel(*_torch_args(arrays), **kw)
    got = _kernel_walk(arrays, kw, lane_map)
    np.testing.assert_array_equal(got["occ"], want["occ"].numpy())
    np.testing.assert_array_equal(got["alive"], want["alive"].numpy())
    np.testing.assert_allclose(got["cdf"], want["cdf"].numpy(), rtol=0,
                               atol=WALK_TOL)
    occs, binary, boxes, *rays = _torch_args(arrays)
    same = T.occupancy_probe_cdf_plain(
        lambda pts: T.union_pair(occs, binary, boxes, pts), *rays,
        kw["n_probes"], kw["importance"], 0.25, kw["ray_floor"],
        kernel_order=True)
    np.testing.assert_array_equal(got["cdf"], same["cdf"].numpy())
    np.testing.assert_array_equal(got["occ"], same["occ"].numpy())


# ---------------------------------------------------------------------------
# level tables


BOXES = [[[-1.2, -2.2, -0.2], [1.2, 0.2, 2.2]], [[0.0, 0.0, 0.0],
                                                 [1.0, 1.0, 1.0]],
         [[-0.37, 1.1, 5.3], [0.41, 1.9, 6.0]],
         [[-1e-3, -3e4, 2.0], [1e-3, 3e4, 2.0000005]]]


@pytest.mark.parametrize("box", BOXES, ids=["bench", "unit", "offset",
                                            "extreme"])
def test_level_bounds_decide_as_the_division(box):
    """On each axis a <= x < b holds exactly where 0 <= (x - lo) / (hi -
    lo) < 1 as the plain version rounds it, at every border and within
    three ulps either side, at signed zeros and subnormals, and at random
    points; so kernel 2's comparison tests pick the plain version's
    levels."""
    aabb = torch.tensor(box, dtype=torch.float32)
    L = 4
    table = T.level_bounds(aabb[None], L)[0]
    la = T.level_aabbs(aabb, L)
    base = torch.cat([la.reshape(-1), torch.tensor([0.0, -0.0, 1.4e-45,
                                                    -1.4e-45, 3e-38])])
    xs = [base]
    for direction in (np.inf, -np.inf):
        x = base
        for _ in range(3):
            x = torch.nextafter(x, torch.tensor(direction))
            xs.append(x)
    xs = torch.cat(xs)
    rng = np.random.default_rng(0)
    rand = torch.from_numpy(rng.uniform(-30, 30, 3000).astype(f32))
    for l in range(L):
        lo, hi = la[l, 0], la[l, 1]
        for c in range(3):
            x = torch.cat([xs, rand, torch.tensor([np.inf, -np.inf,
                                                   np.nan])])
            rel = (x - lo[c]) / (hi[c] - lo[c])
            want = (rel >= 0.0) & (rel < 1.0)
            got = (x >= table[l, c]) & (x < table[l, 3 + c])
            assert torch.equal(got, want), (l, c)
        np.testing.assert_array_equal(table[l, 6:9].numpy(), lo.numpy())
        np.testing.assert_array_equal(table[l, 9:12].numpy(),
                                      (hi - lo).numpy())


def test_level_bounds_select_the_plain_cells():
    """Whole points: the level the table's bounds select, and the cell the
    deciding level's division gives, equal `_finest_level_index`'s at
    cell borders one ulp either side and at random points."""
    rng = np.random.default_rng(4)
    for box in BOXES[:3]:
        aabb = torch.tensor(box, dtype=torch.float32)
        L, R = 3, 100
        la = T.level_aabbs(aabb, L).numpy()
        pts = [rng.uniform(-10, 10, (5000, 3)).astype(f32)]
        for l in range(L):
            j = rng.integers(0, R + 1, size=(4000, 3))
            p = (la[l, 0] + (la[l, 1] - la[l, 0]) * j / R).astype(f32)
            pts += [p, np.nextafter(p, f32(np.inf)),
                    np.nextafter(p, f32(-np.inf))]
        pts = np.concatenate(pts)
        table = T.level_bounds(aabb[None], L).numpy()
        occs = np.arange(L * R ** 3, dtype=f32).reshape(1, L, R, R, R)
        binary = np.ones(occs.shape, bool)
        got = _probe_values(table, occs, binary, pts, 1, L, R, True)
        dec, flat = T._finest_level_index(aabb, L, R, torch.from_numpy(pts))
        want = np.where(dec.numpy(), flat.numpy().astype(f32), f32(-1))
        np.testing.assert_array_equal(got, want)


def test_degenerate_levels_are_never_inside():
    """A box of zero width on an axis: the plain version's 0 / 0 and
    x / 0 are never inside [0, 1), and the table's bounds say the same."""
    aabb = torch.tensor([[[0.0, 0.0, 1.0], [1.0, 1.0, 1.0]]])
    table = T.level_bounds(aabb, 2)
    assert torch.isinf(table[..., 2]).all() and (table[..., 2] > 0).all()
    assert (table[..., 5] < 0).all()
    x = torch.tensor([1.0, 0.5, 2.0, -1.0])
    rel = (x - 1.0) / torch.tensor(0.0)
    assert not ((rel >= 0) & (rel < 1)).any()


def test_first_float_bisection():
    """`_first_float` finds the least float with a monotone predicate,
    across signs and binades, with no host round trip."""
    lo = torch.tensor([-np.inf, -1.0, 0.0, 1e-40, -3.0], dtype=torch.float32)
    hi = torch.tensor([0.0, 2.0, 1.0, 1.0, np.inf], dtype=torch.float32)
    cut = torch.tensor([-0.0, 0.1, 1e-30, 1e-38, 2.5], dtype=torch.float32)
    got = T._first_float(lambda x: x >= cut, lo, hi)
    torch.testing.assert_close(got, cut, rtol=0, atol=0)
    assert torch.equal(T._key_float(T._float_key(hi)), hi)
    assert bool(torch.signbit(got[0]))  # -0.0 orders just below +0.0


def test_level_table_cache_follows_the_boxes():
    """The cache hits for the same boxes (and for a new view of the same
    storage), misses after an in-place write (the version counter), keeps
    each expert's slice apart, holds the boxes alive and stays bounded."""
    T._LEVEL_TABLES.clear()
    boxes = torch.tensor([[[-1.0, -1, -1], [1, 1, 1]],
                          [[0.0, 0, 0], [2, 2, 2]]])
    t0 = T._level_table(boxes, 3)
    assert T._level_table(boxes, 3) is t0
    assert T._level_table(boxes[:], 3) is t0  # same storage, offset, shape
    t1 = T._level_table(boxes[1:2], 3)
    assert t1 is not t0
    torch.testing.assert_close(t1[0], t0[1], rtol=0, atol=0)
    assert T._level_table(boxes, 2) is not t0
    boxes[0, 1, 0] = 3.0
    t2 = T._level_table(boxes, 3)
    assert t2 is not t0 and float(t2[0, 0, 3]) == 3.0
    assert T._level_table(boxes[0:1], 3)[0, 0, 3] == 3.0
    entry = next(iter(T._LEVEL_TABLES.values()))
    assert entry[0].untyped_storage().data_ptr() == \
        boxes.untyped_storage().data_ptr()
    for i in range(T.LEVEL_TABLES_KEPT + 5):
        T._level_table(torch.full((1, 2, 3), float(i)) + torch.tensor(
            [[[0.0] * 3, [1.0] * 3]]), 1)
    assert len(T._LEVEL_TABLES) == T.LEVEL_TABLES_KEPT


# ---------------------------------------------------------------------------
# launch plans


SHAPES = {"serve chunk": (65_536, 128, 4, 4), "step": (4_000, 128, 1, 4),
          "union grid": (65_536, 128, 1, 1), "K=16 moe": (65_536, 128, 16, 4),
          "empty": (0, 128, 4, 4), "tail": (65_536 + 13, 100, 4, 4),
          "P=256 tail": (4_109, 256, 4, 4), "P=1": (33, 1, 2, 2)}


@pytest.mark.parametrize("lane_map", (None,) + T.PROBE_LANE_MAPS)
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_plan_covers_every_probe_once(shape, lane_map):
    """Blocks cover every ray once in phase 2, threads every (ray, probe)
    once in phase 1; the tile's odd stride keeps both phases free of bank
    conflicts; the table and tile fit the 48 KB that needs no opt-in."""
    n, P, K, L = SHAPES[shape]
    plan = T.occ_probe_plan(n, P, K, L, lane_map)
    if lane_map is None:
        assert plan.lane_map == ("rays" if n >= T.PROBE_RAYS_MIN
                                 else "probes")
    warps = plan.threads // 32
    assert plan.rays == (32 if plan.lane_map == "rays" else warps)
    assert plan.blocks * plan.rays >= max(n, 1)
    assert plan.blocks == max(1, -(-n // plan.rays))
    assert plan.stride % 2 == 1 and plan.stride >= P
    assert plan.smem == 4 * (K * L * T.BOX_FLOATS + plan.rays * plan.stride)
    assert plan.smem <= 48 * 1024
    assert plan.group == (1 if K == 1 else 4)
    assert 32 * plan.chunks >= P and (plan.chunks == 1
                                      or 16 * plan.chunks < P)
    assert plan.chunks in (1, 2, 4, 8)
    # phase 1 banks: a store instruction's 32 lanes hit 32 banks
    if plan.lane_map == "rays":
        for p in range(min(P, 40)):
            banks = (np.arange(32) * plan.stride + p) % 32
            assert len(set(banks)) == 32
    # coverage, on a sample of blocks for the large shapes
    blocks = range(plan.blocks) if n < 5000 else [0, plan.blocks - 1]
    seen = {}
    for b in blocks:
        for w in range(warps):
            for lane in range(32):
                r = lane if plan.lane_map == "rays" else w
                p0 = w if plan.lane_map == "rays" else lane
                dp = warps if plan.lane_map == "rays" else 32
                ray = b * plan.rays + r
                for p in range(p0, P, dp):
                    if ray < n:
                        seen[(ray, p)] = seen.get((ray, p), 0) + 1
    assert all(v == 1 for v in seen.values())
    if n < 5000:
        assert len(seen) == n * P


def test_plan_limits_and_struct():
    """P outside 1..256 is refused, as is a tile past 48 KB; the struct
    carries the fields in the kernel's order and is cached per shape."""
    with pytest.raises(ValueError, match="P <= 256"):
        T.occ_probe_plan(100, 257, 4, 4)
    with pytest.raises(ValueError, match="shared memory"):
        T.occ_probe_plan(100_000, 256, 64, 8)
    with pytest.raises(ValueError, match="lane_map"):
        T.occ_probe_plan(100, 128, 4, 4, "warps")
    st = T._probe_struct(65_536, 128, 4, 4)
    assert st is T._probe_struct(65_536, 128, 4, 4)
    assert [f for f, _ in type(st)._fields_] == [
        "lane_map", "rays", "threads", "blocks", "stride", "smem", "group",
        "chunks"]
    assert (st.lane_map, st.rays, st.blocks, st.stride, st.chunks) == (
        1, 32, 2048, 129, 4)
