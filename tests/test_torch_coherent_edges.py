"""Adversarial inputs of the coherent-expert test (kernel row 10b, its
module `nerfsys_tpu_torch.models.container`) against the reference, the
kernel's lane algorithm walked in numpy, and its launch plans.

Inputs come from chip_smoke.py's `coherent_edge_inputs` and
`coherent_edge_cases`, the ones the kernel is held to on the card (numpy
seeds), at fewer rays: K = 1, 2, 4, 16, 64; S = 1, 2, 8, 31, 33, 64, 97;
both routing subspaces; margins 1.0, 1.1, 1.5; samples on a bisector
(equal distances, exact in float32), at duplicated centroids (d = 0 clamps
to 1e-6 on both), at d2 = 1.5 d1 exactly and one float step inside; a
break only at sample 0, at the last sample, at sample 32; N = 0 and 1.
The reference side runs nerfsys_tpu.models.container
`routing_coherent_expert` eagerly (at K = 1 with hard routing: its soft
singleton test raises with one expert, which is always alone). The lane walk repeats csrc/coherent.cu
at the wrapper's plan in float32 numpy: pieces of `lanes` samples, each
lane's K distances in the kernel's order (no fused multiply-adds, as the
kernel is built), the first-index argmin with a strict <, the two smallest
clamped distances, sample 0's argmin from the segment's first lane, one
vote a piece per ray, and the warp's stop once every ray it holds has
broken. Ids must be equal everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerfsys_tpu.models import container as JCo
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.ops import volrend as TV
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

CASES = cs.coherent_edge_cases()
IDS = [c[0].replace(" ", "_").replace(",", "") for c in CASES]
N = 77  # rays a case: tails past whole warps at every plan
CPU = torch.device("cpu")


def _inputs(case, seed):
    _, kind, n, k, s, c2d, margin = case
    cents, pts = cs.coherent_edge_inputs(kind, min(n, N), k, s, seed, CPU)
    return cents, pts, c2d, margin


def _reference(cents, pts, c2d, margin):
    k = cents.shape[0]
    # one expert is always alone in the blend; the reference's singleton
    # test takes lax.top_k(k=2), which raises at K = 1, so it is held there
    # at hard routing, the same function
    cfg = JCo.ContainerConfig(num_experts=k,
                              boundary_margin=margin if k > 1 else 1.0,
                              cluster_2d=c2d)
    st = JCo.ContainerStatics(jnp.asarray(cents.numpy()),
                              jnp.zeros((k, 2, 3)), jnp.zeros((2, 3)))
    with jax.disable_jit():
        return np.asarray(JCo.routing_coherent_expert(
            st, cfg, jnp.asarray(pts.numpy())))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_the_reference(case):
    """The plain version and the wrapper on CPU tensors against the
    reference's routing_coherent_expert: ids equal."""
    args = _inputs(case, CASES.index(case))
    # no rays: the reference's reshape(N, S, -1) cannot size the -1
    want = (_reference(*args) if args[1].shape[0]
            else np.zeros((0,), np.int32))
    for fn in (TCo.coherent_expert_plain, TCo.coherent_expert_kernel):
        got = fn(*args)
        assert got.dtype == torch.int32 and got.shape == (args[1].shape[0],)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the kernel's lanes, walked in numpy


def _lane_walk(cents, pts, c2d, margin):
    """Kernel 10b as its lanes compute it -> (ids, samples each ray's warp
    read)."""
    f32 = np.float32
    cents, pts = cents.numpy(), pts.numpy()
    n, S, _ = pts.shape
    plan = TV.ray_lane_plan(n, S, TCo.COHERENT_GROUPS, TCo.COHERENT_LANES)
    W, lo = plan.lanes, 1 if c2d else 0
    c = cents[:, lo:]
    sc = c[:, 0] * c[:, 0]
    for j in range(1, c.shape[1]):
        sc = sc + c[:, j] * c[:, j]
    soft = f32(margin) > f32(1.0)
    warp = np.arange(n) // plan.rays_per_warp
    same = np.ones(n, bool)
    going = np.ones(n, bool)  # the ray's warp has not stopped
    a0 = np.zeros(n, np.int64)
    read = np.zeros(n, np.int64)
    for p in range(plan.pieces):
        x = pts[:, p * W:(p + 1) * W, lo:]  # lane l: sample p * W + l
        sx = x[..., 0] * x[..., 0]
        for j in range(1, x.shape[-1]):
            sx = sx + x[..., j] * x[..., j]
        x2 = f32(2.0) * x
        best = np.full(sx.shape, np.inf, f32)
        m1, m2 = best.copy(), best.copy()
        a = np.zeros(sx.shape, np.int64)
        for k in range(c.shape[0]):
            dot = x2[..., 0] * c[k, 0]
            for j in range(1, x.shape[-1]):
                dot = dot + x2[..., j] * c[k, j]
            d = np.sqrt(np.maximum((sx - dot) + sc[k], f32(0.0)))
            first = d < best  # strict: the first index on ties
            best, a = np.where(first, d, best), np.where(first, k, a)
            dc = np.maximum(d, f32(1e-6))
            lt1 = dc < m1
            m2 = np.where(lt1, m1, np.where(dc < m2, dc, m2))
            m1 = np.where(lt1, dc, m1)
        if p == 0:
            a0 = a[:, 0]  # the segment's first lane's, by shuffle
        ok = (a == a0[:, None]) & (~soft | (m2 > f32(margin) * m1))
        read[going] += x.shape[1]
        same &= ok.all(axis=1)  # the segment's ballot
        alive = np.bincount(warp, weights=same,
                            minlength=n // plan.rays_per_warp + 1)
        going = alive[warp] > 0  # the warp's vote
        if plan.pieces > 1 and not going.any():
            break
    return np.where(same, a0, -1), read


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lane_walk_matches_plain(case):
    """The kernel's lane algorithm at its plan: ids equal to the plain
    version's, and no warp stops before each of its rays is decided."""
    args = _inputs(case, CASES.index(case) + 100)
    ids, read = _lane_walk(*args)
    np.testing.assert_array_equal(ids,
                                  TCo.coherent_expert_plain(*args).numpy())
    assert (read >= cs.coherent_needed(*args).numpy()).all()


@pytest.mark.parametrize("s", [9, 32, 33, 97])
def test_warp_stops_after_the_piece_that_broke_its_rays(s):
    """Every ray broken at sample 0: each warp reads its first piece only
    when the ray takes several."""
    cents, pts = cs.coherent_edge_inputs("break0", N, 4, s, 3, CPU)
    pts[:, 0] = cents[1]
    ids, read = _lane_walk(cents, pts, True, 1.1)
    assert (ids == -1).all()
    plan = TV.ray_lane_plan(N, s, TCo.COHERENT_GROUPS, TCo.COHERENT_LANES)
    assert plan.pieces > 1 and (read == plan.lanes).all()


# ---------------------------------------------------------------------------
# launch plans


@pytest.mark.parametrize("n,s", [(0, 32), (1, 1), (77, 1), (77, 2),
                                 (300, 8), (77, 16), (77, 17), (65, 31),
                                 (77, 33), (33, 97), (4096, 32),
                                 (65_536 + 13, 32)])
def test_plan_visits_every_sample_once(n, s):
    """Blocks, warps, groups, lanes and pieces of the grid-stride loop
    cover each (ray, sample) once, and each ray's first lane (the one that
    writes its id) once; with a grid of one block too."""
    full = TV.ray_lane_plan(n, s, TCo.COHERENT_GROUPS, TCo.COHERENT_LANES)
    assert full.lanes == min(TCo.COHERENT_LANES, TV.ray_lanes(s))
    assert full.groups == TCo.COHERENT_GROUPS and full.threads == 256
    W, warps = full.lanes, full.threads // 32
    lane = np.arange(32)
    for blocks in (full.blocks, 1):
        stride = blocks * warps * full.rays_per_warp
        gw = np.arange(blocks * warps)  # the grid's warps, each looping
        firsts = (gw[:, None] * full.rays_per_warp
                  + stride * np.arange(-(-n // stride) + 1)[None, :]).ravel()
        firsts = firsts[firsts < n]
        ray = (firsts[:, None, None] + np.arange(full.groups)[:, None]
               * (32 // W) + lane // W)
        live = ray < n
        seen = np.zeros((n, s), np.int64)
        for p in range(full.pieces):
            smp = p * W + lane % W + 0 * ray
            on = live & (smp < s)
            np.add.at(seen, (ray[on], smp[on]), 1)
        writers = np.bincount(ray[live & (lane % W == 0)], minlength=n)
        assert (seen == 1).all() and (writers == 1).all()


def test_plan_limits_and_struct():
    """s >= 1 (row 10b takes one-sample rays; kernel 4's plan still
    refuses S < 2); the struct is cached per shape in the kernels' field
    order; 8 lanes a ray at most, so S = 97 takes 13 pieces."""
    p = TCo.ray_lane_struct(1000, 97, TCo.COHERENT_GROUPS,
                            TCo.COHERENT_LANES)
    assert p is TCo.ray_lane_struct(1000, 97, TCo.COHERENT_GROUPS,
                                    TCo.COHERENT_LANES)
    assert [k for k, _ in type(p)._fields_] == [
        "lanes", "pieces", "groups", "threads", "blocks"]
    assert (p.lanes, p.pieces, p.groups) == (8, 13, TCo.COHERENT_GROUPS)
    one = TV.ray_lane_plan(5, 1, TCo.COHERENT_GROUPS, TCo.COHERENT_LANES)
    assert (one.lanes, one.pieces, one.blocks) == (1, 1, 1)
    for bad in ((10, 0, 2, 16), (10, 8, 0, 16), (10, 8, 2, 12)):
        with pytest.raises(ValueError):
            TV.ray_lane_plan(*bad)
    with pytest.raises(ValueError, match="S >= 2"):
        TV.volrend_plan(10, 1, backward=False)
