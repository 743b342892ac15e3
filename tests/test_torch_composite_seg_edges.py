"""Adversarial inputs of the segment compositor (kernel row 8, its module
`nerfsys_tpu_torch.ops.volrend`) against the reference, the kernel's lane
algorithm walked in numpy, and its launch plans.

Inputs come from chip_smoke.py's `composite_edge_inputs` and
`composite_edge_cases`, the ones the kernel is held to on the card (numpy
seeds), at fewer rays: s = 1, 2, 8, 24, 31, 33, 64; alpha at its
1 - 1e-7 clip (sigma * dt >= 17); sigma exactly 0; a carried
transmittance of 0, 1 and 1e-30; fog on and off; t and dt as column slices
of (N, s + 9) arrays and as contiguous copies; N = 0 and 1. The reference
side runs nerfsys_tpu.ops.volrend `composite_segment` eagerly on the same
numbers. The lane walk repeats csrc/composite_seg.cu at the wrapper's plan
in float32 numpy: a ray's samples on `lanes` lanes in pieces, the
transmittance as an inclusive product scan (Kogge-Stone) shifted by one
lane times the pieces before, w = (alpha * T_loc) * T_carry, butterfly
segment sums (and max), each sum added to the carry. Tolerances, absolute
on every output: 1e-6 for the plain version against the reference (the
same operations, sums in other orders), 1e-5 for the walk (a product tree
for T), the card's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerfsys_tpu.ops import volrend as JV
from nerfsys_tpu_torch.ops import volrend as TV
from test_torch_volrend_edges import _seg_shift
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

JAX_TOL = 1e-6
WALK_TOL = 1e-5
CASES = cs.composite_edge_cases()
IDS = [c[0].replace(" ", "_").replace(",", "") for c in CASES]
N = 77  # rays a case: tails past whole warps at every plan
CPU = torch.device("cpu")


def _inputs(case, seed):
    _, kind, n, s, fog, layout = case
    return cs.composite_edge_inputs(kind, min(n, N), s, fog, layout, seed,
                                    CPU)


def _err(got, want) -> float:
    assert set(got) == set(want)
    return max((float(np.abs(np.asarray(got[k], np.float64)
                             - np.asarray(want[k], np.float64)).max())
                for k in want if np.asarray(want[k]).size), default=0.0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_the_reference(case):
    """The plain version and the wrapper on CPU tensors (t and dt as the
    case lays them out) against the reference's composite_segment."""
    carry, rgb, sigma, t, dt = _inputs(case, CASES.index(case))
    jc = {k: jnp.asarray(v.numpy()) for k, v in carry.items()}
    with jax.disable_jit():
        want = JV.composite_segment(jc, *(jnp.asarray(a.numpy()) for a in (
            rgb, sigma, t, dt)))
    want = {k: np.asarray(v) for k, v in want.items()}
    for fn in (TV.composite_segment_plain, TV.composite_segment):
        got = fn(carry, rgb, sigma, t, dt)
        assert all(bool(torch.isfinite(v).all()) for v in got.values())
        assert _err({k: v.numpy() for k, v in got.items()}, want) <= JAX_TOL


# ---------------------------------------------------------------------------
# the kernel's lanes, walked in numpy


def _lane_walk(carry, rgb, sigma, t, dt):
    """Row 8 as its lanes compute it -> the new carry."""
    f32 = np.float32
    c = {k: v.numpy() for k, v in carry.items()}
    rgb, sigma, t, dt = (a.numpy() for a in (rgb, sigma, t, dt))
    n, s = sigma.shape
    plan = TV.ray_lane_plan(n, s, 1)
    W, lane = plan.lanes, np.arange(plan.lanes)
    fog = "wmax" in c
    T = np.ones(n, f32)
    sums = np.zeros((6, n, W), f32)  # r, g, b, depth, acc, w log w
    wmax = np.full((n, W), -np.inf, f32)
    for p in range(plan.pieces):
        j = p * W + lane
        on = j < s
        jc = np.minimum(j, s - 1)

        def take(a):
            return np.where(on, a[:, jc], f32(0.0))

        e = np.exp(-take(sigma) * take(dt)).astype(f32)
        alpha = np.minimum(np.maximum(f32(1.0) - e, f32(0.0)),
                           f32(1.0) - f32(1e-7))
        m = f32(1.0) - alpha + f32(1e-10)  # exactly 1 off the samples
        incl, d = m.copy(), 1
        while d < W:
            incl = np.where(lane >= d, incl * _seg_shift(incl, d, 1, True),
                            incl)
            d *= 2
        ex = _seg_shift(incl, 1, 1, True)  # lane 0 takes 1
        w = (alpha * (T[:, None] * ex)) * c["trans"][:, None]
        for k in range(3):
            sums[k] += w * np.where(on, rgb[:, jc, k], f32(0.0))
        sums[3] += w * take(t)
        sums[4] += w
        if fog:
            wmax = np.maximum(wmax, w)
            sums[5] += w * np.log(np.maximum(w, f32(1e-12))).astype(f32)
        T = T * incl[:, W - 1]
    d = W // 2
    while d >= 1:
        sums = sums + sums[:, :, lane ^ d]
        wmax = np.maximum(wmax, wmax[:, lane ^ d])
        d //= 2
    out = {"rgb": c["rgb"] + np.stack([sums[k][:, 0] for k in range(3)], -1),
           "depth": c["depth"] + sums[3][:, 0],
           "acc": c["acc"] + sums[4][:, 0], "trans": c["trans"] * T}
    if fog:
        out["wmax"] = np.maximum(c["wmax"], wmax[:, 0])
        out["wlogw"] = c["wlogw"] + sums[5][:, 0]
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lane_walk_matches_plain(case):
    """The kernel's lane algorithm at its plan against the plain
    version."""
    args = _inputs(case, CASES.index(case) + 100)
    want = TV.composite_segment_plain(*args)
    got = _lane_walk(*args)
    assert all(np.isfinite(v).all() for v in got.values())
    assert _err(got, {k: v.numpy() for k, v in want.items()}) <= WALK_TOL


def test_lane_walk_keeps_a_tiny_carry():
    """T_carry = 1e-30 scales every weight and the new transmittance
    without flushing them (relative 1e-5 where the outputs are ~1e-30)."""
    carry, rgb, sigma, t, dt = _inputs(("", "tc_tiny", N, 24, True,
                                        "slice"), 7)
    for k in ("rgb", "depth", "acc", "wlogw"):
        carry[k] = torch.zeros_like(carry[k])
    got = _lane_walk(carry, rgb, sigma, t, dt)
    want = TV.composite_segment_plain(carry, rgb, sigma, t, dt)
    for k in ("acc", "trans", "depth"):
        w = want[k].numpy()
        assert (w > 0).all() and np.abs(got[k] - w).max() <= 1e-5 * w.max()


# ---------------------------------------------------------------------------
# launch plans


@pytest.mark.parametrize("n,s", [(0, 8), (1, 1), (77, 1), (77, 2), (77, 3),
                                 (300, 8), (77, 24), (65, 31), (77, 33),
                                 (33, 64), (4096, 24), (65_536, 8),
                                 (16_384, 24)])
def test_plan_visits_every_sample_once(n, s):
    """Blocks, warps, lanes and pieces cover each (ray, sample) once in one
    pass, and each ray's output q once, by its segment's lane q mod lanes,
    fog or not."""
    plan = TV.ray_lane_plan(n, s, 1)
    W, warps = plan.lanes, plan.threads // 32
    assert plan.groups == 1 and W == TV.ray_lanes(s)
    assert plan.blocks * warps * plan.rays_per_warp >= max(n, 1)
    gw = np.arange(plan.blocks * warps)[:, None]
    lane = np.arange(32)[None, :]
    ray = gw * plan.rays_per_warp + lane // W
    sl = lane % W + 0 * ray
    live = ray < n
    seen = np.zeros((n, s), np.int64)
    for p in range(plan.pieces):
        on = live & (p * W + sl < s)
        np.add.at(seen, (ray[on], (p * W + sl)[on]), 1)
    assert (seen == 1).all()
    for nout in (6, 8):
        writes = np.zeros((n, nout), np.int64)
        for q in range(nout):
            at = live & (sl == q % W)
            np.add.at(writes, (ray[at], q), 1)
        assert (writes == 1).all()


def test_plans_take_short_segments_and_kernel_4_still_refuses_them():
    """Row 8 plans s = 1 and 2 (a ray on 1 and 2 lanes); kernel 4's plan
    keeps refusing S < 2; the struct is cached per shape."""
    assert (TV.ray_lane_plan(10, 1, 1).lanes,
            TV.ray_lane_plan(10, 2, 1).lanes) == (1, 2)
    assert TV.ray_lane_struct(10, 2, 1) is TV.ray_lane_struct(10, 2, 1)
    for backward in (False, True):
        with pytest.raises(ValueError, match="S >= 2"):
            TV.volrend_plan(10, 1, backward=backward)


def test_wrapper_takes_an_empty_segment_and_refuses_grad_inputs():
    """N = 0 gives an empty carry; an input that requires grad raises
    under grad mode (no backward)."""
    carry, rgb, sigma, t, dt = cs.composite_edge_inputs(
        "rand", 0, 8, True, "slice", 0, CPU)
    out = TV.composite_segment(carry, rgb, sigma, t, dt)
    assert set(out) == set(carry) and all(v.shape[0] == 0
                                          for v in out.values())
    carry, rgb, sigma, t, dt = _inputs(CASES[2], 1)
    with pytest.raises(RuntimeError, match="no backward"):
        TV.composite_segment(carry, rgb.requires_grad_(True), sigma, t, dt)
