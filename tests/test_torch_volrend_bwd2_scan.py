"""Kernel 4'' (csrc/volrend_bwd2.cu): its scans, walked in plain PyTorch
float32 in the kernel's association order, on its plan (kernel 4''s
`volrend_plan`).

The kernel runs only on the card (chip_smoke's `edge volume_render_bwd2`
lines); here `lane_bwd2` computes what its lanes compute: one sample a
lane, the forward pair (T, T') as (d, c) in one Kogge-Stone scan over the
lanes, then Q and P as two suffix scans of affine maps (Q's first: P's
map takes Q_{s+1}); pieces with (T, T') kept on the way in and (P, Q)
carried on the way out; one tree for the six per-ray sums. It is held to
`volume_render_bwd2_plain` within 1e-5 of each output's max (d acc and d
bg over the scale of acc' = sum w', which cancels to rounding noise on
opaque rays: chip_smoke's `bwd2_errs`) on chip_smoke's edge inputs (alpha
at its clip, sigma exactly 0, dt at its floor) and random ones, S = 2 to
97, sigma_scale 1 and 25, each upstream alone and all four. No JAX: the
plain version is held to JAX in tests/test_torch_maml_ops.py.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerfsys_tpu_torch.ops import volrend as TV

N = 12  # rays a case
TOL = 1e-5  # of each output's max: the scans' tree order (the card's)
F32 = torch.float32
HI = torch.tensor(1.0, dtype=F32) - torch.tensor(1e-7, dtype=F32)


def _clip_grad(x, lo, hi):
    """d clip(x, lo, hi) / dx under the tie rule, as the kernel's
    `clip_grad` (hi None: `max_grad`)."""
    dmax = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    if hi is None:
        return dmax.to(F32)
    m = torch.maximum(x, torch.tensor(lo, dtype=F32))
    return (dmax * torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))
            ).to(F32)


def _shift(x, k, up):
    """Lane l reads lane l - k (up) or l + k of its segment; past the edge
    its own value, as `__shfl_up/down_sync` with a width."""
    out = x.clone()
    if up:
        out[:, k:] = x[:, :-k]
    else:
        out[:, :-k] = x[:, k:]
    return out


def lane_bwd2(rs, t, bg, grads, v_rs, v_bg, scale, lanes, pieces=1):
    """Kernel 4'' at `lanes` lanes a ray and `pieces` pieces as its lanes
    compute it, float32 torch over (rays, lanes) -> what
    `volume_render_bwd2_plain` returns."""
    n, S = t.shape
    W, P = lanes, pieces
    lane = torch.arange(W)
    z3 = torch.zeros((n, 3), dtype=F32)
    G = grads[0] if grads[0] is not None else z3
    gd = grads[1] if grads[1] is not None else torch.zeros(n, dtype=F32)
    ga = grads[3] if grads[3] is not None else torch.zeros(n, dtype=F32)
    b = bg if bg is not None else z3
    vb = v_bg if bg is not None and v_bg is not None else z3
    gvb = G[:, 0] * vb[:, 0] + G[:, 1] * vb[:, 1] + G[:, 2] * vb[:, 2]
    zero, one = torch.tensor(0.0), torch.tensor(1.0)

    def load(p):
        """The kernel's `load_sample` and `sample_tangent` at sample p W +
        sl of every lane; g and h of the reverse map."""
        s = p * W + lane
        on = (s < S)[None, :].expand(n, W)
        sc = s.clamp(max=S - 1)
        v = torch.where(on[..., None], rs[:, sc], zero)
        vv = torch.where(on[..., None], v_rs[:, sc], zero)
        tt = torch.where(on, t[:, sc], zero)
        nxt = torch.where(sc < S - 1, t[:, (sc + 1).clamp(max=S - 1)] - tt,
                          tt - t[:, (sc - 1).clamp(min=0)])
        dt = torch.where(on, torch.clamp(nxt, min=1e-4), zero)
        sigma = torch.clamp(v[..., 3], min=0.0)
        if scale != 1.0:
            sigma = sigma * scale
        e = torch.where(on, torch.exp(-sigma * dt), zero)
        alpha = torch.where(on, torch.clamp(1.0 - e, min=0.0).minimum(HI),
                            zero)
        m = torch.where(on, 1.0 - alpha + 1e-10, one)
        ap = torch.where(on, _clip_grad(1.0 - e, 0.0, HI) * e * dt, zero)
        sd = torch.where(on, _clip_grad(v[..., 3], 0.0, None) * vv[..., 3],
                         zero)
        if scale != 1.0:
            sd = sd * scale
        ad = ap * sd
        cg = torch.stack([_clip_grad(v[..., c], 0.0, 1.0) for c in range(3)],
                         -1)
        r = v[..., :3].clamp(0.0, 1.0)
        g = ((G[:, None, 0] * (r[..., 0] - b[:, None, 0])
              + G[:, None, 1] * (r[..., 1] - b[:, None, 1])
              + G[:, None, 2] * (r[..., 2] - b[:, None, 2]))
             + gd[:, None] * tt + ga[:, None])
        if grads[2] is not None:
            g = g + grads[2][:, sc]
        cv = cg * vv[..., :3]
        h = (G[:, None, 0] * cv[..., 0] + G[:, None, 1] * cv[..., 1]
             + G[:, None, 2] * cv[..., 2]) - gvb[:, None]
        return dict(s=s, on=on, v=v, vv=vv, t=tt, dt=dt, alpha=alpha, m=m,
                    ap=ap, ad=ad, cg=cg, r=r, g=torch.where(on, g, zero),
                    h=torch.where(on, h, zero))

    def fwd_scan(q):  # the (d, c) of each lane's sample, scanned
        d, c = q["m"], -q["ad"]
        k = 1
        while k < W:
            d2, c2, on = _shift(d, k, True), _shift(c, k, True), lane >= k
            c, d = torch.where(on, d2 * c + c2 * d, c), torch.where(
                on, d2 * d, d)
            k *= 2
        return d, c

    starts = []  # pass 1: (T, T') at each piece's start
    T, Td = torch.ones(n), torch.zeros(n)
    if P > 1:
        for p in range(P):
            d, c = fwd_scan(load(p))
            starts.append((T, Td))
            D, C = d[:, W - 1], c[:, W - 1]
            Td = C * T + D * Td
            T = D * T
    d_rs = torch.zeros((n, S, 4))
    d_w = torch.zeros((n, S))
    Pc, Qc = torch.zeros(n), torch.zeros(n)
    acc, accd, dd = (torch.zeros((n, W)) for _ in range(3))
    rd = torch.zeros((n, W, 3))

    def suffix(mm, bb):  # the shipped kernel's `seg_suffix`
        k = 1
        while k < W:
            m2, b2 = _shift(mm, k, False), _shift(bb, k, False)
            on = lane + k < W
            bb, mm = torch.where(on, bb + mm * b2, bb), torch.where(
                on, mm * m2, mm)
            k *= 2
        return mm, bb

    for p in range(P - 1, -1, -1):
        q = load(p)
        d, c = fwd_scan(q)
        first, last = lane == 0, lane == W - 1
        ed = torch.where(first, one, _shift(d, 1, True))
        ec = torch.where(first, zero, _shift(c, 1, True))
        T0, Td0 = starts[p] if P > 1 else (torch.ones(n), torch.zeros(n))
        T = ed * T0[:, None]
        Td = ec * T0[:, None] + ed * Td0[:, None]
        # Q's scan, then P's, which takes Q_{s+1}
        qm, qb = suffix(q["m"], q["g"] * q["alpha"])
        Qn = (torch.where(last, zero, _shift(qb, 1, False))
              + torch.where(last, one, _shift(qm, 1, False)) * Qc[:, None])
        gq = q["g"] - Qn
        pm, pb = suffix(q["m"], q["ad"] * gq + q["h"] * q["alpha"])
        Pn = (torch.where(last, zero, _shift(pb, 1, False))
              + torch.where(last, one, _shift(pm, 1, False)) * Pc[:, None])
        # the carries: lane 0's inclusive map applied to the old ones
        Pc, Qc = pb[:, 0] + pm[:, 0] * Pc, qb[:, 0] + qm[:, 0] * Qc
        w = q["alpha"] * T
        wd = q["ad"] * T + q["alpha"] * Td
        acc, accd, dd = acc + w, accd + wd, dd + wd * q["t"]
        rd = rd + (wd[..., None] * q["r"] + w[..., None] * (
            q["cg"] * q["vv"][..., :3]))
        d_sigma = (q["ap"] * (Td * gq + T * (q["h"] - Pn))
                   - q["dt"] * q["ad"] * T * gq)
        if scale != 1.0:
            d_sigma = d_sigma * scale
        out = torch.stack(
            [wd * G[:, None, c] * q["cg"][..., c] for c in range(3)]
            + [d_sigma * _clip_grad(q["v"][..., 3], 0.0, None)], -1)
        on = q["on"][0]
        d_rs[:, q["s"][on]] = out[:, on]
        d_w[:, q["s"][on]] = wd[:, on]

    def seg_sum(x):
        k = W // 2
        while k >= 1:
            x = x + x[:, lane ^ k]
            k //= 2
        return x[:, 0]

    acc, accd, dd = seg_sum(acc), seg_sum(accd), seg_sum(dd)
    rd = torch.stack([seg_sum(rd[..., c]) for c in range(3)], -1)
    d_rgb = rd - accd[:, None] * b + (1.0 - acc)[:, None] * vb
    d_u = [d_rgb, dd, d_w, accd]
    return (d_rs, None if bg is None else -G * accd[:, None],
            tuple(None if g is None else x for g, x in zip(grads, d_u)))


ALL4 = (True, True, True, True)


def _case(kind, s, used, with_bg, seed):
    rs, t, bg, *ups = cs.volrend_edge_inputs(kind, N, s, "cpu", seed)
    rng = np.random.default_rng(seed + 7)
    v_rs = torch.from_numpy(rng.normal(size=(N, s, 4)).astype(np.float32))
    v_bg = (torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
            if with_bg else None)
    return (rs, t, bg if with_bg else None,
            tuple(u if on else None for u, on in zip(ups, used)), v_rs, v_bg)


SHIPPED = ([("rand", s, ALL4, True, 1.0) for s in (2, 8, 24, 32, 48, 64, 97)]
           + [(k, s, ALL4, True, sc) for k in ("clip", "zero", "dtfloor")
              for s in (24, 32, 64) for sc in (1.0, 25.0)]
           + [("rand", s, tuple(i == u for i in range(4)), True, 1.0)
              for u in range(4) for s in (32, 64)]
           + [("rand", 32, ALL4, False, 1.0), ("zero", 8, ALL4, False, 25.0),
              ("clip", 97, ALL4, True, 25.0)])
SHIPPED_IDS = [f"{k}-S{s}-{''.join('1' if u else '0' for u in used)}"
               f"{'' if bg else '-nobg'}-x{sc:g}"
               for k, s, used, bg, sc in SHIPPED]


@pytest.mark.parametrize("kind,s,used,with_bg,scale", SHIPPED,
                         ids=SHIPPED_IDS)
def test_shipped_scans_match_plain(kind, s, used, with_bg, scale):
    """The shipped kernel on its plan (kernel 4''s `volrend_plan`): one
    sample a lane, the forward pair fused, Q and P in turn."""
    rs, t, bg, grads, v_rs, v_bg = _case(kind, s, used, with_bg, s)
    plan = TV.volrend_plan(N, s, backward=True)
    want = TV.volume_render_bwd2_plain(rs, t, bg, grads, v_rs, v_bg,
                                       sigma_scale=scale)
    got = lane_bwd2(rs, t, bg, grads, v_rs, v_bg, scale, plan.lanes,
                    plan.pieces)
    assert torch.isfinite(got[0]).all()
    assert float(want[0].abs().max()) > 0
    errs = cs.bwd2_errs(got, want, grads, cs.wdot_scale(rs, t, v_rs, scale))
    assert all(e <= TOL for _, e in errs), errs


def test_cases_reach_pieces_and_lane_counts():
    """The cases above walk 2, 8 and 32 lanes a ray and up to 4 pieces (a
    start carried past a piece that did not begin at (1, 0))."""
    shipped = [TV.volrend_plan(N, s, backward=True) for _, s, *_ in SHIPPED]
    assert max(p.pieces for p in shipped) == 4
    assert {p.lanes for p in shipped} == {2, 8, 32}


# ------------------------------- the plans -----------------------------------
def _walk(plan, n, s):
    """How often the kernel's warps, lanes and pieces visit each (ray,
    sample)."""
    W = plan.lanes
    warps = plan.threads // 32
    count = np.zeros((n, s), np.int64)
    gw = np.arange(plan.blocks * warps)[:, None]  # global warp
    lane = np.arange(32)[None, :]
    ray = (gw * (32 // W) + lane // W).ravel()
    sl = np.broadcast_to(lane % W, (gw.shape[0], 32)).ravel()
    for p in range(plan.pieces):
        smp = p * W + sl
        ok = (ray < n) & (smp < s)
        np.add.at(count, (ray[ok], smp[ok]), 1)
    return count


@pytest.mark.parametrize("n", [1, 33, 4000])
@pytest.mark.parametrize("s", [2, 3, 8, 24, 32, 33, 48, 64, 97, 160])
def test_shipped_plan_visits_every_sample_once(n, s):
    """The shipped kernel takes kernel 4''s plan; its entry point checks
    that plan's two floats of piece starts a piece and warp (twice 4''s
    one) against 96 KB."""
    plan = TV.volrend_plan(n, s, backward=True)
    assert (_walk(plan, n, s) == 1).all()
    warps = plan.threads // 32
    assert plan.smem == (4 * warps * plan.pieces if plan.pieces > 1 else 0)
    assert 2 * plan.smem <= 96 * 1024
    assert (plan.lanes == 32) or plan.pieces == 1
