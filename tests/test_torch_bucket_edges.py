"""Adversarial inputs of the bucket dispatch (kernel 10a-i, its module
`nerfsys_tpu_torch.models.container`) against the reference, the kernel's
single-pass algorithm walked in numpy, and its launch plans; the same for
the blend's transpose (10a-iii).

Inputs come from chip_smoke.py's `dispatch_edge_inputs` and
`dispatch_edge_cases`, the ones the kernel is held to on the card (numpy
seeds), at fewer points: every point on one expert (demand > C, the trash
slot), points equidistant from two centroids (ties), points at the soft
weights' margin and one float step before it, hard routing with E - 1
zero-weight pairs a point, N off whole tiles and below one tile, both
routing subspaces, K in {1, 4, 16, 64}.
The reference side runs nerfsys_tpu.models.container `_bucketed_eval`
eagerly with its experts replaced by a probe that keeps the (K, C) rows
the reference gathers for them, and the reference's routing and counting
sort (:307-333: `_routing_dist`, `lax.top_k`, the margin weights, the
one-hot exclusive cumsum) for idx, w, dest and counts.
Tolerances: integer outputs and gathered rows exactly; w within 1e-6
against the reference (its routing distance is a matrix product, the
port's an elementwise sum in the same order), exactly for the walk.

10a-iii's cases are chip_smoke.py's `combine_edge_cases` (E=1 and 8, hard
routing, an empty bucket, an overflowing one, N off whole tiles, below
one tile and a single point, no rgb, K=64) on dispatches of the same
inputs: BucketCombine's backward (the saved counts beside w and dest)
equals `jax.vjp` of the reference's reshape-sum blend exactly (one
product a slot), and the kernel's tiles, staged runs and tail fill walked
in numpy equal the plain version exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerfsys_tpu.models import container as JCo
from nerfsys_tpu_torch.models import container as TCo

W_TOL = 1e-6

CASES = cs.dispatch_edge_cases()
IDS = [c[0].replace(" ", "_").replace(",", "") for c in CASES]


def _n(case):
    """The case's N if it is a small one, else two whole tiles of its E
    and a tail."""
    n = case[2]
    return (n if n < cs.CHECK_RAYS * 32 // 8
            else 2 * TCo.dispatch_tile(case[4]) + 188)


def _inputs(case, seed):
    _, kind, _, k, e, margin, c2d, with_dirs = case
    pts, dirs, cents = cs.dispatch_edge_inputs(
        kind, _n(case), k, with_dirs, c2d, margin, seed, torch.device("cpu"))
    C = TCo.bucket_capacity(pts.shape[0], k, e, cs.MOE_CF)
    return (pts, dirs, cents, c2d, margin, e, C)


def _reference(args, monkeypatch):
    """The reference's intermediates: idx, w, dest, counts by its own
    formulas, and the rows its `_bucketed_eval` gathers for the experts."""
    pts, dirs, cents, c2d, margin, E, C = args
    K = cents.shape[0]
    x = jnp.asarray(pts.numpy())
    d = None if dirs is None else jnp.asarray(dirs.numpy())
    cfg = JCo.ContainerConfig(num_experts=K, cluster_2d=c2d,
                              boundary_margin=margin, bucketed=True,
                              experts_per_point=E, capacity_factor=cs.MOE_CF,
                              bucket_overflow_dense=False)
    st = JCo.ContainerStatics(jnp.asarray(cents.numpy()),
                              jnp.zeros((K, 2, 3)), jnp.zeros((2, 3)))
    seen = []

    def apply(p, ecfg, box, xs, ds):
        seen.append(np.concatenate([np.asarray(xs), np.asarray(ds)], 1))
        return jnp.zeros((xs.shape[0], 3)), jnp.zeros(xs.shape[0])

    def density(p, ecfg, box, xs):
        seen.append(np.asarray(xs))
        return jnp.zeros(xs.shape[0])

    monkeypatch.setattr(JCo, "_expert_apply_fn", lambda c: (apply, density))
    with jax.disable_jit():
        JCo._bucketed_eval({"experts": jnp.zeros((K, 1))}, cfg, st, x, d)
        dist = JCo._routing_dist(st, cfg, x)
        neg_d, idx = jax.lax.top_k(-dist, E)
        dsel = -neg_d
        if margin > 1.0:
            dsel = jnp.maximum(dsel, 1e-6)
            invd = (1.0 / dsel) * (dsel <= margin * dsel[:, :1])
            w = invd / jnp.maximum(jnp.sum(invd, axis=1, keepdims=True),
                                   1e-6)
        else:
            w = jnp.zeros(dsel.shape).at[:, 0].set(1.0)
        k_flat, w_flat = idx.reshape(-1), w.reshape(-1)
        onehot = jax.nn.one_hot(k_flat, K, dtype=jnp.int32)
        onehot = onehot * (w_flat > 0).astype(jnp.int32)[:, None]
        rank = jnp.cumsum(onehot, axis=0) - onehot
        slot = jnp.sum(rank * onehot, axis=1)
        keep = (slot < C) & (w_flat > 0)
        dest = jnp.where(keep, k_flat * C + slot, K * C)
    return {"idx": np.asarray(idx), "w": np.asarray(w),
            "dest": np.asarray(dest), "counts": np.asarray(onehot.sum(0)),
            "rows": np.stack(seen)}


REF_CASES = [c for c in CASES if c[1] in ("one", "ties")]


@pytest.mark.parametrize("case", REF_CASES,
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[1] in ("one", "ties")])
def test_plain_dispatch_matches_reference_on_ties_and_overflow(
        case, monkeypatch):
    args = _inputs(case, seed=3)
    want = _reference(args, monkeypatch)
    for fn in (TCo.bucket_dispatch_plain, TCo.bucket_dispatch_kernel):
        got = fn(*args)
        for key in ("idx", "dest", "counts", "rows"):
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=0,
                                   atol=W_TOL)
    if case[1] == "one":
        assert int(got["counts"].max()) > args[-1]  # the trash slot is used
        assert int((got["dest"] == args[-1] * args[2].shape[0]).sum()) > 0


def test_edge_inputs_hit_their_cases():
    """Ties are bit-equal distances kept lower expert first; the margin
    points straddle the soft weights' test; one expert's demand exceeds C;
    hard routing leaves E - 1 zero-weight pairs a point."""
    by_kind = {c[1]: c for c in CASES}
    pts, dirs, cents, c2d, margin, E, C = _inputs(by_kind["ties"], 0)
    dist = TCo._centroid_dist(cents, c2d, pts)
    ties = (dist[:, 0] == dist[:, 1]).sum()
    assert ties >= pts.shape[0] // 2
    got = TCo.bucket_dispatch_plain(pts, dirs, cents, c2d, margin, E, C)
    tied = dist[:, 0] == dist[:, 1]
    first = got["idx"][tied]
    assert not ((first[:, 0] == 1) & (first[:, 1] == 0)).any()
    args = _inputs(by_kind["margin"], 0)
    got = TCo.bucket_dispatch_plain(*args)
    inside = (got["w"][:, 1] > 0).numpy()
    assert 0.3 < inside[0::2].mean() and inside[1::2].mean() < 0.7
    assert inside[0::2].mean() > inside[1::2].mean() + 0.3
    args = _inputs(CASES[0], 0)
    got = TCo.bucket_dispatch_plain(*args)
    assert int(got["counts"][0]) == args[0].shape[0] > args[-1]
    hard = [c for c in CASES if c[5] == 1.0][0]
    got = TCo.bucket_dispatch_plain(*_inputs(hard, 0))
    assert ((got["w"] > 0).sum(1) == 1).all() and hard[4] == 4


def _popc(x):
    return bin(int(x)).count("1")


def _tile_walk(idx, w, pts, dirs, K, C, rng, resident):
    """Kernel 10a-i's single pass in numpy: per tile of `dispatch_tile(E)`
    points (8 warps, warp v
    taking the tile's points [v, v + 1) x tile / 8 in rounds of 32), one
    bitmask a round and expert gives each kept pair's rank in the round,
    the warp's running count an expert its rank in the warp, and the
    earlier warps' totals its rank in the tile; the tiles publish their
    status words one expert at a time and look back in a random
    interleaving, at most `resident` at once (a new tile's ticket follows
    the last one drawn), each expert reading a window of 32 tiles' words a
    step; then the runs of rows staged by (expert, rank) and streamed out,
    and the empty slots filled. Returns the outputs and how many windows
    were read again or slid."""
    N, E = idx.shape
    tile = TCo.dispatch_tile(E)
    tiles = -(-N // tile)
    live = w > 0
    agg = np.zeros((tiles, K), np.int64)
    trank = np.zeros((N, E), np.int64)
    per_warp = tile // 8
    for t in range(tiles):
        run = np.zeros(K, np.int64)  # earlier warps' kept pairs
        for v in range(8):
            wrun = np.zeros(K, np.int64)
            for r0 in range(t * tile + v * per_warp,
                            t * tile + (v + 1) * per_warp, 32):
                lanes = range(r0, min(r0 + 32, N))
                mask = np.zeros(K, np.int64)
                for n in lanes:
                    for e in range(E):
                        if live[n, e]:
                            mask[idx[n, e]] |= 1 << (n - r0)
                for n in lanes:
                    lower = (1 << (n - r0)) - 1
                    for e in range(E):
                        if live[n, e]:
                            k = idx[n, e]
                            trank[n, e] = (run[k] + wrun[k] +
                                           _popc(mask[k] & lower))
                wrun += [_popc(m) for m in mask]
            run += wrun
        agg[t] = run
    # status[t, k]: (flag, count); flag 0 nothing, 1 aggregate, 2 inclusive
    flag = np.zeros((tiles, K), np.int64)
    value = np.zeros((tiles, K), np.int64)
    goff = np.zeros((tiles, K), np.int64)
    state = {}  # tile -> [experts published, per-expert window tops, sums]
    nxt, stats = 0, {"polls_again": 0, "slides": 0}
    while nxt < tiles or state:
        while nxt < tiles and len(state) < resident:
            state[nxt] = [0, np.full(K, nxt - 1), np.zeros(K, np.int64)]
            nxt += 1
        t = int(rng.choice(sorted(state)))
        st = state[t]
        if st[0] < K:  # publish one expert's word
            k = st[0]
            flag[t, k], value[t, k] = (2, agg[0, k]) if t == 0 else (
                1, agg[t, k])
            st[0] += 1
            if t == 0 and st[0] == K:
                del state[t]
            continue
        k = int(rng.choice(np.nonzero(st[1] >= -1)[0]))  # one expert steps
        j = st[1][k] - np.arange(32)
        f = np.where(j >= 0, flag[np.maximum(j, 0), k], 2)
        p_lanes = np.nonzero(f == 2)[0]
        lim = p_lanes[0] if len(p_lanes) else 31
        if (f[:lim + 1] == 0).any():
            stats["polls_again"] += 1
            continue
        st[2][k] += sum(value[j[i], k] for i in range(lim + 1) if j[i] >= 0)
        if len(p_lanes):
            st[1][k] = -2  # done
        else:
            st[1][k] -= 32
            stats["slides"] += 1
        if (st[1] == -2).all():
            goff[t] = st[2]
            for k in range(K):  # the inclusive words
                flag[t, k], value[t, k] = 2, st[2][k] + agg[t, k]
            del state[t]
    counts = value[-1] if tiles > 1 else agg[0]
    np.testing.assert_array_equal(goff, np.cumsum(agg, 0) - agg)
    dest = np.full((N, E), K * C, np.int64)
    brows = np.full((K, C), -1, np.int64)
    width = 3 if dirs is None else 6
    src = pts if dirs is None else np.concatenate([pts, dirs], 1)
    rows = np.full((K, C, width), np.nan, np.float32)
    for t in range(tiles):
        lbase = np.concatenate([[0], np.cumsum(agg[t])])
        staged = np.full(lbase[-1], -1, np.int64)
        keyed = np.full(lbase[-1], -1, np.int64)
        for n in range(t * tile, min((t + 1) * tile, N)):
            for e in range(E):
                if live[n, e]:
                    k = idx[n, e]
                    p = lbase[k] + trank[n, e]
                    staged[p], keyed[p] = n, k
                    r = goff[t, k] + trank[n, e]
                    if r < C:
                        dest[n, e] = k * C + r
        assert (staged >= 0).all()  # every staged slot filled once
        for p in range(lbase[-1]):
            k = keyed[p]
            slot = goff[t, k] + p - lbase[k]
            if slot < C:
                brows[k, slot] = staged[p]
                rows[k, slot] = src[staged[p]]
    for k in range(K):
        brows[k, min(counts[k], C):] = 0
        rows[k, min(counts[k], C):] = src[0]
    return {"dest": dest.reshape(-1), "counts": counts, "bucket_rows": brows,
            "rows": rows}, stats


@pytest.mark.parametrize("resident", [1, 5, 48])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tile_walk_matches_plain(case, resident):
    """Ranks, offsets, runs and fill of the walk equal the plain version's
    counting sort whatever order the tiles publish in."""
    args = _inputs(case, seed=4)
    pts, dirs, cents, c2d, margin, E, C = args
    want = TCo.bucket_dispatch_plain(*args)
    got, _ = _tile_walk(want["idx"].numpy(), want["w"].numpy(), pts.numpy(),
                        None if dirs is None else dirs.numpy(),
                        cents.shape[0], C, np.random.default_rng(resident),
                        resident)
    for key in ("dest", "counts", "bucket_rows", "rows"):
        np.testing.assert_array_equal(got[key], want[key].numpy())


def test_look_back_reads_again_and_slides():
    """With many tiles resident and their flags published in a random
    order, the look-back meets unpublished tiles and windows of 32
    aggregates, and still gives the plain version's offsets (E=3: tiles
    of 256 points)."""
    n = TCo.dispatch_tile(3) * 90 + 5
    pts, dirs, cents = cs.dispatch_edge_inputs("rand", n, 4, True, True,
                                               1.1, 9, torch.device("cpu"))
    C = TCo.bucket_capacity(n, 4, 3, cs.MOE_CF)
    want = TCo.bucket_dispatch_plain(pts, dirs, cents, True, 1.1, 3, C)
    got, stats = _tile_walk(want["idx"].numpy(), want["w"].numpy(),
                            pts.numpy(), dirs.numpy(), 4, C,
                            np.random.default_rng(0), 80)
    assert stats["polls_again"] > 0 and stats["slides"] > 0
    for key in ("dest", "counts", "bucket_rows", "rows"):
        np.testing.assert_array_equal(got[key], want[key].numpy())


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2_097_152])
@pytest.mark.parametrize("k,e", [(1, 1), (4, 1), (4, 2), (4, 4), (16, 2),
                                 (16, 8), (64, 2), (64, 8)])
def test_dispatch_plan(n, k, e):
    """One block a tile of 2,048 points for E <= 2 and 256 above; the
    scratch holds the ticket and a status word a (tile, expert), all of it
    cleared before the pass."""
    plan = TCo.dispatch_plan(n, k, e, 128, 132)
    assert plan.tile == (2048 if e <= 2 else 256) == TCo.dispatch_tile(e)
    assert plan.tiles * plan.tile >= n > (plan.tiles - 1) * plan.tile
    assert plan.scratch == 1 + plan.tiles * k
    assert plan.fill_blocks * k >= 4 * 132 and plan.fill_threads % 32 == 0
    st = plan.as_struct()
    assert (st.tile, st.tiles, st.fill_blocks) == (
        plan.tile, plan.tiles, plan.fill_blocks)
    assert TCo._dispatch_plan(n, k, e, 128, 132) is TCo._dispatch_plan(
        n, k, e, 128, 132)


@pytest.mark.parametrize("bad", [dict(k=65), dict(e=9, k=16), dict(e=5, k=4),
                                 dict(c=100), dict(n=0), dict(e=0),
                                 dict(k=0), dict(n=2 ** 30)])
def test_dispatch_plan_limits(bad):
    kw = dict(n=1000, k=4, e=1, c=128, sms=132)
    kw.update(bad)
    with pytest.raises(ValueError):
        TCo.dispatch_plan(**kw)


def test_bucketed_container_config_unchanged():
    """The port's config keeps the reference's bucketed fields."""
    fields = {f.name for f in dataclasses.fields(TCo.ContainerConfig)}
    assert {"bucketed", "experts_per_point", "capacity_factor",
            "bucket_overflow_dense"} <= fields


COMBINE_CASES = cs.combine_edge_cases()
COMBINE_IDS = [c[0].replace(" ", "_").replace(",", "") for c in
               COMBINE_CASES]


def _combine_inputs(case, seed):
    _, kind, n, k, e, margin, rgb = case
    tile = TCo.combine_bwd_plan(1, k, e, 128, 132).tile
    n = n if n < cs.CHECK_RAYS * 32 // 8 else 2 * tile + 188
    return cs.combine_edge_inputs(kind, n, k, e, margin, rgb, seed,
                                  torch.device("cpu"))


def _combine_walk(w, dest, counts, g_s, g_r, n_slots, sms=132):
    """Kernel 10a-iii in numpy: the fill blocks zero each bucket's tail
    [min(counts, C), C) in grid-stride order; each tile of the plan's
    points finds each expert's run (its least slot and its count, the
    shared atomics), scans the counts, stages one product a kept slot by
    (expert, slot), and a warp an expert writes the run as a scalar head
    to the first 16-byte boundary, 16-byte stores and a scalar tail.
    Every output float must be written exactly once."""
    N, E = w.shape
    K = counts.shape[0]
    C = n_slots // K
    plan = TCo.combine_bwd_plan(N, K, E, C, sms)
    sig = np.full(n_slots, np.nan, np.float32)
    rgb = None if g_r is None else np.full(n_slots * 3, np.nan, np.float32)
    writes = np.zeros(n_slots, np.int64)
    rgb_writes = np.zeros(n_slots * 3, np.int64)

    def store(dst, hits, f0, vals):
        assert np.isnan(dst[f0:f0 + len(vals)]).all()
        dst[f0:f0 + len(vals)] = vals
        hits[f0:f0 + len(vals)] += 1

    step = plan.fill_blocks * 256
    for k in range(K):
        s0 = min(int(counts[k]), C)
        for j in range(plan.fill_blocks):
            for g in range(j * 256, (j + 1) * 256):
                for f in range(s0 + g, C, step):
                    store(sig, writes, k * C + f, [0.0])
                if rgb is not None:
                    a, b = 3 * s0, 3 * C
                    a4 = min((a + 3) & ~3, b)
                    for f in range(a + g, a4, step):
                        store(rgb, rgb_writes, 3 * k * C + f, [0.0])
                    for q in range(a4 // 4 + g, b // 4, step):
                        store(rgb, rgb_writes, 3 * k * C + 4 * q, [0.0] * 4)
    d_all = dest.reshape(N, E)
    for t in range(plan.tiles):
        lo, hi = t * plan.tile, min((t + 1) * plan.tile, N)
        d, wt = d_all[lo:hi], w[lo:hi]
        kept = d < n_slots
        ks = d // C
        start = np.full(K, 2 ** 31 - 1, np.int64)
        cnt = np.zeros(K, np.int64)
        for kk, dd in zip(ks[kept], d[kept]):
            start[kk] = min(start[kk], dd)
            cnt[kk] += 1
        off = np.cumsum(cnt) - cnt
        total = int(cnt.sum())
        assert total <= 2048  # the shared staging
        s_sig = np.full(total, np.nan, np.float32)
        s_rgb = np.full(total * 3, np.nan, np.float32)
        for i in range(hi - lo):
            for e in range(E):
                if not kept[i, e]:
                    continue
                kk, r = ks[i, e], d[i, e] - start[ks[i, e]]
                assert 0 <= r < cnt[kk]  # the run is contiguous
                pos = off[kk] + r
                assert np.isnan(s_sig[pos])
                s_sig[pos] = wt[i, e] * g_s[lo + i]
                if rgb is not None:
                    s_rgb[3 * pos:3 * pos + 3] = wt[i, e] * g_r[lo + i]
        for kk in range(K):
            if cnt[kk] == 0:
                continue
            runs = [(sig, writes, start[kk], s_sig[off[kk]:off[kk] +
                                                     cnt[kk]])]
            if rgb is not None:
                runs.append((rgb, rgb_writes, 3 * start[kk],
                             s_rgb[3 * off[kk]:3 * (off[kk] + cnt[kk])]))
            for dst, hits, f0, src in runs:
                n = len(src)
                head = min(n, (4 - (f0 & 3)) & 3)
                body = (n - head) // 4
                assert (f0 + head) % 4 == 0 or body == 0
                store(dst, hits, f0, src[:head])
                for q in range(body):
                    store(dst, hits, f0 + head + 4 * q,
                          src[head + 4 * q:head + 4 * q + 4])
                store(dst, hits, f0 + head + 4 * body,
                      src[head + 4 * body:])
    assert (writes == 1).all()
    assert rgb is None or (rgb_writes == 1).all()
    return sig, None if rgb is None else rgb.reshape(-1, 3)


def _jax_blend_vjp(w, dest, n_slots, g_s, g_r):
    """jax.vjp of the reference's reshape-sum blend (container.py:363-373)
    with respect to the bucket results."""
    N, E = w.shape
    keep = jnp.asarray(dest < n_slots)
    wk = jnp.where(keep, jnp.asarray(w.reshape(-1)), 0.0)
    d = jnp.asarray(dest.astype(np.int32))

    def blend(sb, rb):
        s_flat = jnp.concatenate([sb, jnp.zeros((1,), sb.dtype)])
        sigma = jnp.sum((wk * s_flat[d]).reshape(N, E), axis=1)
        if rb is None:
            return sigma
        r_flat = jnp.concatenate([rb, jnp.zeros((1, 3), rb.dtype)])
        return sigma, jnp.sum((wk[:, None] * r_flat[d]).reshape(N, E, 3),
                              axis=1)

    sb = jnp.zeros((n_slots,), jnp.float32)
    if g_r is None:
        _, vjp = jax.vjp(lambda s: blend(s, None), sb)
        return vjp(jnp.asarray(g_s))[0], None
    _, vjp = jax.vjp(blend, sb, jnp.zeros((n_slots, 3), jnp.float32))
    return vjp((jnp.asarray(g_s), jnp.asarray(g_r)))


@pytest.mark.parametrize("case", COMBINE_CASES, ids=COMBINE_IDS)
def test_combine_bwd_matches_reference_vjp(case):
    """BucketCombine's backward, with the dispatch's counts saved beside w
    and dest, against jax.vjp of the reference's blend: exactly."""
    w, dest, counts, g_s, g_r, n_slots = _combine_inputs(case, seed=5)
    sb = torch.zeros(n_slots, requires_grad=True)
    rb = (None if g_r is None
          else torch.zeros((n_slots, 3), requires_grad=True))
    out = TCo.BucketCombine.apply(w, dest, counts, sb, rb, True)
    if rb is None:
        got = torch.autograd.grad(out, sb, g_s)
        got = (got[0], None)
    else:
        got = torch.autograd.grad(out, (sb, rb), (g_s, g_r))
    with jax.disable_jit():
        want = _jax_blend_vjp(w.numpy(), dest.numpy(), n_slots, g_s.numpy(),
                              None if g_r is None else g_r.numpy())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if g_r is not None:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("case", COMBINE_CASES, ids=COMBINE_IDS)
def test_combine_walk_matches_plain(case, sms):
    """Every output float written once: the tails by the fill blocks, the
    kept slots by their tile's staged runs; equal to the plain version."""
    w, dest, counts, g_s, g_r, n_slots = _combine_inputs(case, seed=6)
    want = TCo.bucket_combine_bwd_plain(w, dest, g_s, g_r, n_slots)
    got = _combine_walk(w.numpy(), dest.numpy(), counts.numpy(),
                        g_s.numpy(), None if g_r is None else g_r.numpy(),
                        n_slots, sms)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    if g_r is not None:
        np.testing.assert_array_equal(got[1], want[1].numpy())


def test_combine_edge_inputs_hit_their_cases():
    """The empty bucket stays empty, the overflow's demand exceeds C, hard
    routing trashes every second pair, no rgb has no rgb gradient."""
    by_label = {c[0]: c for c in COMBINE_CASES}
    *_, counts, _, _, n_slots = _combine_inputs(by_label["an empty bucket"],
                                                0)
    assert int(counts[-1]) == 0 and int(counts[:-1].min()) > 0
    w, dest, counts, _, _, n_slots = _combine_inputs(
        by_label["overflow (bucket_overflow_dense=False)"], 0)
    assert int(counts.max()) > n_slots // counts.shape[0]
    assert int((dest == n_slots).sum()) > 0
    w, dest, *_ = _combine_inputs(
        [c for c in COMBINE_CASES if c[5] == 1.0][0], 0)
    assert (w[:, 1] == 0).all() and (dest.reshape(-1, 2)[:, 1] ==
                                     dest.max()).all()
    assert _combine_inputs(by_label["no rgb"], 0)[4] is None


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 2_097_152])
@pytest.mark.parametrize("k,e", [(1, 1), (4, 1), (4, 2), (4, 4), (16, 8),
                                 (64, 2)])
def test_combine_bwd_plan(n, k, e):
    """Tiles of 1,024 points for E <= 2 and 256 above, at most 2,048 pairs
    a tile; about 4 fill blocks an SM over the K buckets."""
    plan = TCo.combine_bwd_plan(n, k, e, 128, 132)
    assert plan.tile == (1024 if e <= 2 else 256)
    assert plan.tile * e <= 2048
    assert plan.tiles * plan.tile >= n > (plan.tiles - 1) * plan.tile or (
        n == 0 and plan.tiles == 0)
    assert plan.fill_blocks * k >= 4 * 132
    st = plan.as_struct()
    assert (st.tile, st.tiles, st.fill_blocks) == (plan.tile, plan.tiles,
                                                   plan.fill_blocks)


@pytest.mark.parametrize("bad", [dict(k=65), dict(e=9), dict(c=100),
                                 dict(e=0), dict(k=0), dict(n=-1)])
def test_combine_bwd_plan_limits(bad):
    kw = dict(n=1000, k=4, e=1, c=128, sms=132)
    kw.update(bad)
    with pytest.raises(ValueError):
        TCo.combine_bwd_plan(**kw)
