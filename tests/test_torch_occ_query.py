"""Port parity of the occupancy point query: `occupancy_query` (kernel
11q's wrapper, on CPU tensors its plain version) in each mode, and the
union / expert query functions of nerfsys_tpu_torch.models.occupancy that
route through it, against the JAX package's `union_binary_fn`,
`expert_binary_fn`, `union_value_fn`, `union_pair_fn` and
`expert_pair_fn`; then kernel 11q's cell selection walked in numpy.

Inputs come from chip_smoke.py's `query_edge_inputs` (numpy seeds), the
ones the kernel is held to on the card, at fewer points: points on level
faces (rel exactly 0 and exactly 1) and one ulp either side, points
outside every level, rel a few ulps below 1 (the last cell, R = 12,
24: rel < 1 exactly where x < b, so rel * R stays below R), invisible cells
tagged -1, random points, K = 1, 4, 5, M = 1 and 0; and points on the
cells' step points and one ulp either side (R = 128, 127), which the
numpy walk takes and the JAX side does not (no eager-JAX time). The JAX
side runs with jit disabled (jitted XLA on the CPU contracts the level
boxes' multiply-adds, which can move a face by an ulp). Bits and values
are equal bit for bit: the same float32 operations select the same
cells. The kernel's step rows (`cell_steps`) are held to the division
formula they replace, and its guess correction to the true cell however
far off the guess.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import occupancy as JMO
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.models import occupancy as TMO
from nerfsys_tpu_torch.ops import occupancy as T
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

M = 1024 + 13  # a tail past whole 256-point blocks
ALL_CASES = [(label, kind, min(m, M), k, l, r)
             for label, kind, m, k, l, r in cs.query_edge_cases()]
ALL_IDS = [c[0].replace(" ", "_") for c in ALL_CASES]
CASES = [c for c in ALL_CASES if c[1] != "steps"]  # the JAX side's
IDS = [c[0].replace(" ", "_") for c in CASES]
f32 = np.float32


def _inputs(case, seed=0):
    _, kind, m, k, l, r = case
    return cs.query_edge_inputs(kind, m, k, l, r, seed)


def _sides(occs, binary, boxes):
    cents = 0.5 * (boxes[:, 0] + boxes[:, 1])
    gbox = np.stack([boxes[:, 0].min(0), boxes[:, 1].max(0)])
    jst = JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                               jnp.asarray(gbox))
    tst = TCo.ContainerStatics(*(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (cents, boxes, gbox)))
    jocc = {"occs": jnp.asarray(occs), "binary": jnp.asarray(binary)}
    tocc = {"occs": torch.from_numpy(occs), "binary": torch.from_numpy(binary)}
    return (jst, jocc), (tst, tocc)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_occupancy_query_matches_jax(case):
    """Each mode of the wrapper (CPU tensors: the plain version) and of
    the plain version itself against the JAX package's union functions."""
    occs, binary, boxes, pts = _inputs(case, seed=1)
    (jst, jocc), (tst, tocc) = _sides(occs, binary, boxes)
    jp = jnp.asarray(pts)
    with jax.disable_jit():
        want = {"bits": JMO.union_binary_fn(jocc, jst)(jp),
                "values": JMO.union_value_fn(jocc, jst)(jp),
                "pair": JMO.union_pair_fn(jocc, jst)(jp)}
    args = (tocc["occs"], tocc["binary"], tst.expert_aabbs,
            torch.from_numpy(pts))
    for mode in T.QUERY_MODES:
        for use_kernels in (True, False):
            got = T.occupancy_query(*args, mode, use_kernels=use_kernels)
            if mode == "pair":
                _eq(got[0], want[mode][0])
                _eq(got[1], want[mode][1])
            else:
                _eq(got, want[mode])
    if pts.shape[0]:
        assert np.asarray(want["values"]).min() >= 0.0  # -1 tags read 0


@pytest.mark.parametrize("case", CASES[:5] + CASES[6:8], ids=IDS[:5] +
                         IDS[6:8])
def test_model_query_functions_match_jax(case):
    """The five query factories of models.occupancy, each expert alone and
    the union, against the JAX package's."""
    occs, binary, boxes, pts = _inputs(case, seed=2)
    (jst, jocc), (tst, tocc) = _sides(occs, binary, boxes)
    jp, tp = jnp.asarray(pts), torch.from_numpy(pts)
    with jax.disable_jit():
        for name in ("union_binary_fn", "union_value_fn", "union_pair_fn"):
            want = getattr(JMO, name)(jocc, jst)(jp)
            for use_kernels in (True, False):
                got = getattr(TMO, name)(tocc, tst,
                                         use_kernels=use_kernels)(tp)
                for g, w in zip(got if isinstance(got, tuple) else (got,),
                                want if isinstance(want, tuple)
                                else (want,)):
                    _eq(g, w)
        for k in range(boxes.shape[0]):
            _eq(TMO.expert_binary_fn(tocc, tst, k)(tp),
                JMO.expert_binary_fn(jocc, jst, k)(jp))
            for g, w in zip(TMO.expert_pair_fn(tocc, tst, k)(tp),
                            JMO.expert_pair_fn(jocc, jst, k)(jp)):
                _eq(g, w)


def test_points_of_any_shape():
    """(..., 3) points give (...,) outputs, as the reference's queries."""
    occs, binary, boxes, pts = _inputs(CASES[4], seed=3)
    args = [torch.from_numpy(a) for a in (occs, binary, boxes)]
    flat = T.occupancy_query(*args, torch.from_numpy(pts[:1000]), "pair")
    grid = T.occupancy_query(*args,
                             torch.from_numpy(pts[:1000]).reshape(10, 100, 3),
                             "pair")
    for f, g in zip(flat, grid):
        assert g.shape == (10, 100)
        assert torch.equal(g.reshape(-1), f)


def _guess(q, R):
    """trunc(q) clamped to [0, R), float32 (NaN reads 0, as the card's
    conversion gives)."""
    q = np.nan_to_num(q, nan=0.0, posinf=R, neginf=0.0)
    return np.clip(q, 0, R - 1).astype(np.int64)


def _correct(rows, x, g):
    """The step row's verdict from guess g: g where t_g <= x < t_{g+1}
    brackets x, else the bisection over the row. rows (n, R + 1), x and
    g (n,)."""
    n, R = np.arange(len(x)), rows.shape[1] - 1
    ok = (x >= rows[n, g]) & (x < rows[n, g + 1])
    c, span = np.zeros_like(g), R
    while span > 1:
        h = span // 2
        c = np.where(rows[n, c + h] <= x, c + h, c)
        span -= h
    return np.where(ok, g, c)


def _cell(rows, x, lo, s, R):
    """The kernel's `step_cell` in numpy float32: trunc(q), q = (x - lo) *
    s, where q's fraction is at least R 2^-20 from an integer; else the
    step row's `_correct` of the clamped guess."""
    with np.errstate(all="ignore"):
        q = (x - lo) * s
        f = q - np.trunc(q)
    margin = f32(R) * f32(2.0 ** -20)
    safe = (f >= margin) & (f <= f32(1.0) - margin)
    g = _guess(q, R)
    return np.where(safe, g, _correct(rows, x, g))


def _walk(table, binary, occs, pts, R):
    """Kernel 11q in numpy float32 over `query_table`'s flat table: per
    expert, every level's bounds a <= x < b tested and the finest that
    holds the point kept (no early return); on each axis `_cell` with the
    table's s = R / w; bits OR'd, values max'd."""
    K, L = binary.shape[:2]
    box = table[:K * L * 16].reshape(K, L, 16)
    rows = table[K * L * 16:K * L * (16 + 3 * (R + 1))].reshape(
        K, L, 3, R + 1)
    bits = np.zeros(pts.shape[0], bool)
    vals = np.zeros(pts.shape[0], f32)
    for k in range(K):
        sel = np.full(pts.shape[0], -1, np.int64)
        for l in reversed(range(L)):  # the finest level written last wins
            a, b = box[k, l, 0:3], box[k, l, 3:6]
            sel = np.where(((pts >= a) & (pts < b)).all(axis=1), l, sel)
        hit = sel >= 0
        lev = np.where(hit, sel, 0)
        ijk = []
        for ax in range(3):
            lo, s = box[k, lev, 8 + ax], box[k, lev, 11 + ax]
            ijk.append(_cell(rows[k, lev, ax], pts[:, ax], lo, s, R))
        flat = (((k * L + lev) * R + ijk[0]) * R + ijk[1]) * R + ijk[2]
        idx = np.where(hit, flat, 0)
        bits |= hit & binary.reshape(-1)[idx]
        vals = np.maximum(vals, np.where(hit, np.maximum(
            occs.reshape(-1)[idx], f32(0.0)), f32(0.0)))
    return bits, vals


@pytest.mark.parametrize("case", ALL_CASES, ids=ALL_IDS)
def test_kernel_walk_matches_plain(case):
    """The kernel's walk (the float-bound level test of `level_bounds`,
    the multiply guess, and near a step its correction on the `cell_steps`
    rows) selects the plain version's cells: bits and values equal."""
    occs, binary, boxes, pts = _inputs(case, seed=4)
    L, R = occs.shape[1], occs.shape[2]
    table = T.query_table(torch.from_numpy(boxes), L, R).numpy()
    bits, vals = _walk(table, binary, occs, pts, R)
    got = T.occupancy_query_plain(*(torch.from_numpy(a) for a in (
        occs, binary, boxes, pts)), "pair")
    np.testing.assert_array_equal(bits, got[0].numpy())
    np.testing.assert_array_equal(vals, got[1].numpy())


def _plain_cell(x, lo, w, R):
    """The plain version's cell on one axis (`_finest_level_index`'s
    rounding), as torch float32: clamp(trunc((x - lo) / w * R), 0, R-1)."""
    rel = (torch.from_numpy(x) - torch.from_numpy(lo)) / torch.from_numpy(w)
    return torch.clamp((rel * R).to(torch.int32).long(), 0, R - 1).numpy()


@pytest.mark.parametrize("R", [12, 24, 127, 128])
def test_cell_steps_count_like_the_division(R):
    """On random boxes, at every step point of every level and axis and
    one ulp either side (and at random points of the level), the number of
    step points <= x is the plain version's cell, wherever a <= x < b."""
    rng = np.random.default_rng(R)
    cents = rng.uniform(-3.0, 3.0, (60, 3))
    half = rng.uniform(0.01, 2.0, (60, 3))
    boxes = torch.from_numpy(np.stack([cents - half, cents + half],
                                      1).astype(f32))
    L = 3
    la = T.level_aabbs(boxes, L)  # (60, L, 2, 3)
    lo, hi = la[..., 0, :], la[..., 1, :]
    rows = T.cell_steps(lo, hi, R).reshape(-1, R + 1).numpy()
    assert np.isneginf(rows[:, 0]).all() and np.isposinf(rows[:, R]).all()
    assert (np.diff(rows, axis=1) >= 0).all()
    inner = rows[:, 1:R]
    lo_n, hi_n = lo.reshape(-1, 1).numpy(), hi.reshape(-1, 1).numpy()
    rand = (lo_n + rng.uniform(size=(len(rows), 64)).astype(f32)
            * (hi_n - lo_n)).astype(f32)
    x = np.concatenate([inner, np.nextafter(inner, f32(np.inf)),
                        np.nextafter(inner, f32(-np.inf)), rand], 1)
    ab = T.level_bounds(boxes, L)  # (60, L, 12)
    a = ab[..., 0:3].reshape(-1, 1).numpy()
    b = ab[..., 3:6].reshape(-1, 1).numpy()
    count = (inner[:, None, :] <= x[:, :, None]).sum(-1)
    want = _plain_cell(x, lo_n, hi_n - lo_n, R)
    inside = (x >= a) & (x < b)
    assert inside.mean() > 0.9
    np.testing.assert_array_equal(count[inside], want[inside])


def test_guess_correction_however_far_off():
    """`step_cell`'s correction lands on the plain cell from any guess:
    guesses drawn anywhere in [0, R), and the kernel's own cell on widths
    where R / w overflows (q saturates or is NaN, the guess many cells
    off: the margin test sends it to the row) or is tiny next to the
    point's offset."""
    rng = np.random.default_rng(7)
    R = 128
    lo = np.array([0.0, 1e-39, -1.5e38, 3.0, -2.0], f32)
    hi = np.array([2e-38, 3e-39, 1.5e38, 3.0 + 2e-5, 2.0], f32)
    rows = T.cell_steps(torch.from_numpy(lo), torch.from_numpy(hi),
                        R).numpy()
    w = hi - lo
    for i in range(len(lo)):
        x = (lo[i] + rng.uniform(size=4096).astype(f32) * w[i]).astype(f32)
        x = np.concatenate([x, rows[i, 1:R]]).astype(f32)
        x = x[(x >= lo[i]) & (x < hi[i])]
        want = _plain_cell(x, lo[i:i + 1], w[i:i + 1], R)
        r = np.broadcast_to(rows[i], (len(x), R + 1))
        with np.errstate(all="ignore"):
            s = f32(R) / w[i]
            own = _guess((x - lo[i]) * s, R)
        if i < 2:  # R / w overflows: the guess alone is far off
            assert np.isinf(s) and (np.abs(own - want) > 1).any()
        np.testing.assert_array_equal(_correct(r, x, own), want)
        np.testing.assert_array_equal(_cell(r, x, lo[i], s, R), want)
        far = rng.integers(0, R, size=len(x))
        np.testing.assert_array_equal(_correct(r, x, far), want)


def test_query_table_layout():
    """The table is the level table, then the step rows; the K=16 arm's
    level table fits the kernel's shared memory."""
    occs, binary, boxes, pts = _inputs(CASES[4])
    K, L, R = occs.shape[:3]
    tb = torch.from_numpy(boxes)
    table = T.query_table(tb, L, R)
    head = table[:K * L * 16].reshape(K, L, 16)
    lb = T.level_bounds(tb, L)
    for cols, want in (([0, 1, 2], lb[..., 0:3]), ([3, 4, 5], lb[..., 3:6]),
                       ([8, 9, 10], lb[..., 6:9]), ([6, 7, 14], lb[..., 9:12]),
                       ([11, 12, 13],
                        torch.full_like(lb[..., 9:12], float(R))
                        / lb[..., 9:12])):
        assert torch.equal(head[..., cols], want)
    assert not head[..., 15].any()
    la = T.level_aabbs(tb, L)
    rows = T.cell_steps(la[..., 0, :], la[..., 1, :], R)
    n = K * L * 16 + rows.numel()
    assert torch.equal(table[K * L * 16:n], rows.reshape(-1))
    assert table.numel() % 4 == 0 and table.numel() - n < 4
    assert not table[n:].any()
    assert T._cached_table(tb, L, R) is T._cached_table(tb, L, R)
    assert T.query_smem(16, 4) <= T.QUERY_SMEM < T.query_smem(1024, 4)


def test_edge_inputs_hit_their_cases():
    """Each kind produces what its name says."""
    occs, binary, boxes, pts = cs.query_edge_inputs("faces", M, 4, 4, 16, 0)
    s = 2.0 ** np.arange(4, dtype=f32)
    ctr = f32(0.5) * (boxes[:, 0] + boxes[:, 1])
    hlf = f32(0.5) * (boxes[:, 1] - boxes[:, 0])
    faces = np.concatenate([(ctr[:, None] - hlf[:, None] * s[:, None]),
                            (ctr[:, None] + hlf[:, None] * s[:, None])], 1)
    assert np.isin(pts, faces.reshape(-1)).mean() > 0.3
    *_, pts = cs.query_edge_inputs("outside", M, 4, 4, 16, 0)
    bits = T.occupancy_query_plain(
        torch.ones(4, 4, 16, 16, 16), torch.ones(4, 4, 16, 16, 16,
                                                 dtype=torch.bool),
        torch.from_numpy(boxes), torch.from_numpy(pts), "bits")
    assert not bits.numpy()[:M // 2].any()  # outside every level
    occs, binary, boxes, pts = cs.query_edge_inputs("round", M, 4, 3, 12, 0)
    lo, w = (T.level_bounds(torch.from_numpy(boxes), 3).numpy()[..., i:i + 3]
             for i in (6, 9))
    rel = (pts[:, None, None, :] - lo[None]) / w[None]
    assert ((rel < 1) & (rel * f32(12) > f32(11.9999))).sum() > M // 4
    occs, binary, *_ = cs.query_edge_inputs("invisible", M, 4, 4, 16, 0)
    assert (occs == -1).mean() > 0.25 and not binary[occs == -1].any()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    occs, binary, boxes, pts = (torch.from_numpy(a) for a in _inputs(
        CASES[4]))
    with pytest.raises(ValueError, match="mode"):
        T.occupancy_query(occs, binary, boxes, pts, "both")
    with pytest.raises(ValueError, match="mode"):
        T.occupancy_query(occs, binary, boxes, pts, "both",
                          use_kernels=False)
    with pytest.raises(ValueError, match="device"):
        T.occupancy_query(occs, binary, boxes, pts.to("meta"), "bits")
    empty = T.occupancy_query(occs, binary, boxes, pts[:0], "pair")
    assert empty[0].shape == (0,) and empty[1].shape == (0,)
    assert empty[0].dtype == torch.bool and empty[1].dtype == torch.float32
