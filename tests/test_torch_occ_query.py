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
tagged -1, random points, K = 1, 4, 5, M = 1 and 0. The JAX side runs
with jit disabled (jitted XLA on the CPU contracts the level boxes'
multiply-adds, which can move a face by an ulp). Bits and values are
equal bit for bit: the same float32 operations select the same cells.
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

M = 1024 + 13  # a tail past whole 256-point blocks
CASES = [(label, kind, min(m, M), k, l, r)
         for label, kind, m, k, l, r in cs.query_edge_cases()]
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


def _walk(table, binary, occs, pts, R):
    """Kernel 11q in numpy float32: per expert, the first level (finest
    first) whose bounds a <= x < b hold on every axis decides; only it
    divides, rel * R truncates and clamps; bits OR'd, values max'd."""
    K, L = table.shape[:2]
    bits = np.zeros(pts.shape[0], bool)
    vals = np.zeros(pts.shape[0], f32)
    for k in range(K):
        flat = np.full(pts.shape[0], -1, np.int64)
        for l in reversed(range(L)):  # the finest level written last wins
            a, b, lo, w = (table[k, l, 3 * i:3 * i + 3] for i in range(4))
            inside = ((pts >= a) & (pts < b)).all(axis=1)
            rel = (pts - lo) / w
            ijk = np.clip((rel * f32(R)).astype(np.int32), 0, R - 1)
            cell = (((k * L + l) * R + ijk[:, 0]) * R + ijk[:, 1]) * R \
                + ijk[:, 2]
            flat = np.where(inside, cell, flat)
        hit = flat >= 0
        idx = np.where(hit, flat, 0)
        bits |= hit & binary.reshape(-1)[idx]
        vals = np.maximum(vals, np.where(hit, np.maximum(
            occs.reshape(-1)[idx], f32(0.0)), f32(0.0)))
    return bits, vals


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_walk_matches_plain(case):
    """The kernel's float-bound level test (the table of `level_bounds`)
    selects the plain version's cells: bits and values equal."""
    occs, binary, boxes, pts = _inputs(case, seed=4)
    R = occs.shape[2]
    table = T.level_bounds(torch.from_numpy(boxes), occs.shape[1]).numpy()
    bits, vals = _walk(table, binary, occs, pts, R)
    got = T.occupancy_query_plain(*(torch.from_numpy(a) for a in (
        occs, binary, boxes, pts)), "pair")
    np.testing.assert_array_equal(bits, got[0].numpy())
    np.testing.assert_array_equal(vals, got[1].numpy())


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
