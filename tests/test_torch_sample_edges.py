"""Adversarial inputs of the inverse-CDF sampler (kernel 3, its module
`nerfsys_tpu_torch.ops.occupancy`) against JAX, the kernel's algorithm
walked in numpy, and its launch plans and caches.

Inputs come from chip_smoke.py's `sample_edge_inputs`, the ones the kernel
is held to on the card (numpy seeds), at fewer rays: rows that dip by one
ulp after dead probes, entries less than 1e-12 apart with targets inside
them (the clamp), targets equal to cdf entries, targets of 1 - 1e-6,
all-dead rows, near = far, jittered targets out of order, and P in {1,
127, 129, 256} x S in {1, 8, 24, 64}. The JAX side is nerfsys_tpu.ops.
occupancy `sample_tvals_from_cdf` (jit disabled, randomized=False: the
shared midpoint targets, so only those cases); the port's side
`sample_tvals_plain` and the kernel wrapper on CPU tensors (its plain
version).
Tolerances: t within 1e-6 against JAX (t <= ~6 in float32: a few ulp for
XLA's linspace and its eager ops); the numpy walk of the kernel, the
plain version and the wrapper equal bit for bit (the same idx and the
same float32 operations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerfsys_tpu.ops import occupancy as J
from nerfsys_tpu_torch.ops import occupancy as T
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

JAX_TOL = 1e-6
N = 133  # a tail past whole 4-ray blocks
f32 = np.float32

CASES = cs.sample_edge_cases()
IDS = [c[0].replace(" ", "_") for c in CASES]
SHARED = [c for c in CASES if not c[5]]


def _inputs(case, seed, n=N):
    _, kind, _, P, S, per_ray = case
    return cs.sample_edge_inputs(kind, n, P, S, per_ray, seed)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", SHARED,
                         ids=[c[0].replace(" ", "_") for c in SHARED])
def test_plain_sampler_matches_jax_on_edges(case):
    """The plain version (and the wrapper on CPU tensors) against JAX's
    sampler on the adversarial cdf rows with the midpoint targets."""
    cdf, near, far, u = _inputs(case, seed=1)
    S = u.shape[-1]
    state = {"cdf": jnp.asarray(cdf), "alive": jnp.ones(N, bool)}
    with jax.disable_jit():
        want, _ = J.sample_tvals_from_cdf(state, jnp.asarray(near),
                                          jnp.asarray(far), S)
    want = np.asarray(want)
    args = _torch((cdf, near, far, u))
    for got in (T.sample_tvals_plain(*args), T.sample_tvals_kernel(*args)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_TOL)


def test_edge_inputs_hit_their_cases():
    """Each kind produces what its name says."""
    def inp(kind, per_ray=True, p=128, s=32):
        return cs.sample_edge_inputs(kind, N, p, s, per_ray, 0)

    c, *_ = inp("dip")
    assert (c[:, 1:] < c[:, :-1]).any(axis=1).sum() >= N // 3
    c, _, _, u = inp("tiny")
    lo = np.array([[r[int(np.sum(r[1:] <= x))] for x in ur]
                   for r, ur in zip(c, u)])
    hi = np.array([[r[int(np.sum(r[1:] <= x)) + 1] for x in ur]
                   for r, ur in zip(c, u)])
    assert ((hi - lo) < 1e-12).sum() >= N  # the 1e-12 clamp applies
    c, _, _, u = inp("exact")
    assert all(np.isin(ur, r).all() for r, ur in zip(c, u))
    _, _, _, u = inp("top")
    assert (u[:, -4:] == f32(1.0 - 1e-6)).all()
    c, *_ = inp("dead", per_ray=False)
    assert np.allclose(np.diff(c, axis=1), 1.0 / 128, atol=1e-6)
    _, near, far, _ = inp("near=far", per_ray=False)
    assert (near == far).all()
    _, _, _, u = inp("reversed")
    assert (np.diff(u, axis=1) <= 0).all()


def _skew(q):
    return q + (q >> 5)


def _kernel_walk(cdf, near, far, u):
    """Kernel 3's algorithm in numpy float32: the skewed staged row, the
    vote on adjacent pairs, the binary search (or the literal count), the
    lerps, the vote on neighbouring placements and the rank sort. Returns
    t and (rows that took the count, rows that took the rank sort)."""
    n, P = cdf.shape[0], cdf.shape[1] - 1
    S = u.shape[-1]
    plan = T.sample_plan(n, P, S)
    staged = np.full((n, plan.stride), np.nan, f32)
    staged[:, _skew(np.arange(P + 1))] = cdf
    c = lambda q: np.take_along_axis(staged, _skew(q), 1)  # noqa: E731
    mono = (c(np.tile(np.arange(P), (n, 1))) <=
            c(np.tile(np.arange(1, P + 1), (n, 1)))).all(axis=1)
    use_search = mono
    uu = np.broadcast_to(u, (n, S)).astype(f32)
    cnt_s = np.zeros((n, S), np.int64)
    step = plan.top
    while step > 0:
        q = cnt_s + step
        ok = (q <= P) & (c(np.minimum(q, P)) <= uu)
        cnt_s = np.where(ok, q, cnt_s)
        step >>= 1
    cnt_c = (cdf[:, None, 1:] <= uu[:, :, None]).sum(axis=-1)
    cnt = np.where(use_search[:, None], cnt_s, cnt_c)
    idx = np.clip(cnt, 0, P - 1)
    edges = T.linspace01(P + 1).numpy()
    width = edges[1] - edges[0]
    lo, hi = c(idx), c(idx + 1)
    frac = (uu - lo) / np.maximum(hi - lo, f32(1e-12))
    s = edges[idx] + frac * width
    t = near[:, None] + (far - near)[:, None] * s
    in_order = (t[:, :-1] <= t[:, 1:]).all(axis=1)
    out = t.copy()
    j = np.arange(S)
    for r in np.nonzero(~in_order)[0]:
        ti = t[r]
        rank = ((ti[None, :] < ti[:, None]) |
                ((ti[None, :] == ti[:, None]) &
                 (j[None, :] < j[:, None]))).sum(axis=1)
        out[r, rank] = ti
    return out, (int((~use_search).sum()), int((~in_order).sum()))


@pytest.mark.parametrize("seed", [2, 3, 4, 5])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_walk_matches_plain(case, seed):
    """The walk of kernel 3 equals the plain version bit for bit on four
    draws of each case; the rows that take the count are the rows that
    dip."""
    arrays = _inputs(case, seed=seed)
    cdf, near, far, u = arrays
    got, (n_count, n_sort) = _kernel_walk(*arrays)
    want = T.sample_tvals_plain(*_torch(arrays)).numpy()
    np.testing.assert_array_equal(got, want)
    dips = int((~(cdf[:, :-1] <= cdf[:, 1:]).all(axis=1)).sum())
    assert n_count == dips


def test_walk_reaches_every_branch():
    """Over the edge cases both the search and the count, and both the
    sorted write and the rank sort, are taken."""
    counts = np.zeros(3, np.int64)
    for seed, case in enumerate(CASES):
        _, (n_count, n_sort) = _kernel_walk(*_inputs(case, seed))
        counts += (n_count, n_sort, N)
    n_count, n_sort, rows = counts
    assert 0 < n_count < rows and 0 < n_sort < rows


@pytest.mark.parametrize("seed", range(6))
def test_search_equals_count_on_rows_that_never_decrease(seed):
    """On a row that never decreases the binary search finds the count of
    entries <= u, with runs of equal entries and targets equal to entries,
    below the first and at or past the last."""
    rng = np.random.default_rng(seed)
    P = int(rng.integers(1, 300))
    row = np.sort(rng.choice(rng.uniform(0, 1, max(1, P // 3)).astype(f32),
                             P + 1))
    row[0] = 0.0
    targets = np.concatenate([row, rng.uniform(-0.1, 1.1, 200).astype(f32),
                              [np.nextafter(row[-1], f32(2))]]).astype(f32)
    top = T.sample_plan(1, P, 1).top
    for x in targets:
        cnt, step = 0, top
        while step > 0:
            if cnt + step <= P and row[cnt + step] <= x:
                cnt += step
            step >>= 1
        assert cnt == int(np.sum(row[1:] <= x))


@pytest.mark.parametrize("n", [1, 4001, 65_536])
@pytest.mark.parametrize("P", [1, 2, 31, 32, 33, 127, 128, 129, 256, 1000])
@pytest.mark.parametrize("S", [1, 24, 32, 64])
def test_sample_plan(P, S, n):
    """The staged row holds every skewed entry inside its stride, the
    search's steps cover 0..P, a block takes SAMPLE_WARPS rays (the launch
    caps the grid at the resident blocks), and the shared memory (each
    warp's two rows and S placements, then S mask bytes a warp) stays
    under 48 KB."""
    plan = T.sample_plan(n, P, S)
    sk = _skew(np.arange(P + 1))
    assert len(set(sk.tolist())) == P + 1 and sk.max() < plan.stride
    assert plan.top <= P < 2 * plan.top
    assert plan.blocks == -(-n // plan.warps) and plan.warps == 4
    assert plan.threads == 32 * plan.warps
    assert plan.smem == plan.warps * (4 * (2 * plan.stride + S) + S)
    assert plan.smem <= T.SAMPLE_SMEM
    st = plan.as_struct()
    assert (st.warps, st.threads, st.blocks, st.stride, st.smem, st.top) == (
        plan.warps, plan.threads, plan.blocks, plan.stride, plan.smem,
        plan.top)


def test_sample_plan_limits():
    with pytest.raises(ValueError):
        T.sample_plan(10, 0, 32)
    with pytest.raises(ValueError):
        T.sample_plan(10, 128, 0)
    with pytest.raises(ValueError):
        T.sample_plan(10, 1500, 32)  # 4 x 2 rows of 1,548 floats


def test_plan_and_edges_cached_per_key():
    """The wrapper's struct is built once per shape, and `edges` once per
    (P, device): a second P or device gets its own."""
    assert T._sample_struct(4000, 128, 32) is T._sample_struct(4000, 128, 32)
    assert T._sample_struct(4000, 128, 32) is not T._sample_struct(
        4000, 127, 32)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    e = T._sample_edges(128, cpu)
    assert e is T._sample_edges(128, cpu)
    assert torch.equal(e, T.linspace01(129))
    other_p = T._sample_edges(127, cpu)
    assert other_p is not e and other_p.shape == (128,)
    other_dev = T._sample_edges(128, meta)
    assert other_dev is not e and other_dev.device.type == "meta"


def test_wrapper_on_cpu_is_the_plain_version():
    cdf, near, far, u = _torch(_inputs(CASES[1], seed=5))
    np.testing.assert_array_equal(
        T.sample_tvals_kernel(cdf, near, far, u).numpy(),
        T.sample_tvals_plain(cdf, near, far, u).numpy())
