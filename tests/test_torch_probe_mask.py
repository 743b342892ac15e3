"""Port parity of the probe-bit hard mask (the reference's with_mask /
mask_from_probes): the sampler's mask output (kernel 3m's plain version
and the kernel's algorithm walked in numpy), the two render functions
with mask_from_probes=True, and the reference tests' properties, on the
CPU.

The sampler's inputs are chip_smoke.py's `sample_edge_inputs` with the
probe bits (numpy seeds; a probe occupied where its weight is not 0): the
JAX side is nerfsys_tpu.ops.occupancy `sample_tvals_from_cdf(...,
with_mask=True)` with jit disabled, on the shared midpoint targets and on
jittered ones (jax.random.uniform patched to return a numpy draw, from
which the port forms its targets as `_sample_targets` does). The masks
are equal, tie order included: "ties: t within two ulps" puts every t of
a row on one of three floats, so samples of different intervals with
different bits tie, and only the stable order (jnp.argsort's, kept by
`torch.sort(stable=True)` and by the kernel's (value, index) rank) takes
their bits in the reference's order. t within 1e-6.

The renders (`render_rays_occ_field`, `render_rays_occ`, the early-stop
partial and resume) run against the JAX package eagerly on the same numpy
params, grids and rays within 1e-5, as tests/test_torch_render_occ.py
holds them. The properties, from tests/test_occupancy.py:606-666 and
tests/test_chunk_skip.py:308-330: the probe-masked acc is never below the
point-masked acc, and equals it where the grid is constant within probe
intervals; from tests/test_early_stop.py:154-161: the partial plus the
resume of every ray equals the one-shot render.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_early_stop import _layout, _world
from test_torch_render_occ import _camera, _setup

import chip_smoke as cs
from nerfsys_tpu.ops import occupancy as J
from nerfsys_tpu.models import occupancy as JMO
from nerfsys_tpu_torch.data import ram_rays as TRays
from nerfsys_tpu_torch.models import occupancy as TMO
from nerfsys_tpu_torch.ops import occupancy as T
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

N = 133  # a tail past whole 4-ray blocks
f32 = np.float32
CASES = cs.sample_edge_cases()
IDS = [c[0].replace(" ", "_") for c in CASES]
SHARED = [c for c in CASES if not c[5]]


def _inputs(case, seed, n=N):
    _, kind, _, P, S, per_ray = case
    return cs.sample_edge_inputs(kind, n, P, S, per_ray, seed,
                                 with_bits=True)


def _jax_sample(cdf, near, far, occ, S, key=None):
    state = {"cdf": jnp.asarray(cdf), "alive": jnp.asarray(occ.any(1)),
             "occ": jnp.asarray(occ)}
    with jax.disable_jit():
        t, alive, mask = J.sample_tvals_from_cdf(
            state, jnp.asarray(near), jnp.asarray(far), S, key=key,
            randomized=key is not None, with_mask=True)
    return np.asarray(t), np.asarray(alive), np.asarray(mask)


def _port_sample(cdf, near, far, occ, u):
    state = {"cdf": torch.from_numpy(cdf),
             "alive": torch.from_numpy(occ.any(1)),
             "occ": torch.from_numpy(occ)}
    outs = []
    for use_kernels in (True, False):
        fn = T.sample_tvals_kernel if use_kernels else T.sample_tvals_plain
        outs.append(fn(state["cdf"], torch.from_numpy(near),
                       torch.from_numpy(far), torch.from_numpy(u),
                       state["occ"]))
    (t, mask), (t_p, mask_p) = outs
    assert torch.equal(t, t_p) and torch.equal(mask, mask_p)
    # the mask leaves t as the sampler without it places it
    assert torch.equal(t, T.sample_tvals_plain(
        state["cdf"], torch.from_numpy(near), torch.from_numpy(far),
        torch.from_numpy(u)))
    return t.numpy(), mask.numpy()


@pytest.mark.parametrize("case", SHARED,
                         ids=[c[0].replace(" ", "_") for c in SHARED])
def test_sample_with_mask_matches_jax(case):
    cdf, near, far, u, occ = _inputs(case, seed=1)
    S = u.shape[-1]
    want_t, want_alive, want_mask = _jax_sample(cdf, near, far, occ, S)
    t, mask = _port_sample(cdf, near, far, occ, u)
    np.testing.assert_allclose(t, want_t, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mask, want_mask)
    state = {"cdf": torch.from_numpy(cdf),
             "alive": torch.from_numpy(occ.any(1)),
             "occ": torch.from_numpy(occ)}
    _, alive, mask2 = T.sample_tvals_from_cdf(
        state, torch.from_numpy(near), torch.from_numpy(far), S,
        with_mask=True)
    np.testing.assert_array_equal(alive.numpy(), want_alive)
    np.testing.assert_array_equal(mask2.numpy(), want_mask)


@pytest.mark.parametrize("kind", ["rand", "dip", "tiny", "dead"])
def test_jittered_sample_with_mask_matches_jax(kind, monkeypatch):
    """Per-ray jittered targets from one numpy draw on both sides."""
    S, P = 32, 128
    cdf, near, far, _, occ = cs.sample_edge_inputs(kind, N, P, S, False, 5,
                                                   with_bits=True)
    U = np.random.default_rng(6).uniform(size=(N, S)).astype(f32)
    U[::3, -1] = f32(1.0 - 2 ** -24)  # clipped at 1 - 1e-6
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, *a, **k:
                        jnp.asarray(U, dtype))
    u = torch.clamp((torch.arange(S, dtype=torch.float32) + 0.5) / S
                    + (torch.from_numpy(U) - 0.5) / S, 0.0, 1.0 - 1e-6)
    want_t, _, want_mask = _jax_sample(cdf, near, far, occ, S,
                                       key=jax.random.PRNGKey(0))
    t, mask = _port_sample(cdf, near, far, occ, u.numpy())
    np.testing.assert_allclose(t, want_t, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mask, want_mask)


def _mask_walk(cdf, near, far, u, occ):
    """Kernel 3m's mask in numpy: each sample's bit occ[idx] (idx the
    clipped count, which the binary search equals), written at position i
    on a row whose placements never decrease, else at the sample's rank
    in (value, index) order."""
    n, P = cdf.shape[0], cdf.shape[1] - 1
    S = u.shape[-1]
    uu = np.broadcast_to(u, (n, S)).astype(f32)
    idx = np.clip((cdf[:, None, 1:] <= uu[:, :, None]).sum(-1), 0, P - 1)
    edges = T.linspace01(P + 1).numpy()
    lo = np.take_along_axis(cdf, idx, 1)
    hi = np.take_along_axis(cdf, idx + 1, 1)
    frac = (uu - lo) / np.maximum(hi - lo, f32(1e-12))
    s = edges[idx] + frac * (edges[1] - edges[0])
    t = near[:, None] + (far - near)[:, None] * s
    bits = np.take_along_axis(occ, idx, 1)
    mask = bits.copy()
    j = np.arange(S)
    sorted_rows = (t[:, :-1] <= t[:, 1:]).all(axis=1)
    for r in np.nonzero(~sorted_rows)[0]:
        ti = t[r]
        rank = ((ti[None, :] < ti[:, None])
                | ((ti[None, :] == ti[:, None]) & (j[None, :] < j[:, None]))
                ).sum(axis=1)
        mask[r, rank] = bits[r]
    return mask, int((~sorted_rows).sum())


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_mask_walk_matches_plain(case, seed):
    cdf, near, far, u, occ = _inputs(case, seed)
    got, _ = _mask_walk(cdf, near, far, u, occ)
    _, want = T.sample_tvals_plain(*(torch.from_numpy(a) for a in (
        cdf, near, far, u, occ)))
    np.testing.assert_array_equal(got, want.numpy())


def test_tied_rows_pin_the_stable_order():
    """The tie-order hazard: in the tied rows, samples of equal t carry
    different bits, so any order but the stable one moves bits; the rank
    sort is reached with ties too. The stable order is the reference's."""
    case = next(c for c in CASES if c[1] == "tied" and not c[5])
    cdf, near, far, u, occ = _inputs(case, seed=7)
    t, mask = _port_sample(cdf, near, far, occ, u)
    idx = np.clip((cdf[:, None, 1:] <= u[None, :, None]).sum(-1), 0,
                  cdf.shape[1] - 2)
    bits = np.take_along_axis(occ, idx, 1)
    ties = (t[:, :-1] == t[:, 1:]) & (bits[:, :-1] != bits[:, 1:])
    assert ties.sum() > N  # equal t, different bits: order matters
    flipped = T.sample_tvals_plain(*(torch.from_numpy(a) for a in (
        cdf, near, far, u[::-1].copy(), occ)))[1].numpy()
    assert not np.array_equal(flipped, mask)  # another order, other bits
    rev = next(c for c in CASES if c[1] == "tied" and c[5])
    _, n_sort = _mask_walk(*_inputs(rev, seed=7))
    assert n_sort > N // 2  # the rank sort, with ties


# --------------------------- the render functions ---------------------------
def _slab_grid(cells):
    """One expert, one level: a box x, y in [0, 1/8], z in [1/4, 3/8] at
    R=16 (cells of 1/128 in z) with the z-cells `cells` occupied, and 16
    rays up the z axis through it from z=0 to z=1. With 64 probes, probe
    interval j is [j/64, (j+1)/64), two cells of z, and its midpoint lies
    in the second: cells {2j-32, 2j-31} hold the interval."""
    R = 16
    binary = np.zeros((1, 1, R, R, R), bool)
    binary[0, 0, :, :, cells] = True
    occs = np.where(binary, f32(0.5), f32(0.0)).astype(f32)
    aabb = np.array([[0.0, 0.0, 0.25], [0.125, 0.125, 0.375]], f32)
    xy = np.random.default_rng(0).uniform(0.01, 0.115, (16, 2))
    o = np.concatenate([xy, np.zeros((16, 1))], 1)
    d = np.tile([0.0, 0.0, 1.0], (16, 1))
    nf = np.tile([0.0, 1.0], (16, 1))
    rays = np.concatenate([o, d, nf], 1).astype(f32)
    return occs, binary, aabb, rays


def _slab_render(occs, binary, aabb, rays, probe_mask):
    """The single-field render of a constant field (rgb (0.8, 0.2, 0.1),
    sigma 5) on both sides -> (JAX outputs, the port's)."""
    kw = dict(n_probes=64, mask_from_probes=probe_mask, randomized=False)

    def jfield(pts, dirs):
        return (jnp.tile(jnp.array([[0.8, 0.2, 0.1]]), (pts.shape[0], 1)),
                jnp.full((pts.shape[0],), 5.0))

    def tfield(pts, dirs):
        return (torch.tensor([[0.8, 0.2, 0.1]]).expand(pts.shape[0], 3),
                torch.full((pts.shape[0],), 5.0))

    jbin, jaabb = jnp.asarray(binary[0]), jnp.asarray(aabb)
    with jax.disable_jit():
        want = J.render_rays_occ_field(
            jfield, lambda x: J.query_binary(jbin, jaabb, x),
            jnp.asarray(rays), 32, **kw)
    got = T.render_rays_occ_field(
        tfield, (torch.from_numpy(occs), torch.from_numpy(binary),
                 torch.from_numpy(aabb)[None]), torch.from_numpy(rays), 32,
        **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    return got


def test_probe_mask_equals_point_mask_on_an_interval_aligned_grid():
    """Cells 8, 9 (interval 20) and 12, 13 (interval 22): the grid is
    constant within every probe interval, so both masks keep the same
    samples and render the same."""
    grid = _slab_grid([8, 9, 12, 13])
    point = _slab_render(*grid, probe_mask=False)
    bits = _slab_render(*grid, probe_mask=True)
    for a, b in zip(point, bits):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert float(bits[3].min()) > 0.1


def test_probe_mask_is_a_conservative_superset():
    """Cells 9 and 13 only: intervals 20 and 22 are occupied at their
    midpoints, but the first half of each is not; the point mask zeroes
    the samples there, the interval mask keeps them."""
    grid = _slab_grid([9, 13])
    point = _slab_render(*grid, probe_mask=False)
    bits = _slab_render(*grid, probe_mask=True)
    assert bool((bits[3] >= point[3] - 1e-6).all())
    assert float((bits[3] - point[3]).min()) > 1e-3
    assert float(bits[3].max()) > 0


@pytest.mark.parametrize("kw", [
    dict(importance=True), dict(importance=False),
    dict(importance=True, active_expert=1),
    dict(importance=True, field_expert=0),
    dict(importance=True, hard_mask=False)],
    ids=["importance", "occ_bits_only", "active_expert", "field_expert",
         "soft_ignores_it"])
def test_render_rays_occ_with_probe_masks_matches_jax(kw):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup()
    md = _camera(8)
    rays, _ = TRays.frame_rays(md.H, md.W, md.intrinsics, md.c2w,
                               aabb=np.asarray(jst.global_aabb))
    rays[::7, 6:] = np.inf  # invalid rays render the background
    kw = dict(kw, n_probes=32, mask_from_probes=True)
    with jax.disable_jit():
        want = JMO.render_rays_occ(jp, cfg, jst, jocc, jnp.asarray(rays), 8,
                                   **kw)
    got = TMO.render_rays_occ(tp, tcfg, tst, tocc, torch.tensor(rays), 8,
                              **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    point = TMO.render_rays_occ(tp, tcfg, tst, tocc, torch.tensor(rays), 8,
                                **dict(kw, mask_from_probes=False))
    assert bool((got[3] >= point[3] - 1e-6).all())
    if kw.get("hard_mask", True):
        assert not torch.allclose(got[3], point[3], atol=1e-4)
    else:  # soft mode: the mask is ignored
        for g, p in zip(got, point):
            assert torch.equal(g, p)


def test_union_probe_grid_bits_match_jax():
    """Under the union probe grid the bits come from the resampled grid
    (a further coarsening), as in the reference."""
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup()
    md = _camera(8)
    rays, _ = TRays.frame_rays(md.H, md.W, md.intrinsics, md.c2w,
                               aabb=np.asarray(jst.global_aabb))
    with jax.disable_jit():
        jgrid = JMO.build_union_probe_grid(jocc, jst, res=16,
                                           importance=True)
        want = JMO.render_rays_occ(
            jp, cfg, jst, jocc, jnp.asarray(rays), 8, importance=True,
            n_probes=32, mask_from_probes=True,
            probe_fns=JMO.union_probe_fns(jgrid))
    tgrid = TMO.build_union_probe_grid(tocc, tst, res=16, importance=True)
    got = TMO.render_rays_occ(
        tp, tcfg, tst, tocc, torch.tensor(rays), 8, importance=True,
        n_probes=32, mask_from_probes=True,
        probe_fns=TMO.union_probe_fns(tgrid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


# --------------------------- early stop --------------------------------------
S = 12  # the early-stop tests' samples, split 3 + 9


def test_et_partial_with_probe_masks_matches_jax():
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _world()
    rays = _layout(np.random.default_rng(3), "skip")
    kw = dict(seg_samples=3, importance=True, hard_mask=True,
              mask_from_probes=True, early_stop_eps=1e-2, sigma_scale=4.0)
    with jax.disable_jit():
        jout, jalive, jstate = JMO.render_rays_occ_et_partial(
            jp, cfg, jst, jocc, jnp.asarray(rays), S, **kw)
    tout, talive, tstate = TMO.render_rays_occ_et_partial(
        tp, tcfg, tst, tocc, torch.tensor(rays), S, **kw)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    np.testing.assert_array_equal(tstate["occ_rest"].numpy(),
                                  np.asarray(jstate["occ_rest"]))
    assert tstate["occ_rest"].shape == (len(rays), S - 3)


@pytest.mark.parametrize("fog", [False, True])
def test_partial_plus_resume_all_equals_one_shot(fog):
    """Resuming every ray from the partial's state (its probe bits
    included) gives the one-shot probe-masked render."""
    _, tcfg, _, (tp, tst, tocc) = _world()
    rays = torch.tensor(_layout(np.random.default_rng(4), "skip"))
    kw = dict(importance=True, hard_mask=True, mask_from_probes=True,
              sigma_scale=4.0)
    rgb_f, depth_f, _, acc_f = TMO.render_rays_occ(tp, tcfg, tst, tocc,
                                                   rays, S, **kw)
    _, _, state = TMO.render_rays_occ_et_partial(
        tp, tcfg, tst, tocc, rays, S, seg_samples=3, fog=fog,
        early_stop_eps=0.0, **kw)
    ids = torch.arange(rays.shape[0])
    outs = TMO.render_rays_occ_et_resume(tp, tcfg, tst, tocc, state, ids,
                                         hard_mask=True, sigma_scale=4.0)
    for g, w in zip(outs[:3], (rgb_f, depth_f, acc_f)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    # the probe bits, not a point query, masked the resumed samples
    point = TMO.render_rays_occ(tp, tcfg, tst, tocc, rays, S,
                                **dict(kw, mask_from_probes=False))
    assert not torch.allclose(outs[2], point[3], atol=1e-4)
