"""Port parity of the native host ray kernels (nerfsys_tpu_torch/data/native).

The port builds its own copy of ray_kernels.cpp with g++ under the JAX
package's flags, so its entry points must equal the JAX package's native
functions bit for bit on the same numpy inputs: the frame rays, the
compaction and the sampled router everywhere, the DDA router on random
rays. Against the port's own numpy paths (the plain versions,
`native=False`) the cases and tolerances of tests/test_native.py hold:
valid masks equal, o/d within 1e-5, near/far within 1e-4 (rtol 1e-5) on
valid rays; compaction and the sampled router equal.

The exact DDA router equals its numpy version (the spec) bit for bit, also
on adversarial rays: axis-parallel directions on each axis, origins on
cell faces and inside the box, inf near/far, grazing rays in a box face,
zero-length segments, on grids (1, 8, 8), (1, 16, 16) and (3, 5, 7). The
JAX package's native DDA does not: its weak-overlap filter rounds the
selected cell's box in float32, and on grids whose fractions are not
dyadic it disagrees with the spec on rays that start on or run along a
cell face (~1-2.6% of these rays); the port's copy rounds as the spec
does, a decided divergence pinned below.

The build: two processes building into one empty directory at once both
load the library, and a broken compiler raises.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from nerfsys_tpu.data import native as JN
from nerfsys_tpu.data import task_dataset as JT
from nerfsys_tpu_torch.data import native as TN
from nerfsys_tpu_torch.data import ram_rays as TR
from nerfsys_tpu_torch.data import task_dataset as TT
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
GRIDS = [(1, 8, 8), (1, 16, 16), (3, 5, 7)]


def _random_cam(rng, H=24, W=32):
    """tests/test_native.py's camera: a random rotation and origin."""
    intr = np.array([30.0, 28.0, W / 2 + 1.3, H / 2 - 0.7], np.float32)
    u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
    R = (u @ vt).astype(np.float32)
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    t = rng.normal(size=3).astype(np.float32) * 2
    return intr, np.concatenate([R, t[:, None]], axis=1)


def _random_rays(rng, n, spread=0.3):
    o = rng.normal(size=(n, 3)).astype(np.float32) * spread
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nf = np.tile(np.array([0.1, 2.0], np.float32), (n, 1))
    nf[::17] = np.inf  # some invalid rays
    return np.concatenate([o, d, nf], 1)


def _adversarial_rays(aabb, cells, seed=0, n=3000):
    """Rays that stress the DDA: axis-parallel (each axis, both signs),
    origins exactly on cell faces, inside and outside the box, inf
    near/far, grazing rays lying in a box face, zero-length and reversed
    segments, and random ones."""
    rng = np.random.default_rng(seed)
    lo, hi = aabb[0].astype(np.float32), aabb[1].astype(np.float32)
    cell = (hi - lo) / np.asarray(cells, np.float32)
    parts = []

    def rays(o, d, near, far):
        o = np.asarray(o, np.float32)
        d = np.asarray(d, np.float32)
        k = o.shape[0]
        nf = np.stack([np.broadcast_to(np.float32(near), (k,)),
                       np.broadcast_to(np.float32(far), (k,))], 1)
        return np.concatenate([o, d, nf], 1).astype(np.float32)

    inside = lo + rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32) * (
        hi - lo)
    outside = lo + rng.uniform(-0.6, 1.6, (n, 3)).astype(np.float32) * (
        hi - lo)
    # axis-parallel, each axis and sign, from inside and outside
    for a in range(3):
        for sgn in (1.0, -1.0):
            d = np.zeros((n, 3), np.float32)
            d[:, a] = sgn
            parts += [rays(inside, d, 0.0, 10.0),
                      rays(outside, d, 0.0, 10.0)]
    # origins on cell faces (k * cell exactly) with random directions
    d_rand = rng.normal(size=(n, 3)).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=1, keepdims=True)
    for a in range(3):
        on = inside.copy()
        k = rng.integers(0, int(cells[a]) + 1, n)
        on[:, a] = lo[a] + k.astype(np.float32) * cell[a]
        parts.append(rays(on, d_rand, 0.0, 10.0))
        # and moving along that face's plane only (d[a] = 0)
        d_plane = d_rand.copy()
        d_plane[:, a] = 0.0
        d_plane /= np.maximum(np.linalg.norm(d_plane, axis=1,
                                             keepdims=True), 1e-12)
        parts.append(rays(on, d_plane, 0.0, 10.0))
        # grazing: in the box's own face planes, moving within them
        for face in (lo[a], hi[a]):
            g = inside.copy()
            g[:, a] = face
            parts.append(rays(g, d_plane, 0.0, 10.0))
    # inf near / far, zero-length and reversed segments, negative near
    parts += [rays(inside, d_rand, np.inf, np.inf),
              rays(inside, d_rand, 0.0, np.inf),
              rays(inside, d_rand, -np.inf, 5.0),
              rays(inside, d_rand, 0.5, 0.5),
              rays(inside, d_rand, 2.0, 1.0),
              rays(outside, d_rand, -1.0, 10.0)]
    # random rays from far away, and aimed at cell corners
    far_o = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    corners = lo + rng.integers(0, 4, (n, 3)).astype(np.float32) * cell
    to_c = corners - far_o
    to_c /= np.linalg.norm(to_c, axis=1, keepdims=True)
    parts += [rays(far_o, d_rand, 0.0, 20.0), rays(far_o, to_c, 0.0, 20.0)]
    return np.concatenate(parts, 0)


# --------------------------- port native == JAX native ------------------------
@pytest.mark.parametrize("with_aabb", [True, False])
@pytest.mark.parametrize("with_clamp", [True, False])
@pytest.mark.parametrize("center", [True, False])
def test_compute_rays_equals_jax_native(with_aabb, with_clamp, center):
    rng = np.random.default_rng(3)
    intr, c2w = _random_cam(rng, 24, 32)
    kw = dict(aabb=BOX if with_aabb else None,
              near=0.2 if with_clamp else None,
              far=5.0 if with_clamp else None, center_pixels=center)
    got = TN.compute_rays_native(24, 32, intr, c2w, **kw)
    want = JN.compute_rays_native(24, 32, intr, c2w, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == bool and got[0].dtype == np.float32
    # a (4, 4) pose reads as its top three rows
    pose = np.eye(4, dtype=np.float32)
    pose[:3] = c2w
    np.testing.assert_array_equal(
        TN.compute_rays_native(24, 32, intr, pose, **kw)[0], got[0])


@pytest.mark.parametrize("with_keep", [True, False])
def test_compact_rays_equals_jax_native(with_keep):
    rng = np.random.default_rng(0)
    n = 1000
    rays = rng.normal(size=(n, 8)).astype(np.float32)
    valid = rng.integers(0, 2, n).astype(bool)
    keep = rng.integers(0, 2, n).astype(bool) if with_keep else None
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    got = TN.compact_rays_native(rays, valid, keep, rgb)
    want = JN.compact_rays_native(rays, valid, keep, rgb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sel = valid & (keep if keep is not None else True)
    np.testing.assert_array_equal(got[0], rays[sel])
    np.testing.assert_allclose(got[1], rgb[sel] / np.float32(255.0),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("cells", GRIDS)
def test_routers_equal_jax_native(cells):
    rnd = np.concatenate([_random_rays(np.random.default_rng(5), 6000, s)
                          for s in (0.3, 1.0, 3.0)])
    adv = _adversarial_rays(BOX, cells, n=400)
    ts = np.random.default_rng(1).uniform(0, 1, 16).astype(np.float32)
    for rays in (rnd, adv):
        np.testing.assert_array_equal(
            TN.route_rays_native(rays, BOX, cells, ts),
            JN.route_rays_native(rays, BOX, cells, ts))
    want = JN.dda_route_native(rnd, BOX, cells)
    assert (want >= 0).any() and (want < 0).any()
    for n_threads in (0, 1, 3):
        np.testing.assert_array_equal(
            TN.dda_route_native(rnd, BOX, cells, n_threads=n_threads), want)


@pytest.mark.parametrize("cells", [(3, 5, 7), (1, 5, 5)])
def test_dda_follows_the_spec_where_the_jax_native_does_not(cells):
    """The decided divergence: on rays starting on cell faces of a grid
    whose fractions are not dyadic, the JAX package's native filter
    disagrees with the numpy spec; the port's native router does not."""
    rays = _adversarial_rays(BOX, cells, seed=1, n=1000)
    spec = JT._dda_route_numpy(rays, BOX, cells)
    jax_native = JN.dda_route_native(rays, BOX, cells)
    np.testing.assert_array_equal(TN.dda_route_native(rays, BOX, cells),
                                  spec)
    off = jax_native != spec
    assert 0 < off.mean() < 0.05
    # where they disagree, one side filtered the ray as a weak overlap
    assert ((jax_native[off] < 0) | (spec[off] < 0)).all()


def test_ram_rays_dataset_equals_jax_native(tmp_path):
    """Per-image precompute through both packages' native paths: equal."""
    from PIL import Image

    from nerfsys_tpu.data.image_metadata import ImageMetadata as JM
    from nerfsys_tpu.data.ram_rays import RamRaysDataset as JD
    from nerfsys_tpu_torch.data.image_metadata import ImageMetadata as TM

    rng = np.random.default_rng(1)
    H, W = 12, 16
    jm, tm = [], []
    for i in range(3):
        p = tmp_path / f"{i:06d}.png"
        Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(p)
        intr, c2w = _random_cam(rng, H, W)
        jm.append(JM(p, c2w, W, H, intr, i))
        tm.append(TM(p, c2w, W, H, intr, i))
    aabb = np.array([[-2, -2, -2], [2, 2, 2]], np.float32)
    for nf in ((None, None), (0.3, 3.0)):
        want = JD(jm, scene_aabb=aabb, near_far_override=nf)
        got = TR.RamRaysDataset(tm, scene_aabb=aabb, near_far_override=nf)
        assert len(got) == len(want) > 0
        for k in ("rays", "rgbs", "img_indices"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        # the plain version of each image within test_native.py's
        # tolerances of the native one
        for md in tm:
            a = TR.process_single_image(md, True, False, aabb, nf)
            b = TR.process_single_image(md, True, False, aabb, nf,
                                        native=False)
            if a is None:  # the image keeps no valid ray on either path
                assert b is None
                continue
            assert a[0].shape == b[0].shape
            np.testing.assert_allclose(a[1][:, :6], b[1][:, :6], atol=1e-5)
            np.testing.assert_allclose(a[1][:, 6:], b[1][:, 6:], atol=1e-4,
                                       rtol=1e-5)
            np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a[2], b[2])


# --------------------------- port native vs port numpy ------------------------
@pytest.mark.parametrize("with_aabb", [True, False])
@pytest.mark.parametrize("with_clamp", [True, False])
def test_native_matches_numpy(with_aabb, with_clamp):
    """tests/test_native.py's case through the port's frame_rays."""
    rng = np.random.default_rng(3)
    H, W = 24, 32
    intr, c2w = _random_cam(rng, H, W)
    aabb = BOX if with_aabb else None
    near, far = (0.2, 5.0) if with_clamp else (None, None)
    rays_n, valid_n = TR.frame_rays(H, W, intr, c2w, aabb=aabb, near=near,
                                    far=far)
    rays_p, valid_p = TR.frame_rays(H, W, intr, c2w, aabb=aabb, near=near,
                                    far=far, native=False)
    np.testing.assert_array_equal(valid_n, valid_p)
    np.testing.assert_allclose(rays_n[:, :6], rays_p[:, :6], atol=1e-5)
    np.testing.assert_allclose(rays_n[valid_n, 6:], rays_p[valid_p, 6:],
                               atol=1e-4, rtol=1e-5)
    assert np.isinf(rays_n[~valid_n, 6:]).all()


@pytest.mark.parametrize("aabb_nf", [
    (True, (0.2, 5.0)),  # render_image: aabb + metric near/far overrides
    (True, (None, None)),  # video: aabb only (the bias comes after)
    (False, (0.05, 100.0)),  # no global aabb
])
def test_frame_rays_native_matches_numpy(aabb_nf):
    with_aabb, (near, far) = aabb_nf
    H, W = 20, 28
    intr, c2w = _random_cam(np.random.default_rng(11), H, W)
    c2w[:, 3] = 2.5 * c2w[:, 2]  # 2.5 back from the origin, facing it
    aabb = BOX if with_aabb else None
    rays_n, valid_n = TR.frame_rays(H, W, intr, c2w, aabb=aabb, near=near,
                                    far=far)
    rays_p, valid_p = TR.frame_rays(H, W, intr, c2w, aabb=aabb, near=near,
                                    far=far, native=False)
    np.testing.assert_array_equal(valid_n, valid_p)
    np.testing.assert_allclose(rays_n[:, :6], rays_p[:, :6], atol=1e-5)
    np.testing.assert_allclose(rays_n[valid_n, 6:], rays_p[valid_p, 6:],
                               atol=1e-4, rtol=1e-5)
    assert np.isinf(rays_n[~valid_n, 6:]).all()
    assert valid_n.any()


def test_sampled_router_native_matches_numpy():
    rays = _random_rays(np.random.default_rng(5), 5000)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    for cells in [(1, 5, 5)] + GRIDS:
        got = TT.route_rays_to_cells(rays, aabb, cells,
                                     rng=np.random.default_rng(0))
        want = TT.route_rays_to_cells(rays, aabb, cells,
                                      rng=np.random.default_rng(0),
                                      native=False)
        np.testing.assert_array_equal(got, want)
        assert (got[::17] == -1).all() and (got >= 0).mean() > 0.5
    # the rng's state advances the same on both paths (ts drawn first)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    TT.route_rays_to_cells(rays, aabb, (1, 5, 5), rng=r1)
    TT.route_rays_to_cells(rays, aabb, (1, 5, 5), rng=r2, native=False)
    assert r1.uniform() == r2.uniform()


@pytest.mark.parametrize("cells", GRIDS)
@pytest.mark.parametrize("box", ["cube", "slab"])
def test_dda_native_equals_numpy_on_adversarial_rays(cells, box):
    aabb = BOX if box == "cube" else np.array(
        [[0.2, -1.1, -1.1], [0.6, 1.1, 1.1]], np.float32)
    rays = _adversarial_rays(aabb, cells, seed=len(cells) + cells[1], n=1500)
    got = TT.route_rays_exact(rays, aabb, cells, policy="dda")
    want = TT.route_rays_exact(rays, aabb, cells, policy="dda",
                               native=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, JT._dda_route_numpy(rays, aabb, cells))
    assert (got >= 0).mean() > 0.2 and (got < 0).any()
    assert got.max() < int(np.prod(cells))


def test_route_rays_exact_policies_and_refusals():
    rays = _random_rays(np.random.default_rng(2), 2000)
    for policy in ("dda", "sampled", "alpha"):
        np.testing.assert_array_equal(
            TT.route_rays_exact(rays, BOX, (1, 5, 5), policy=policy),
            TT.route_rays_exact(rays, BOX, (1, 5, 5), policy=policy,
                                native=False))
    with pytest.raises(ValueError, match=r"\(N, 8\)"):
        TN.dda_route_native(rays[:, :6], BOX, (1, 5, 5))
    with pytest.raises(ValueError, match="aabb"):
        TN.route_rays_native(rays, BOX[0], (1, 5, 5), np.zeros(4))
    with pytest.raises(ValueError, match="cells"):
        TN.dda_route_native(rays, BOX, (0, 5, 5))


# --------------------------- the build ----------------------------------------
def test_two_processes_build_into_an_empty_directory(tmp_path):
    code = ("import sys\n"
            "from pathlib import Path\n"
            "import numpy as np\n"
            "from nerfsys_tpu_torch.data import native as n\n"
            "n.BUILD_DIR = Path(sys.argv[1])\n"
            "r, v = n.compute_rays_native(4, 4, (4, 4, 2, 2), np.eye(3, 4),"
            " near=0.1, far=2.0)\n"
            "assert v.all(), v\n"
            "print(n.lib_path())\n")
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [f.name for f in build.iterdir()] == [
        os.path.basename(paths.pop())]  # no temporary file left behind


def test_threads_share_one_build(tmp_path, monkeypatch):
    """More threads than cores reach the library first at once (as the
    dataset's thread pool does), with a short switch interval: one build,
    one loaded library, every frame equal."""
    import threading

    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TN, "_lib", None)
    intr, c2w = _random_cam(np.random.default_rng(4), 16, 16)
    n = 4 * (os.cpu_count() or 1) + 1
    out, libs = [None] * n, [None] * n
    start = threading.Barrier(n)

    def work(i):
        start.wait()
        out[i] = TN.compute_rays_native(16, 16, intr, c2w, aabb=BOX)
        libs[i] = TN.get_lib()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert all(lib is libs[0] for lib in libs) and libs[0] is not None
    for rays, valid in out:
        np.testing.assert_array_equal(rays, out[0][0])
        np.testing.assert_array_equal(valid, out[0][1])
    assert [f.name for f in tmp_path.iterdir()] == [TN.lib_path().name]


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_broken_compiler_raises(tmp_path, monkeypatch, cxx):
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TN, "CXX", cxx)
    monkeypatch.setattr(TN, "_lib", None)
    with pytest.raises(RuntimeError, match="not found|failed"):
        TN.get_lib()
    with pytest.raises(RuntimeError):
        TR.frame_rays(4, 4, (4, 4, 2, 2), np.eye(3, 4), near=0.1, far=2.0)
    with pytest.raises(RuntimeError):
        TT.route_rays_exact(_random_rays(np.random.default_rng(0), 10), BOX,
                            (1, 5, 5))
    assert TN._lib is None and list(tmp_path.iterdir()) == []
