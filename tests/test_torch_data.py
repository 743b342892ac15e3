"""Port parity of the episode data layer: the prepared-dataset reader, the
TaskDataset episode sampler, the MetaBatcher and the prefetch loader,
against the JAX package's numpy data layer on a prepared scene.

The scene is the COLMAP fixture of tests/test_dataprep_e2e.py (8 aerial
64x48 images, 2 for validation) through the JAX package's
`prepare_dataset` and `create_clusters` (a 2x2 grid, 4 experts). Under
the `numpy_reference` fixture both sides take their numpy ray and routing
paths: the JAX package's native library is switched off
(`native_available` patched to False) and the port's plain versions are
chosen with `native=False`. Without it both take their native paths,
which run the same C++ source under the same flags. Everything is
compared bit for bit: the same rays, the same routing, the same numpy
draws.
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_dataprep_e2e import colmap_scene  # noqa: F401  (fixture)

from nerfsys_tpu_torch.data import dataset as TD
from nerfsys_tpu_torch.data import loaders as TL
from nerfsys_tpu_torch.data import ram_rays as TR
from nerfsys_tpu_torch.data import task_dataset as TT
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

S, Q = 64, 32


def prepare_scene(colmap_root, data_root: Path) -> Path:
    """prepare_dataset + create_clusters (grid 2x2, margin 1.1) under
    <data_root>/out/scene, the runner's layout -> the scene dir."""
    from nerfsys_tpu.scripts import create_clusters, prepare_dataset

    out = data_root / "out" / "scene"
    prepare_dataset.main(SimpleNamespace(
        data_path=str(colmap_root), output_path=str(out), val_split=0.25,
        ecef_to_enu=False, enu_ref="mean", enu_ref_lat=None,
        enu_ref_lon=None, enu_ref_alt=None, scale_strategy="camera_max",
        points_low_alt_percentile=0.05, maximum_allowed_height=150.0,
        verify_enu_geodetic=False, yes=True))
    create_clusters.main(create_clusters.parse_args([
        "--data_path", str(out), "--output", "g22", "--grid_dim", "2", "2",
        "--ray_samples", "16"]))
    return out


@pytest.fixture(scope="module")
def scene(colmap_scene, tmp_path_factory):  # noqa: F811
    return prepare_scene(colmap_scene, tmp_path_factory.mktemp("drz"))


@pytest.fixture
def numpy_reference(monkeypatch):
    from functools import partial

    from nerfsys_tpu.data import native

    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(TR, "process_single_image",
                        partial(TR.process_single_image, native=False))
    monkeypatch.setattr(TT, "route_rays_exact",
                        partial(TT.route_rays_exact, native=False))


def _bundles(scene, **kw):
    from nerfsys_tpu.data import dataset as JD

    args = (scene, 1.0, "g22", 4)
    return JD.get_dataset(*args, **kw), TD.get_dataset(*args, **kw)


def _same_set(a, b):
    for k in ("rays", "rgbs", "img_indices"):
        want, got = getattr(a, k), getattr(b, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    assert a.unique_image_ids == b.unique_image_ids


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("near_far", [(0.0, 5000.0), (None, None)])
def test_get_dataset_matches_jax(scene, numpy_reference, near_far):
    jb, tb = _bundles(scene, near_far_override=near_far)
    assert len(tb.train_sets) == len(jb.train_sets) == 4
    assert tb.train_cells == [0, 1, 2, 3] and tb.val_cells == [0, 1, 2, 3]
    for a, b in zip(jb.train_sets + jb.val_sets, tb.train_sets + tb.val_sets):
        _same_set(a, b)
        assert len(b) > 0 and np.isfinite(b.rays).all()
    assert np.array_equal(tb.global_aabb, jb.global_aabb)
    assert np.array_equal(tb.expert_aabbs, jb.expert_aabbs)
    _same_tree(jb.clustering, tb.clustering)
    _same_tree(jb.coordinate_info, tb.coordinate_info)
    assert [m.image_path for m in tb.train_metadata] == [
        m.image_path for m in jb.train_metadata]
    for a, b in zip(jb.train_metadata, tb.train_metadata):
        assert np.array_equal(a.c2w, b.c2w)
        assert np.array_equal(a.intrinsics, b.intrinsics)
        assert (a.W, a.H, a.image_index) == (b.W, b.H, b.image_index)


def test_native_dataset_and_routing_match_jax_native(scene):
    """Both packages on their default native paths: the same bundles and
    the same DDA-routed task pools, bit for bit."""
    jb, tb = _bundles(scene, near_far_override=(0.0, 5000.0))
    for a, b in zip(jb.train_sets + jb.val_sets, tb.train_sets + tb.val_sets):
        _same_set(a, b)
    jts, tts = _task_pairs(scene)
    for j, t in zip(jts, tts):
        assert t.eligible_cells == j.eligible_cells and len(t) > 0
        for a, b in zip(j._cell_flat_idx, t._cell_flat_idx):
            assert np.array_equal(a, b)
        _same_task(j.sample_task(), t.sample_task())


def test_downscale_cap_and_val_balancing_match_jax(scene, numpy_reference):
    """LANCZOS-resized pixels, nearest-resized masks, the even cap and the
    Mega-NeRF val balancing."""
    jb, tb = _bundles(scene, cap_images=3)
    for a, b in zip(jb.train_sets, tb.train_sets):
        _same_set(a, b)
    from nerfsys_tpu.data import dataset as JD

    args = (scene, 0.5, "g22", 4)
    kw = dict(cap_images=4, val_balancing=True)
    jb, tb = JD.get_dataset(*args, **kw), TD.get_dataset(*args, **kw)
    assert tb.train_metadata[0].W == 32
    for a, b in zip(jb.train_sets + jb.val_sets, tb.train_sets + tb.val_sets):
        _same_set(a, b)


def test_flat_layout_and_expert_count_mismatch(scene, tmp_path):
    train, val = TD.get_image_metadata(scene, 1.0)
    assert len(train) == 6 and len(val) == 2
    assert sorted(m.image_index for m in train + val) == list(range(8))
    flat = tmp_path / "flat"
    (flat / "metadata").mkdir(parents=True)
    (flat / "rgbs").mkdir()
    for p in sorted((scene / "val" / "metadata").glob("*.pt")):
        (flat / "metadata" / p.name).write_bytes(p.read_bytes())
        img = next((scene / "val" / "rgbs").glob(p.stem + ".*"))
        (flat / "rgbs" / img.name).write_bytes(img.read_bytes())
    tr, va = TD.get_image_metadata(flat, 1.0)
    assert tr == [] and len(va) == 2 and all(m.is_val for m in va)
    assert TD.cap_metadata(train, 2) == [train[0], train[-1]]
    with pytest.raises(ValueError, match="num_submodules=3"):
        TD.get_dataset(scene, 1.0, "g22", 3)


def test_zipped_mask_and_val_balancing(scene):
    md = TD.get_image_metadata(scene, 1.0, scene / "masks" / "g22" / "0")[0][0]
    m = md.load_mask()
    assert m.shape == (md.H, md.W) and m.dtype == bool and 0 < m.sum()
    from nerfsys_tpu.data.ram_rays import apply_meganerf_val_balancing as J

    for seed in range(3):
        want = J(m, np.random.default_rng(seed))
        got = TR.apply_meganerf_val_balancing(m, np.random.default_rng(seed))
        assert np.array_equal(got, want)
        assert not got[:, md.W // 2:].any()


def _task_pairs(scene, **kw):
    from nerfsys_tpu.data import dataset as JD
    from nerfsys_tpu.data import task_dataset as JT

    jb = JD.get_dataset(scene, 1.0, "g22", 4, near_far_override=(0.0, 5e3))
    tb = TD.get_dataset(scene, 1.0, "g22", 4, near_far_override=(0.0, 5e3))
    kw = dict(region_aabb=None, support_rays=S, query_rays=Q, cell_dim=5,
              **kw)
    return ([JT.TaskDataset(ds, seed=3 + i, **kw)
             for i, ds in enumerate(jb.train_sets)],
            [TT.TaskDataset(ds, seed=3 + i, **kw)
             for i, ds in enumerate(tb.train_sets)])


def _same_task(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for split in ("support", "query"):
        for k in ("rays", "rgbs", "img_indices", "idx"):
            assert np.array_equal(getattr(a, split)[k], getattr(b, split)[k])
    assert a.block_id == b.block_id and a.metrics == b.metrics
    assert np.array_equal(a.bounds, b.bounds) and a.warnings == b.warnings


@pytest.mark.parametrize("policy", ["dda", "alpha", "sampled"])
def test_task_dataset_matches_jax(scene, numpy_reference, policy):
    jts, tts = _task_pairs(scene, routing_policy=policy)
    for j, t in zip(jts, tts):
        assert t.eligible_cells == j.eligible_cells and len(t) > 0
        assert t.routing_hit_rate == j.routing_hit_rate
        assert np.array_equal(t.aabb, j.aabb)
        assert np.array_equal(t.cell_bounds, j.cell_bounds)
        for a, b in zip(j._cell_flat_idx, t._cell_flat_idx):
            assert np.array_equal(a, b)
        for _ in range(5):
            _same_task(j.sample_task(), t.sample_task())


def test_task_dataset_single_pool_fallback_matches_jax(scene,
                                                       numpy_reference):
    with pytest.warns(UserWarning, match="no eligible cells"):
        jts, tts = _task_pairs(scene, min_rays_per_cell=10**9,
                               cell_pick="sequential", image_cap=None)
    for j, t in zip(jts, tts):
        assert t.eligible_cells == [0] == j.eligible_cells
        assert t.cell_bounds.shape == (1, 2, 3)
        assert np.array_equal(t.cell_bounds[0], t.aabb)
        for _ in range(3):
            _same_task(j.sample_task(), t.sample_task())


@pytest.mark.parametrize("kind,n", [("dda", 4000), ("alpha", 4000),
                                    ("sampled", 4000)])
def test_routers_match_jax_on_random_rays(numpy_reference, kind, n):
    """Routers on rays from everywhere: inside and outside the box,
    parallel to its faces, with near past far."""
    from nerfsys_tpu.data import task_dataset as JT

    rng = np.random.default_rng(11)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 8, 1] = 0.0  # parallel to a pair of faces
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nf = np.sort(rng.uniform(0, 4, (n, 2)), axis=1).astype(np.float32)
    nf[-10:] = nf[-10:, ::-1]  # near past far
    rays = np.concatenate([o, d, nf], 1).astype(np.float32)
    aabb = np.array([[-1, -1, -1], [1, 1.5, 1]], np.float32)
    got = TT.route_rays_exact(rays, aabb, (1, 5, 5), policy=kind)
    want = JT.route_rays_exact(rays, aabb, (1, 5, 5), policy=kind)
    assert np.array_equal(got, want)
    assert (got >= 0).mean() > 0.05 and (got < 0).any()
    with pytest.raises(ValueError, match="routing policy"):
        TT.route_rays_exact(rays, aabb, (1, 5, 5), policy="nope")


def test_meta_batcher_matches_jax_for_20_batches(scene, numpy_reference):
    """20 successive batches equal, with a region that yields no task (its
    padded rows: zeros, near 1 > far 0, valid 0)."""
    from nerfsys_tpu.data import loaders as JL

    jts, tts = _task_pairs(scene)
    for tds in (jts, tts):  # region 2 yields nothing (an empty pool)
        tds[2].eligible_cells = []
    jb, tb = JL.MetaBatcher(jts, 2), TL.MetaBatcher(tts, 2)
    assert (tb.K, tb.B, tb.S, tb.Q) == (4, 2, S, Q)
    for _ in range(20):
        want, got = jb.next_batch(), tb.next_batch()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert np.array_equal(got[k], want[k]), k
    assert got["valid"][2].sum() == 0 and got["valid"].sum() == 6
    assert (got["support_rays"][2, :, :, 6] == 1.0).all()
    assert (got["support_rays"][2, :, :, 7] == 0.0).all()
    assert not got["query_rgbs"][2].any()


class _Failing:
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield {"x": np.full((2, 3), i, np.float32)}
        raise RuntimeError("sampler broke")


def test_prefetch_loader_uploads_passes_errors_and_closes():
    loader = TL.PrefetchLoader(_Failing(3), device="cpu", prefetch=2)
    for i in range(3):
        batch = next(loader)
        assert isinstance(batch["x"], torch.Tensor)
        assert batch["x"].device.type == "cpu" and float(batch["x"][0, 0]) == i
    with pytest.raises(RuntimeError, match="sampler broke"):
        next(loader)

    def endless():
        i = 0
        while True:
            yield {"x": np.full(1, i)}
            i += 1

    loader = TL.PrefetchLoader(endless(), device="cpu", prefetch=1)
    assert int(next(loader)["x"][0]) == 0
    loader.close()
    loader._thread.join(timeout=10)
    assert not loader._thread.is_alive()
