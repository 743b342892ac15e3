"""Port parity of the video op (nerfsys_tpu_torch/pipelines/video_gen.py).

The pose builders, every path generator and `PATH_GENERATORS` entry are
numpy float32 on both sides and must be equal bit for bit; so must
`suppress_fog`. `render_video` runs against the JAX package's on the
tiny container of tests/test_scripts_and_video.py's
`test_video_uses_test_metadata_intrinsics` (K=2 hash experts L=2, hidden
16, a 20x12 test camera, 2 turntable frames, 4 samples), with the JAX
weights carried across by `utils.interop`, through each of the four
renderer branches, fog suppression on in one case of each and off in the
other: the live camera renderer (the pose path) stratified and with soft
occupancy; the chunk renderer over host rays, stratified (early stop is
ignored without a grid) and through the hard-mask two-wave dispatch over a
random ready grid; the baked snapshot (8³, SH-2) through the baked camera
renderer (the pose path) and, with early stop asked for, through the
baked chunk renderer over host rays, baked over the grid
(--render_baked_occ); the coherent-expert renderer over host rays without
a grid and with the hard mask; the hard-mask two-wave renderer again
with --occ_probe_mask (the probes' interval bits).
The JAX side runs jitted, as its video op serves: XLA on the CPU then
contracts multiply-adds, which can move a sample into another cell, and
the sRGB tail truncates, so a float32 ulp can cross an integer level.
Frames must have the same shape and writer layout (here: no mp4 encoder,
so the PNG sequence on both sides), and be uint8 within 1 level on all
but 0.5% of the pixels (0 pixels differ at all on these cases).

The runner's `--op video` end to end: tests/test_torch_video_runner.py.
"""
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops.encodings import HashGridConfig
from nerfsys_tpu.pipelines import video_gen as JV
from nerfsys_tpu.utils import config as JC
from nerfsys_tpu_torch.data.image_metadata import ImageMetadata as TM
from nerfsys_tpu_torch.pipelines import video_gen as TV
from nerfsys_tpu_torch.utils import config as TC
from nerfsys_tpu_torch.utils import interop

U8_SHARE = 0.005  # pixels allowed more than 1 level apart


# --------------------------- poses and fog ------------------------------------
CENTERS = [np.zeros(3, np.float32), np.array([0.4, -0.3, 1.7], np.float32)]
EXTENTS = [np.array([0.5, 2.0, 2.0], np.float32),
           np.array([0.4, 2.2, 2.2], np.float32),
           np.array([1.3, 0.7, 3.1], np.float32)]


@pytest.mark.parametrize("name", list(JV.PATH_GENERATORS))
@pytest.mark.parametrize("n", [1, 7, 24])
def test_path_generators_equal_jax(name, n):
    assert list(TV.PATH_GENERATORS) == list(JV.PATH_GENERATORS)
    for c in CENTERS:
        for e in EXTENTS:
            want = JV.PATH_GENERATORS[name](c, e, n)
            got = TV.PATH_GENERATORS[name](c, e, n)
            assert got.dtype == want.dtype and got.shape == (n, 4, 4)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(phi_deg=45.0), dict(phi_deg=5.0), dict(phi_deg=30.0, tilt_deg=12.0),
    dict(phi_deg=20.0, tilt_deg=-7.5)])
def test_turntable_and_pose_builders_equal_jax(kw):
    for c in CENTERS:
        for r in (0.12, 0.9, 3.0):
            np.testing.assert_array_equal(
                TV.poses_turntable_drb(c, r, n_poses=9, **kw),
                JV.poses_turntable_drb(c, r, n_poses=9, **kw))
    rng = np.random.default_rng(0)
    for _ in range(20):
        cam = rng.normal(size=3).astype(np.float32)
        ctr = rng.normal(size=3).astype(np.float32)
        for fn in ("rub_pose_from_pos", "rub_pose_look_same_D"):
            np.testing.assert_array_equal(getattr(TV, fn)(ctr, cam),
                                          getattr(JV, fn)(ctr, cam))
        np.testing.assert_array_equal(TV.rub_pose_from_fwd(cam, ctr),
                                      JV.rub_pose_from_fwd(cam, ctr))
    np.testing.assert_array_equal(
        TV.gen_path_full_coverage(np.zeros(3), np.ones(3), 7, rows=2,
                                  cols=2),
        JV.gen_path_full_coverage(np.zeros(3), np.ones(3), 7, rows=2,
                                  cols=2))


@pytest.mark.parametrize("precomputed", [False, True])
def test_suppress_fog_equals_jax(precomputed):
    rng = np.random.default_rng(1)
    n, s = 512, 16
    w = rng.uniform(0, 1, (n, s)).astype(np.float32) ** 4
    w *= rng.uniform(0, 0.3, (n, 1)).astype(np.float32)
    w[:8] = 0.0
    w[8:16, 0] = 0.9  # solid pixels
    acc = w.sum(1)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    kw = dict(entropy_thr=1.4)
    if precomputed:
        p = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
        ent = -(p * np.log(np.maximum(p, 1e-12))).sum(1)
        kw["wmax_entropy"] = (w.max(1), ent)
    got, gs = TV.suppress_fog(rgb, None if precomputed else w, acc, 1.0,
                              **kw)
    want, ws = JV.suppress_fog(rgb, None if precomputed else w, acc, 1.0,
                               **kw)
    np.testing.assert_array_equal(got, want)
    assert gs == ws and 0 < gs["pct_fog"] < 1 and gs["pct_low"] > 0
    assert not np.array_equal(got, rgb)


# --------------------------- render_video -------------------------------------
def _tiny():
    """The JAX side's (cfg, statics, params) and the port's, the tiny
    container of test_video_uses_test_metadata_intrinsics."""
    cfg = JCo.ContainerConfig(
        num_experts=2,
        expert=JN.NGPConfig(hidden=16, sigma_depth=1, color_hidden=16,
                            color_depth=1, geo_feat_dim=7,
                            hash=HashGridConfig(levels=2, min_res=4,
                                                max_res=8,
                                                log2_hashmap_size=8)),
        bg_hidden=8,
    )
    cents = np.array([[0.0, -0.5, 0.0], [0.0, 0.5, 0.0]], np.float32)
    boxes = np.stack([np.stack([c - 1.0, c + 1.0]) for c in cents])
    gbox = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
    statics = JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                                   jnp.asarray(gbox))
    params = JCo.init_container_params(jax.random.PRNGKey(0), cfg)
    port = (interop.container_config_from_jax(cfg),
            interop.statics_from_jax(SimpleNamespace(
                centroids=cents, expert_aabbs=boxes, global_aabb=gbox),
                "cpu"),
            interop.container_params_from_jax(
                jax.tree_util.tree_map(np.asarray, params), "cpu"))
    return (cfg, statics, params), port


def _occ(seed=3):
    """A ready K=2 R=8 L=2 grid, about half of its cells occupied."""
    rng = np.random.default_rng(seed)
    binary = rng.uniform(size=(2, 2, 8, 8, 8)) < 0.5
    return {"occs": np.where(binary, rng.uniform(0.02, 0.5, binary.shape),
                             0.0).astype(np.float32),
            "binary": binary, "num_updates": np.int32(10),
            "ready_after": np.int32(1)}


def _frames(out):
    """The frames a render_video call wrote, and the layout relative to
    its run directory."""
    out = Path(out)
    run = out.parent
    layout = sorted(str(p.relative_to(run)) for p in run.rglob("*")
                    if p.relative_to(run).parts[0].startswith("video_"))
    if out.is_dir():
        from PIL import Image as PILImage

        return [np.asarray(PILImage.open(p))
                for p in sorted(out.glob("*.png"))], layout
    import imageio.v3 as iio

    v = iio.imread(out)
    return [v[i] for i in range(v.shape[0])], layout


def _u8_close(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        diff = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
        assert (diff > 1).mean() <= U8_SHARE, (int(diff.max()),
                                               float((diff > 1).mean()))


BAKED = ["--render_baked", "8", "--render_baked_sh", "2"]
# mode -> (flags, with a ready grid, the renderer the port builds)
MODES = {
    "pose": ([], False, "live camera"),
    "pose_soft_occ": (["--occ_no_hard_mask", "--occ_importance"], True,
                      "live camera"),
    "host_early_stop": (["--render_early_stop", "1e-9"], False, "chunk"),
    "host_hard_occ": ([], True, "chunk"),
    "baked_pose": (BAKED, False, "baked camera"),
    "baked_host": (BAKED + ["--render_baked_occ", "--render_early_stop",
                            "1e-9"], True, "baked chunk"),
    "coherent": (["--render_coherent"], False, "coherent"),
    "coherent_hard_occ": (["--render_coherent"], True, "coherent"),
    "host_hard_occ_probe": (["--occ_probe_mask"], True, "chunk"),
}


@pytest.mark.parametrize("mode,fog", [
    ("pose", True), ("pose_soft_occ", False), ("host_early_stop", False),
    ("host_hard_occ", True), ("baked_pose", True), ("baked_host", False),
    ("coherent", True), ("coherent_hard_occ", False),
    ("host_hard_occ_probe", True)])
def test_render_video_matches_jax(tmp_path, mode, fog, monkeypatch):
    import nerfsys_tpu_torch.pipelines.video_gen as tv

    flags, with_occ, factory = MODES[mode]
    argv = ["--op", "video", "--data_path", str(tmp_path),
            "--camera_path", "turntable", "--video_frames", "2",
            "--video_width", "64", "--video_height", "48",  # ignored
            "--ray_samples", "4"] + flags + (
                [] if fog else ["--no_suppress_fog"])
    (jcfg, jst, jp), (tcfg, tst, tp) = _tiny()
    md = dict(image_path=tmp_path / "none.jpg",
              c2w=np.eye(3, 4, dtype=np.float32), W=20, H=12,
              intrinsics=np.array([15.0, 15.0, 10.0, 6.0], np.float32),
              image_index=0)
    from nerfsys_tpu.data.image_metadata import ImageMetadata as JM

    jctx = {"P": JC.parse_args(argv), "cfg": jcfg, "statics": jst,
            "params": jp, "run_dir": tmp_path / "jax",
            "test_metadata": [JM(**md)]}
    tctx = {"P": TC.parse_args(argv + ["--device", "cpu"]), "cfg": tcfg,
            "statics": tst, "params": tp, "run_dir": tmp_path / "port",
            "test_metadata": [TM(**md)]}
    if with_occ:
        occ = _occ()
        jctx["occ_state"] = {k: jnp.asarray(v) for k, v in occ.items()}
        tctx["occ_state"] = interop.occ_state_from_jax(occ, "cpu")
    # which renderer the port builds, and whether it takes host rays
    built, seen = [], []
    for module, attr, name in (
            (tv, "make_live_camera_renderer", "live camera"),
            (tv, "make_chunk_renderer", "chunk"),
            (tv, "make_coherent_renderer", "coherent"),
            (tv.baked_mod, "make_baked_camera_renderer", "baked camera"),
            (tv.baked_mod, "make_baked_chunk_renderer", "baked chunk")):
        fn = getattr(module, attr)
        monkeypatch.setattr(module, attr,
                            lambda *a, _f=fn, _n=name, **k:
                            built.append(_n) or _f(*a, **k))
    orig = tv.frame_rays
    monkeypatch.setattr(tv, "frame_rays",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    want, want_layout = _frames(JV.render_video(jctx))
    got, got_layout = _frames(TV.render_video(tctx))
    assert built == [factory]
    assert got_layout == want_layout
    assert [f.shape for f in got] == [(12, 20, 3)] * 2
    assert len(seen) == (0 if "camera" in factory else 2)
    _u8_close(got, want)
    assert any(len(np.unique(f)) > 1 for f in got)


def test_render_video_bakes_and_renders_probe_masks(tmp_path):
    """The baked pose path writes frames of the test camera's size through
    the snapshot (a cache written on the first run loads on the second);
    with probe-bit masks and no grid the stratified renderer serves (the
    flag has nothing to mask), as the reference's does."""
    (jcfg, jst, jp), (tcfg, tst, tp) = _tiny()
    cache = tmp_path / "snap.npz"
    argv = ["--op", "video", "--data_path", str(tmp_path),
            "--camera_path", "east_west", "--video_frames", "2",
            "--video_width", "24", "--video_height", "16",
            "--ray_samples", "4", "--render_baked", "8",
            "--render_baked_sh", "2", "--render_baked_cache", str(cache),
            "--device", "cpu"]
    runs = []
    for i in range(2):
        out = TV.render_video({"P": TC.parse_args(argv), "cfg": tcfg,
                               "statics": tst, "params": tp,
                               "run_dir": tmp_path / f"run{i}"})
        runs.append(_frames(out)[0])
        assert cache.exists()
    assert [f.shape for f in runs[0]] == [(16, 24, 3)] * 2
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    probe = ["--op", "video", "--data_path", str(tmp_path),
             "--video_frames", "1", "--video_width", "24",
             "--video_height", "16", "--ray_samples", "4",
             "--occ_probe_mask"]
    got, _ = _frames(TV.render_video({
        "P": TC.parse_args(probe + ["--device", "cpu"]), "cfg": tcfg,
        "statics": tst, "params": tp, "run_dir": tmp_path / "probe"}))
    want, _ = _frames(JV.render_video({
        "P": JC.parse_args(probe), "cfg": jcfg, "statics": jst,
        "params": jp, "run_dir": tmp_path / "probe_jax"}))
    assert [f.shape for f in got] == [(16, 24, 3)]
    _u8_close(got, want)
