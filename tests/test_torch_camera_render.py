"""Port parity of the live camera renderer (`make_live_camera_renderer`):
pose in, frame out, rays generated on the device chunk by chunk.

The cases of tests/test_camera_render.py, each against the JAX package's
renderer on the CPU: stratified (float planes and the uint8 frame), soft
occupancy with importance, the video path's near bias, invalid_black, fog
statistics with a map_outputs transform, the union probe grid, and the
hard mask. The port's camera renderer is also held to its own
`render_image` on the same pose.

Params (K=2 experts, planes L=2 base 8 F=4, hidden 8) and the occupancy
grids (R=8, L=2, the bottom 35% of every level box alive, so the top of
the scene is dead) come from numpy seeds (tests/test_torch_baked.py's
`_setup`). The JAX renderer jits its chunk program, and jitted XLA on the
CPU contracts multiply-adds, so it runs under `jax.disable_jit()`: both
sides then do the same float operations.

Tolerances. 1e-5 on every float plane where both sides generate the same
rays (the pixel arithmetic, a 3x3 product and a norm summed in another
order: rays within 1e-6); the uint8 frame within 1 level (the tonemap
truncates). Where a sample may lie an ulp from a cell wall of the hard
mask (hard mask; the port's camera rays against `render_image`'s numpy
rays) a ray can gain or lose a whole sample's sigma: the flip rule of
chip_smoke's `chunk_matches_plain` then allows at most 0.5% of the pixels
beyond the tolerance (1 of 256; 0 read in both such tests).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import occupancy as JMO
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from test_torch_baked import GBOX, _camera, _setup

SIDE = 16
CHUNK = 100  # several chunks and a padded tail (256 = 2 x 100 + 56)
TOL = 1e-5
FLIP_SHARE = 0.005


def _pair(**kw):
    """(JAX's frame, the port's frame) for the same pose and arguments;
    `occ` in kw is replaced by each side's grid."""
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup()
    c2w, intr = kw.pop("camera", _camera(SIDE))
    extra = kw.pop("extra", ())
    use_occ = kw.pop("occ", False)
    base = dict(H=SIDE, W=SIDE, ray_samples=8, chunk_rays=CHUNK,
                scene_aabb=GBOX)
    jkw, tkw = dict(base, **kw), dict(base, **kw)
    jmap, tmap = jkw.pop("jax_map", None), tkw.pop("jax_map", None)
    tkw.pop("torch_map", None)
    jkw.pop("torch_map", None)
    if jmap is not None:
        jkw["map_outputs"], tkw["map_outputs"] = jmap, kw["torch_map"]
    if use_occ:
        jkw["occ_state"], tkw["occ_state"] = jocc, tocc
    with jax.disable_jit():
        want = JR.make_live_camera_renderer(cfg, **jkw)(jp, jst, c2w, intr,
                                                        *extra)
    got = TR.make_live_camera_renderer(tcfg, device="cpu", **tkw)(
        tp, tst, c2w, intr, *extra)
    return np.asarray(want), got


def _close(got, want, tol=TOL, flip_share=0.0):
    """Per pixel: every column within tol, except at most flip_share of
    the pixels."""
    assert got.shape == want.shape
    g = got.reshape(got.shape[0] if got.ndim == 2 else -1, -1)
    w = want.reshape(g.shape)
    bad = (np.abs(g.astype(np.float64) - w) > tol).any(axis=1)
    assert bad.sum() <= flip_share * bad.size, (
        int(bad.sum()), float(np.abs(g - w).max()))


def test_stratified_float_planes_and_u8():
    want, got = _pair(out_u8=False)
    assert got.shape == (SIDE * SIDE, 5) and got.dtype == np.float32
    _close(got, want)
    want8, got8 = _pair()
    assert got8.dtype == np.uint8 and got8.shape == (SIDE, SIDE, 3)
    diff = np.abs(got8.astype(np.int16) - want8.astype(np.int16))
    assert diff.max() <= 1
    assert 20 < got8.mean() < 250


def test_soft_occupancy_with_importance():
    want, got = _pair(out_u8=False, occ=True, occ_importance=True,
                      occ_hard_mask=False)
    _close(got, want)


def test_near_bias_matches_jax():
    want, got = _pair(out_u8=False, near_bias=0.3, use_bg_fn=False)
    _close(got, want)
    base, _ = _pair(out_u8=False, use_bg_fn=False)
    assert not np.allclose(want, base)  # the bias moved the samples


def test_invalid_black_matches_jax():
    c2w = np.array([[1, 0, 0, 4.5], [0, 1, 0, 0], [0, 0, 1, 4.0]],
                   np.float32)
    intr = np.array([SIDE * 0.4, SIDE * 0.4, SIDE / 2, SIDE / 2], np.float32)
    want, got = _pair(out_u8=False, invalid_black=True, camera=(c2w, intr))
    _close(got, want)
    black = (got == 0.0).all(axis=1)
    assert 0 < black.sum() < black.size  # box misses and hits both


def test_fog_stats_and_map_outputs():
    want, got = _pair(out_u8=False, fog_stats=True, occ=True,
                      occ_importance=True, occ_hard_mask=False,
                      use_bg_fn=False)
    assert got.shape == (SIDE * SIDE, 7)
    _close(got, want)

    def jmap(rgb, depth, acc, wmax, entropy, gain):
        return (jnp.clip(rgb * gain, 0, 1) * 255.0 + 0.5).astype(jnp.uint8)

    def tmap(rgb, depth, acc, wmax, entropy, gain):
        return (torch.clamp(rgb * gain, 0, 1) * 255.0 + 0.5).to(torch.uint8)

    want, got = _pair(fog_stats=True, occ=True, occ_importance=True,
                      occ_hard_mask=False, use_bg_fn=False, jax_map=jmap,
                      torch_map=tmap, extra=(np.float32(2.0),))
    assert got.shape == (SIDE, SIDE, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_union_probe_grid_matches_jax():
    kw = dict(out_u8=False, occ=True, occ_importance=True,
              occ_hard_mask=False)
    want, got = _pair(occ_probe_grid_res=8, **kw)
    _close(got, want)
    _, exact = _pair(**kw)
    assert not np.allclose(got, exact, rtol=1e-6, atol=1e-7)


def test_union_probe_grid_ignored_with_an_active_expert(capsys):
    want, got = _pair(out_u8=False, occ=True, occ_hard_mask=False,
                      occ_probe_grid_res=8, active_expert=1)
    assert "ignored" in capsys.readouterr().out
    _close(got, want)


def test_hard_mask_matches_jax():
    want, got = _pair(out_u8=False, occ=True, occ_importance=True,
                      occ_hard_mask=True)
    _close(got, want, flip_share=FLIP_SHARE)
    _, soft = _pair(out_u8=False, occ=True, occ_importance=True,
                    occ_hard_mask=False)
    assert not np.allclose(got, soft, atol=1e-3)  # the mask zeroed sigma


@pytest.mark.parametrize("mode", ["stratified", "soft", "hard"])
def test_camera_renderer_matches_render_image(mode):
    """The same pose through the port's render_image (numpy rays on the
    host, the chunk renderer of the same mode; the two-wave dispatcher in
    hard mode) and through the camera renderer."""
    _, tcfg, _, (tp, tst, tocc) = _setup()
    c2w, intr = _camera(SIDE)
    kw = {} if mode == "stratified" else dict(
        occ_state=tocc, occ_importance=True, occ_hard_mask=mode == "hard")
    ren = TR.make_chunk_renderer(tcfg, ray_samples=8, device="cpu", **kw)
    md = SimpleNamespace(H=SIDE, W=SIDE, c2w=c2w, intrinsics=intr)
    rgb, depth, acc = TR.render_image(ren, tp, tst, md, scene_aabb=GBOX,
                                      chunk_rays=CHUNK)
    want = np.concatenate([rgb.reshape(-1, 3), depth.reshape(-1, 1),
                           acc.reshape(-1, 1)], 1)
    got = TR.make_live_camera_renderer(
        tcfg, H=SIDE, W=SIDE, ray_samples=8, chunk_rays=CHUNK,
        scene_aabb=GBOX, out_u8=False, device="cpu", **kw)(tp, tst, c2w,
                                                           intr)
    _close(got, want, flip_share=FLIP_SHARE if mode == "hard" else 0.0)


def test_probe_masks_match_jax_and_the_card_is_the_default():
    """The hard mask from the probes' interval bits against JAX's; its acc
    is never below the point-masked frame's (interval masking keeps every
    sample of an occupied probe interval)."""
    want, got = _pair(out_u8=False, occ=True, occ_importance=True,
                      occ_hard_mask=True, occ_probe_mask=True)
    _close(got, want, flip_share=FLIP_SHARE)
    _, point = _pair(out_u8=False, occ=True, occ_importance=True,
                     occ_hard_mask=True)
    assert (got[:, 4] >= point[:, 4] - 1e-6).all()
    _, tcfg, _, _ = _setup()
    with pytest.raises(ValueError):
        TR.make_live_camera_renderer(tcfg, H=4, W=4, ray_samples=4,
                                     device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError):
        TR.make_live_camera_renderer(tcfg, H=4, W=4, ray_samples=4,
                                     scene_aabb=GBOX)


def test_union_probe_fns_reference_is_the_grid_the_port_builds():
    """The union grid both camera renderers probe: the port's
    build_union_probe_grid equals JAX's (occupancy bits and values)."""
    from nerfsys_tpu_torch.models import occupancy as TMO

    _, _, (_, jst, jocc), (_, tst, tocc) = _setup()
    with jax.disable_jit():
        want = JMO.build_union_probe_grid(jocc, jst, res=8, importance=True)
    got = TMO.build_union_probe_grid(tocc, tst, res=8, importance=True)
    for key in ("binary", "values", "aabb"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
