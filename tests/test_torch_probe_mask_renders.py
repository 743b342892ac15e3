"""Port parity of `occ_probe_mask` (the hard mask from the probes'
interval bits) in the renderers, against the JAX package on the CPU, on
the same numpy params, grids and rays: `render_rays_chunked` through the
two-wave renderer (skipped and packed chunks) and the hard early-stop
renderer (tests/test_torch_early_stop.py's world: expert 0's finest level
60% occupied), the coherent renderer (tests/test_torch_coherent.py's
hash experts and mixed rays) and the live camera renderer with the union
probe grid (tests/test_torch_camera_render.py's; without it there), each
within 1e-5 (the camera under its flip rule, as there), the JAX side with
jit disabled. The probe-bit renders are never darker than the
point-exact ones.
"""
import jax
import numpy as np
import pytest
from test_torch_camera_render import FLIP_SHARE, _pair
from test_torch_camera_render import _close as _close_flip
from test_torch_coherent import CHUNK as COH_CHUNK
from test_torch_coherent import _mixed_rays
from test_torch_coherent import _setup as _coherent_setup
from test_torch_early_stop import _layout, _world

from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("kind,layout", [
    ("two_wave", "skip"), ("two_wave", "pack"),
    ("early_stop_hard", "skip"), ("early_stop_hard", "pack")])
def test_chunked_render_with_probe_masks_matches_jax(kind, layout):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _world()
    rays = _layout(np.random.default_rng(5), layout)
    kw = dict(ray_samples=12, occ_importance=True, occ_probe_mask=True)
    if kind != "two_wave":
        kw.update(early_stop_eps=1e-6, early_stop_seg=3)
    tren = TR.make_chunk_renderer(tcfg, occ_state=tocc, device="cpu", **kw)
    jren = JR.make_chunk_renderer(cfg, occ_state=jocc, **kw)
    assert type(tren).__name__ == type(jren).__name__
    t_stats, j_stats = {}, {}
    got = TR.render_rays_chunked(tren, tp, tst, rays, 64, stats=t_stats)
    with jax.disable_jit():
        want = JR.render_rays_chunked(jren, jp, jst, rays, 64, stats=j_stats)
    _close(got, want, 1e-5)
    assert t_stats == j_stats
    point = TR.render_rays_chunked(
        TR.make_chunk_renderer(tcfg, occ_state=tocc, device="cpu",
                               **dict(kw, occ_probe_mask=False)),
        tp, tst, rays, 64)
    assert (got[:, 4] >= point[:, 4] - 1e-6).all()  # never darker


def test_coherent_renderer_with_probe_masks_matches_jax():
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _coherent_setup()
    rays = _mixed_rays(np.random.default_rng(0), 300)
    kw = dict(ray_samples=8, occ_importance=True, occ_hard_mask=True,
              occ_probe_mask=True)
    jren = JR.make_coherent_renderer(cfg, occ_state=jocc, **kw)
    tren = TR.make_coherent_renderer(tcfg, occ_state=tocc, device="cpu",
                                     **kw)
    t_stats, j_stats = {}, {}
    got = TR.render_rays_chunked(tren, tp, tst, rays, COH_CHUNK,
                                 stats=t_stats)
    with jax.disable_jit():
        want = JR.render_rays_chunked(jren, jp, jst, rays, COH_CHUNK,
                                      stats=j_stats)
    _close(got, want, 1e-5)
    assert t_stats == j_stats and t_stats["n_coherent"] > 0
    # exact by construction: the full routed program on every ray
    full = TR.render_rays_chunked(tren.full, tp, tst, rays, COH_CHUNK)
    _close(got, full, 1e-6)


def test_camera_renderer_with_probe_masks_matches_jax():
    """With the union probe grid, whose bits then mask (the exact probe:
    tests/test_torch_camera_render.py)."""
    want, got = _pair(out_u8=False, occ=True, occ_importance=True,
                      occ_hard_mask=True, occ_probe_mask=True,
                      occ_probe_grid_res=16)
    _close_flip(got, want, flip_share=FLIP_SHARE)
