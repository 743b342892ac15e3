"""Port parity: hard-mask two-wave rendering and early ray termination.

The JAX package and the port get the same numpy params, grids and rays (the
planes configuration of tests/test_torch_render_occ.py: K=2 experts,
planes L=2 base 8 F=4, occupancy R=16 L=2). The occupancy here marks only
expert 0's finest level, so rays aimed at expert 1's box are dead. The JAX
side runs eagerly (`jax.disable_jit()`): jitted XLA on the CPU fuses
multiply-adds and can move a probe point into the neighbouring cell
(ROADMAP Queue 3). Pinned here:

  - the segment compositor (`composite_segment` / `composite_finalize` /
    `full_dists`) against JAX's, and its factorization of volume_render;
  - probe, hard-mask render and the early-stop partial against eager JAX;
  - the dead program equal to the one-shot render bit for bit;
  - partial + resume-everything equal to the one-shot render;
  - `render_rays_chunked` through the two-wave and early-stop renderers
    against JAX's on the same rays: outputs, mode and counts;
  - the eps bound, the big-frame segmentation, the gates and the errors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render_occ import _setup

from nerfsys_tpu.models import occupancy as JMO
from nerfsys_tpu.ops import volrend as JV
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.models import occupancy as TMO
from nerfsys_tpu_torch.ops import volrend as TV
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from nerfsys_tpu_torch.utils import interop

S = 12  # samples per ray; the early-stop renderers split 3 + 9


def _world(seed=0):
    """_setup's params with an occupancy that marks expert 0's finest level
    only (60% of its cells): rays aimed at (0, 1, 0) miss every marked
    cell."""
    cfg, tcfg, (jp, jst, _), (tp, tst, _) = _setup(seed=seed)
    rng = np.random.default_rng(seed + 100)
    binary = np.zeros((2, 2, 16, 16, 16), bool)
    binary[0, 0] = rng.uniform(size=(16, 16, 16)) < 0.6
    occ = {"binary": binary, "num_updates": np.int32(10),
           "occs": np.where(binary, rng.uniform(size=binary.shape),
                            0.0).astype(np.float32)}
    jocc = {k: jnp.asarray(v) for k, v in occ.items()}
    tocc = interop.occ_state_from_jax(occ, "cpu")
    return cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc)


def _rays_at(rng, n, target_y, spread=0.05):
    """Rays from above, down through (0, target_y, 0)."""
    o = np.tile([0.0, float(target_y), 3.0], (n, 1)).astype(np.float32)
    o[:, :2] += rng.normal(scale=0.1, size=(n, 2))
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    d[:, :2] = rng.normal(scale=spread, size=(n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nf = np.tile([0.5, 6.0], (n, 1)).astype(np.float32)
    return np.concatenate([o, d, nf], 1).astype(np.float32)


def _layout(rng, kind):
    """'skip': an alive chunk, a dead chunk, a half-alive chunk (64-ray
    chunks); 'pack': every chunk a quarter alive (packing folds them)."""
    alive, dead = _rays_at(rng, 256, -1.0), _rays_at(rng, 256, 1.0)
    if kind == "skip":
        rays = np.concatenate([alive[:64], dead[:64], alive[64:96],
                               dead[64:96]])
    else:
        rays = np.where((np.arange(256) % 4 == 0)[:, None], alive, dead)
    rays = rays.copy()
    rays[5] = 0.0  # an invalid (padding-like) ray inside an alive chunk
    return rays


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# --------------------------- the segment compositor -------------------------
def _segment_inputs(seed):
    rng = np.random.default_rng(seed)
    N, n = 64, 16
    t = np.sort(rng.uniform(0.5, 6.0, (N, n)).astype(np.float32), axis=1)
    sigma = rng.gamma(1.0, 2.0, (N, n)).astype(np.float32)
    sigma[::5, 3:9] = 0.0  # empty stretches: alpha exactly 0
    rgb = rng.uniform(0, 1, (N, n, 3)).astype(np.float32)
    return t, sigma, rgb


@pytest.mark.parametrize("fog", [False, True])
def test_composite_segments_match_jax(fog):
    t, sigma, rgb = _segment_inputs(3)
    N = t.shape[0]
    jd, td = JV.full_dists(jnp.asarray(t)), TV.full_dists(torch.tensor(t))
    _close(td.numpy(), jd, 0.0)
    jc = JV.composite_init(N, jnp.float32, fog=fog)
    tc = TV.composite_init(N, torch.float32, fog=fog, device="cpu")
    tt = torch.tensor(t)
    for lo, hi in ((0, 5), (5, 11), (11, 16)):
        jc = JV.composite_segment(jc, jnp.asarray(rgb[:, lo:hi]),
                                  jnp.asarray(sigma[:, lo:hi]),
                                  jnp.asarray(t[:, lo:hi]), jd[:, lo:hi])
        # column slices, as the renderers pass them
        tc = TV.composite_segment(tc, torch.tensor(rgb[:, lo:hi]),
                                  torch.tensor(sigma[:, lo:hi]),
                                  tt[:, lo:hi], td[:, lo:hi])
        assert set(tc) == set(jc)
        for k in jc:
            _close(tc[k].numpy(), jc[k], 1e-6)
    bg = np.random.default_rng(4).uniform(size=(N, 3)).astype(np.float32)
    for b in (None, bg):
        want = JV.composite_finalize(jc, None if b is None
                                     else jnp.asarray(b))
        got = TV.composite_finalize(tc, None if b is None
                                    else torch.tensor(b))
        assert len(got) == len(want) == (5 if fog else 3)
        for g, w in zip(got, want):
            _close(g.numpy(), w, 1e-6)


@pytest.mark.parametrize("fog", [False, True])
def test_composite_segments_match_volume_render(fog):
    t, sigma, rgb = _segment_inputs(5)
    N = t.shape[0]
    tt, bg = torch.tensor(t), torch.ones((N, 3))
    rgb_sigma = torch.cat([torch.tensor(rgb), torch.tensor(sigma)[..., None]],
                          dim=-1)
    rgb_f, depth_f, w_f, acc_f = TV.volume_render(rgb_sigma, tt, bg)
    dists = TV.full_dists(tt)
    carry = TV.composite_init(N, fog=fog, device="cpu")
    for lo, hi in ((0, 5), (5, 11), (11, 16)):
        carry = TV.composite_segment_plain(
            carry, torch.tensor(rgb[:, lo:hi]), torch.tensor(sigma[:, lo:hi]),
            tt[:, lo:hi], dists[:, lo:hi])
    outs = TV.composite_finalize(carry, bg)
    for g, w in zip(outs[:3], (rgb_f, depth_f, acc_f)):
        _close(g, w, 1e-5)
    if fog:
        wmax, ent = TR._fog_stats(w_f)
        _close(outs[3], wmax, 1e-6)
        _close(outs[4], ent, 1e-5)


def test_composite_segment_wrapper_errors():
    t, sigma, rgb = _segment_inputs(6)
    carry = TV.composite_init(t.shape[0], device="cpu")
    args = (torch.tensor(rgb[:, :4]), torch.tensor(sigma[:, :4]),
            torch.tensor(t[:, :4]), torch.tensor(t[:, :4]))
    with pytest.raises(RuntimeError, match="no backward"):
        TV.composite_segment(carry, args[0].requires_grad_(True), *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        TV.composite_segment({k: v.to("meta") for k, v in carry.items()},
                             *(a.detach().to("meta") for a in args))


# --------------------------- probe, hard mask, dead program -----------------
@pytest.mark.parametrize("active_expert,importance", [(None, True),
                                                      (0, False)])
def test_probe_and_hard_mask_render_match_jax(active_expert, importance):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _world()
    rays = _layout(np.random.default_rng(1), "skip")
    kw = dict(active_expert=active_expert, importance=importance)
    with jax.disable_jit():
        jstate, jalive = JMO.probe_rays_occ(jst, jocc, jnp.asarray(rays), **kw)
        want = JMO.render_rays_occ(jp, cfg, jst, jocc, jnp.asarray(rays), S,
                                   cdf_state=jstate, **kw)
    tstate, talive = TMO.probe_rays_occ(tst, tocc, torch.tensor(rays), **kw)
    assert bool(talive) == bool(jalive)
    for k in ("alive", "alive_valid"):
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]))
    _close(tstate["cdf"].numpy(), jstate["cdf"], 1e-5)
    alive_valid = tstate["alive_valid"].numpy()
    assert alive_valid[:64].sum() > 60 and not alive_valid[64:128].any()

    for cdf_state in (tstate, None):  # the wave-1 CDF, or its own probe
        got = TMO.render_rays_occ(tp, tcfg, tst, tocc, torch.tensor(rays), S,
                                  cdf_state=cdf_state, **kw)
        for g, w in zip(got, want):
            _close(g.numpy(), w, 1e-5)
    acc = got[3].numpy()
    assert acc[64:128].max() == 0.0 and acc[:64].mean() > 0.05


@pytest.mark.parametrize("fog", [False, True])
def test_dead_program_equals_one_shot(fog):
    _, tcfg, _, (tp, tst, tocc) = _world()
    rays = _rays_at(np.random.default_rng(2), 96, 1.0)
    rays[::7] = 0.0  # invalid rays go through the dead program too
    rays_t = torch.tensor(rays)
    _, alive = TMO.probe_rays_occ(tst, tocc, rays_t, importance=True)
    assert not bool(alive)
    ren = TR.make_chunk_renderer(tcfg, ray_samples=S, occ_state=tocc,
                                 occ_importance=True, fog_stats=fog,
                                 device="cpu")
    assert isinstance(ren, TR.TwoWaveOccRenderer)
    want = TMO.render_rays_occ(tp, tcfg, tst, tocc, rays_t, S,
                               importance=True)
    got = TMO.render_rays_occ_dead(tp, tcfg, tst, rays_t, S,
                                   dead=TMO.dead_grid(tocc))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) == 0.0
    for g, w in zip(ren.render_dead(tp, tst, rays_t), ren.full(tp, tst,
                                                                rays_t)):
        assert float((g - w).abs().max()) == 0.0


# --------------------------- early-stop programs ----------------------------
@pytest.mark.parametrize("hard_mask", [True, False])
def test_et_partial_matches_jax(hard_mask):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _world()
    rays = _layout(np.random.default_rng(3), "skip")
    kw = dict(seg_samples=3, importance=True, hard_mask=hard_mask,
              early_stop_eps=1e-2, sigma_scale=4.0, fog=True)
    with jax.disable_jit():
        jout, jalive, jst8 = JMO.render_rays_occ_et_partial(
            jp, cfg, jst, jocc, jnp.asarray(rays), S, **kw)
    tout, talive, tst8 = TMO.render_rays_occ_et_partial(
        tp, tcfg, tst, tocc, torch.tensor(rays), S, **kw)
    for g, w in zip(tout, jout):
        _close(g.numpy(), w, 1e-5)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    assert talive.any() and not talive.all()
    for k in ("o", "d", "t_rest", "d_rest", "bg"):
        _close(tst8[k].numpy(), jst8[k], 1e-5)
    for k in ("alive", "valid"):
        np.testing.assert_array_equal(tst8[k].numpy(), np.asarray(jst8[k]))
    for k in jst8["carry"]:
        _close(tst8["carry"][k].numpy(), jst8["carry"][k], 1e-5)


@pytest.mark.parametrize("hard_mask,fog", [(True, False), (True, True),
                                           (False, False), (False, True)])
def test_partial_plus_resume_all_equals_one_shot(hard_mask, fog):
    _, tcfg, _, (tp, tst, tocc) = _world()
    rays = torch.tensor(_layout(np.random.default_rng(4), "skip"))
    rgb_f, depth_f, w_f, acc_f = TMO.render_rays_occ(
        tp, tcfg, tst, tocc, rays, S, importance=True, hard_mask=hard_mask,
        sigma_scale=4.0)
    _, _, state = TMO.render_rays_occ_et_partial(
        tp, tcfg, tst, tocc, rays, S, seg_samples=3, importance=True,
        hard_mask=hard_mask, fog=fog, sigma_scale=4.0)
    # resume EVERY ray: the segmented math alone must give the one-shot
    # render; eps only picks who resumes
    ids = torch.arange(rays.shape[0])
    outs = TMO.render_rays_occ_et_resume(tp, tcfg, tst, tocc, state, ids,
                                         hard_mask=hard_mask,
                                         sigma_scale=4.0)
    for g, w in zip(outs[:3], (rgb_f, depth_f, acc_f)):
        _close(g, w, 1e-5)
    if fog:
        wmax, ent = TR._fog_stats(w_f)
        _close(outs[3], wmax, 1e-6)
        _close(outs[4], ent, 1e-4)


# --------------------------- the dispatch, end to end -----------------------
@pytest.mark.parametrize("kind,layout,fog", [
    ("two_wave", "skip", False), ("two_wave", "pack", True),
    ("early_stop_hard", "skip", False), ("early_stop_hard", "pack", False),
    ("early_stop_soft", "skip", True)])
def test_chunked_render_matches_jax(kind, layout, fog):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _world()
    rays = _layout(np.random.default_rng(5), layout)
    kw = dict(ray_samples=S, occ_importance=True, fog_stats=fog,
              occ_hard_mask=kind != "early_stop_soft")
    if kind != "two_wave":
        kw.update(early_stop_eps=1e-6, early_stop_seg=3)
    tren = TR.make_chunk_renderer(tcfg, occ_state=tocc, device="cpu", **kw)
    jren = JR.make_chunk_renderer(cfg, occ_state=jocc, **kw)
    assert type(tren).__name__ == type(jren).__name__
    t_stats, j_stats = {}, {}
    got = TR.render_rays_chunked(tren, tp, tst, rays, 64, stats=t_stats,
                                 fog_stats=fog)
    with jax.disable_jit():
        want = JR.render_rays_chunked(jren, jp, jst, rays, 64, stats=j_stats,
                                      fog_stats=fog)
    assert got.shape == (len(rays), 7 if fog else 5)
    _close(got, want, 1e-5)
    assert t_stats == j_stats
    want_mode = {("two_wave", "skip"): "two_wave",
                 ("two_wave", "pack"): "packed",
                 ("early_stop_hard", "skip"): "early_stop+two_wave",
                 ("early_stop_hard", "pack"): "early_stop+packed",
                 ("early_stop_soft", "skip"): "early_stop"}[kind, layout]
    assert t_stats["mode"] == want_mode
    if layout == "skip" and kind != "early_stop_soft":
        assert t_stats["chunks_skipped"] == 1
    if kind == "early_stop_hard" and layout == "skip":
        # dead and invalid rays of the alive chunks end after the partial
        assert t_stats["n_terminated"] > 0


def test_two_wave_probe_cache_reuses_wave_one():
    _, tcfg, _, (tp, tst, tocc) = _world()
    ren = TR.make_chunk_renderer(tcfg, ray_samples=S, occ_state=tocc,
                                 occ_importance=True, device="cpu")
    packed = ren.map_outputs(TR._pack5)
    rays = _layout(np.random.default_rng(9), "skip")
    cache, outs = {}, []
    for _ in range(2):
        stats = {}
        pending = TR.two_wave_dispatch(packed, tp, tst, rays, 64,
                                       stats=stats, probe_cache=cache)
        out = np.zeros((len(rays), 5), np.float32)
        for ids, o in pending:
            out[ids] = o.numpy()[:len(ids)]
        outs.append((out, stats))
    assert "probe_cached" not in outs[0][1] and outs[1][1]["probe_cached"]
    assert cache["chunk_rays"] == 64 and outs[1][1]["chunks_skipped"] == 1
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    _close(outs[0][0], TR.render_rays_chunked(ren.full, tp, tst, rays, 64),
           1e-6)


def test_eps_bound_and_termination():
    _, tcfg, _, (tp, tst, tocc) = _world()
    kw = dict(ray_samples=S, occ_state=tocc, occ_importance=True,
              occ_hard_mask=False, device="cpu")
    base = TR.make_chunk_renderer(tcfg, **kw)
    eps = 0.5  # random-init fields are weakly opaque: force termination
    et = TR.make_chunk_renderer(tcfg, early_stop_eps=eps, early_stop_seg=3,
                                **kw)
    rays = _rays_at(np.random.default_rng(6), 256, -1.0, spread=0.3)
    stats = {}
    out_et = TR.render_rays_chunked(et, tp, tst, rays, 64, stats=stats)
    out_b = TR.render_rays_chunked(base, tp, tst, rays, 64)
    assert stats["n_terminated"] > 0, "eps=0.5 must terminate some rays"
    assert stats["n_terminated"] + stats["n_resumed"] == 256
    assert np.isfinite(out_et).all()
    assert np.abs(out_et[:, :3] - out_b[:, :3]).max() <= 2 * eps + 1e-5
    assert np.abs(out_et[:, 4] - out_b[:, 4]).max() <= eps + 1e-5


def test_big_frame_segments():
    _, tcfg, _, (tp, tst, tocc) = _world()
    kw = dict(ray_samples=S, occ_state=tocc, occ_importance=True,
              device="cpu")
    base = TR.make_chunk_renderer(tcfg, **kw)
    et = TR.make_chunk_renderer(tcfg, early_stop_eps=1e-6, early_stop_seg=3,
                                **kw)
    rng = np.random.default_rng(7)
    rays = np.concatenate([_rays_at(rng, 400, -1.0), _rays_at(rng, 200, 1.0)])
    rays = rays[rng.permutation(600)]  # 19 chunks of 32 > SEG = 16
    stats = {}
    out_et = TR.render_rays_chunked(et, tp, tst, rays, 32, stats=stats)
    out_b = TR.render_rays_chunked(base, tp, tst, rays, 32)
    _close(out_et, out_b, 1e-5)
    assert stats["segments"] == 2 and stats["chunks_total"] == 19


def test_fog_columns_mismatch_raises():
    _, tcfg, _, (tp, tst, tocc) = _world()
    et = TR.make_chunk_renderer(tcfg, ray_samples=S, occ_state=tocc,
                                occ_importance=True, fog_stats=True,
                                early_stop_eps=1e-6, device="cpu")
    assert isinstance(et, TR.EarlyStopOccRenderer) and et.ncols == 7
    rays = _rays_at(np.random.default_rng(8), 48, -1.0)
    out = TR.render_rays_chunked(et, tp, tst, rays, 64, fog_stats=True)
    assert out.shape == (48, 7) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="fog_stats"):
        TR.render_rays_chunked(et, tp, tst, rays, 64, fog_stats=False)


def test_gates_return_the_non_early_stop_renderer(capsys):
    _, tcfg, _, (_, _, tocc) = _world()
    kw = dict(occ_state=tocc, early_stop_eps=1e-4, device="cpu")
    r = TR.make_chunk_renderer(tcfg, ray_samples=8, **kw)
    assert isinstance(r, TR.TwoWaveOccRenderer)
    r = TR.make_chunk_renderer(tcfg, ray_samples=S, bg_policy="last_sample",
                               **kw)
    assert isinstance(r, TR.ChunkRenderer)  # the one-shot program
    r = TR.make_chunk_renderer(dataclasses.replace(tcfg, bucketed=True),
                               ray_samples=S, **kw)
    assert isinstance(r, TR.TwoWaveOccRenderer) and not r.packable
    assert capsys.readouterr().out.count("early_stop_eps ignored") == 3
    r = TR.make_chunk_renderer(tcfg, ray_samples=S, occ_hard_mask=False,
                               **kw)
    assert isinstance(r, TR.EarlyStopOccRenderer) and r.probe is None
    assert r.render_dead is None and not r.packable


@pytest.mark.parametrize("kw", [dict(), dict(early_stop_eps=1e-4),
                                dict(early_stop_eps=1e-4,
                                     occ_hard_mask=False),
                                dict(fog_stats=True)])
def test_renderers_need_a_card_or_device_cpu(kw):
    _, tcfg, _, (_, _, tocc) = _world()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.make_chunk_renderer(tcfg, ray_samples=S, occ_state=tocc, **kw)
    assert TR.make_chunk_renderer(tcfg, ray_samples=S, occ_state=tocc,
                                  device="cpu", **kw).device.type == "cpu"
