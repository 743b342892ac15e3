"""Port parity: union-probe grids (the probe half of `--render_fast`).

`build_union_probe_grid` resamples the experts' occupancy union into one
single-level grid; `union_probe_fns` hands it to kernel 2 as a K=1, L=1
stack; `make_chunk_renderer(occ_probe_grid_res=...)` probes it in the soft
one-shot, hard two-wave and hard early-stop renderers. The JAX package and
the port get the same numpy params, grids and rays (the planes world of
tests/test_torch_early_stop.py: K=2 experts, planes L=2 base 8 F=4,
occupancy R=16 L=2, expert 0's finest level 60% marked). The JAX side runs
eagerly (`jax.disable_jit()`): jitted XLA on the CPU fuses multiply-adds
and can move a lattice or probe point into the neighbouring cell.

Tolerances: the grid bit for bit (the same float operations); the probe
CDF 1e-6 (cumulative sums of 32 weights in another order); rendered
outputs 1e-5 (float32 MLPs and compositing sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_early_stop import _layout, _world

from nerfsys_tpu.models import occupancy as JMO
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.models import occupancy as TMO
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR

S = 12


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("dilate", [0, 1, 2])
@pytest.mark.parametrize("importance", [False, True])
def test_build_union_probe_grid_matches_jax_bit_for_bit(dilate, importance):
    _, _, (_, jst, jocc), (_, tst, tocc) = _world()
    with jax.disable_jit():
        want = JMO.build_union_probe_grid(jocc, jst, res=16,
                                          importance=importance,
                                          dilate=dilate)
    got = TMO.build_union_probe_grid(tocc, tst, res=16,
                                     importance=importance, dilate=dilate)
    np.testing.assert_array_equal(got["aabb"].numpy(),
                                  np.asarray(want["aabb"]))
    np.testing.assert_array_equal(got["binary"].numpy(),
                                  np.asarray(want["binary"]))
    assert got["binary"].shape == (1, 16, 16, 16)
    if importance:
        np.testing.assert_array_equal(got["values"].numpy(),
                                      np.asarray(want["values"]))
    else:
        assert got["values"] is None and want["values"] is None
    # the grid is neither empty nor full, and dilation grows it
    marked = int(got["binary"].sum())
    assert 0 < marked < 16 ** 3
    if dilate:
        fewer = TMO.build_union_probe_grid(tocc, tst, res=16,
                                           dilate=dilate - 1)
        assert int(fewer["binary"].sum()) < marked
        assert bool((got["binary"] | ~fewer["binary"]).all())


def test_union_probe_fns_is_a_one_level_stack():
    _, _, _, (_, tst, tocc) = _world()
    for importance in (False, True):
        grid = TMO.build_union_probe_grid(tocc, tst, res=8,
                                          importance=importance)
        pf = TMO.union_probe_fns(grid)
        assert pf.binary.shape == pf.occs.shape == (1, 1, 8, 8, 8)
        assert pf.aabbs.shape == (1, 2, 3)
        assert pf.importance == importance
        if not importance:
            assert not bool(pf.occs.any())


@pytest.mark.parametrize("importance", [False, True])
@pytest.mark.parametrize("ray_floor", [0.0, 0.25])
def test_probe_rays_occ_with_union_grid_matches_jax(importance, ray_floor):
    _, _, (_, jst, jocc), (_, tst, tocc) = _world()
    rays = _layout(np.random.default_rng(2), "skip")
    with jax.disable_jit():
        jgrid = JMO.build_union_probe_grid(jocc, jst, res=16,
                                           importance=importance)
        want, want_any = JMO.probe_rays_occ(
            jst, jocc, jnp.asarray(rays), n_probes=32, importance=importance,
            probe_fns=JMO.union_probe_fns(jgrid), ray_floor=ray_floor)
    tgrid = TMO.build_union_probe_grid(tocc, tst, res=16,
                                       importance=importance)
    got, got_any = TMO.probe_rays_occ(
        tst, tocc, torch.from_numpy(rays), n_probes=32,
        importance=importance, probe_fns=TMO.union_probe_fns(tgrid),
        ray_floor=ray_floor)
    _close(got["cdf"], want["cdf"], 1e-6)
    for key in ("alive", "alive_valid", "occ"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    assert bool(got_any) == bool(want_any)
    # the union grid probes other cells than the exact per-expert union
    exact, _ = TMO.probe_rays_occ(tst, tocc, torch.from_numpy(rays),
                                  n_probes=32, importance=importance,
                                  ray_floor=ray_floor)
    assert not torch.equal(exact["cdf"], got["cdf"])


@pytest.mark.parametrize("kind,layout", [
    ("soft", "skip"), ("two_wave", "skip"), ("two_wave", "pack"),
    ("early_stop_hard", "skip")])
def test_chunk_renderer_with_union_grid_matches_jax(kind, layout):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _world()
    rays = _layout(np.random.default_rng(5), layout)
    kw = dict(ray_samples=S, occ_importance=True, occ_probe_grid_res=16,
              occ_hard_mask=kind != "soft")
    if kind == "early_stop_hard":
        kw.update(early_stop_eps=1e-6, early_stop_seg=3)
    tren = TR.make_chunk_renderer(tcfg, occ_state=tocc, device="cpu", **kw)
    jren = JR.make_chunk_renderer(cfg, occ_state=jocc, **kw)
    want_type = {"soft": TR.ChunkRenderer, "two_wave": TR.TwoWaveOccRenderer,
                 "early_stop_hard": TR.EarlyStopOccRenderer}[kind]
    assert isinstance(tren, want_type)
    t_stats, j_stats = {}, {}
    got = TR.render_rays_chunked(tren, tp, tst, rays, 64, stats=t_stats)
    with jax.disable_jit():
        want = JR.render_rays_chunked(jren, jp, jst, rays, 64,
                                      stats=j_stats)
    _close(got, want, 1e-5)
    assert t_stats == j_stats
    assert np.isfinite(got).all()
    if kind == "soft":
        return
    # the coarser union grid keeps at least the exact union's rays alive
    # (it marks cell corners and dilates), while the one-shot `full`
    # program keeps exact probing
    exact = TR.make_chunk_renderer(
        tcfg, occ_state=tocc, device="cpu",
        **{k: v for k, v in kw.items() if k != "occ_probe_grid_res"})
    e_stats = {}
    TR.render_rays_chunked(exact, tp, tst, rays, 64, stats=e_stats)
    assert t_stats["n_alive"] > e_stats["n_alive"]
    _close(TR.render_rays_chunked(tren.full, tp, tst, rays, 64),
           TR.render_rays_chunked(exact.full, tp, tst, rays, 64), 0.0)
    if kind == "two_wave":
        # one alive chunk from the union probe's CDF, against JAX's
        chunk = rays[:64]
        cdf, _ = tren.probe(tst, torch.from_numpy(chunk))
        out = tren.render_from_cdf(tp, tst, torch.from_numpy(chunk), cdf)
        with jax.disable_jit():
            jcdf, _ = jren.probe(jst, jnp.asarray(chunk))
            jout = jren.render_from_cdf(jp, jst, jnp.asarray(chunk), jcdf)
        for g, w in zip(out, jout):
            _close(g, w, 1e-5)
        ex_out = exact.render_from_cdf(
            tp, tst, torch.from_numpy(chunk),
            exact.probe(tst, torch.from_numpy(chunk))[0])
        assert not torch.allclose(out[0], ex_out[0], atol=1e-3)


def test_union_grid_built_once_per_statics():
    _, tcfg, _, (tp, tst, tocc) = _world()
    ren = TR.make_chunk_renderer(tcfg, ray_samples=S, occ_state=tocc,
                                 occ_importance=True, occ_probe_grid_res=8,
                                 device="cpu")
    rays = torch.from_numpy(_layout(np.random.default_rng(1), "skip")[:64])
    calls = []
    real = TR.build_union_probe_grid

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    TR.build_union_probe_grid = counting
    try:
        ren.probe(tst, rays)
        ren.probe(tst, rays)
        assert len(calls) == 1
        ren.probe(tst.to("cpu"), rays)  # a new statics object: a new grid
        assert len(calls) == 2
    finally:
        TR.build_union_probe_grid = real


def test_union_probe_ignored_for_one_expert(capsys):
    _, tcfg, _, (_, _, tocc) = _world()
    ren = TR.make_chunk_renderer(tcfg, ray_samples=S, occ_state=tocc,
                                 occ_probe_grid_res=16, active_expert=0,
                                 device="cpu")
    assert "--occ_union_probe_res ignored" in capsys.readouterr().out
    assert isinstance(ren, TR.TwoWaveOccRenderer)
