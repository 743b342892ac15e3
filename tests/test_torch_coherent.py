"""Port parity: the coherent-expert renderer (`--render_coherent`) and
kernel row 10b's plain version (`routing_coherent_expert`).

The JAX package and the port get the same numpy params (K=2 hash-grid
experts, L=2 levels, 2^8 rows, hidden 8), occupancy grids (R=8, L=2) and
rays: a third aimed deep into each expert's region, a third crossing the
boundary plane y=0, one invalid ray. The JAX side runs eagerly
(`jax.disable_jit()`), so both sides do the same float operations.

Tolerances: coherent ids exact; the dispatch against the port's own full
routed program 1e-6 (the reference's own bound: a coherent ray's routed
blend IS its expert's field, up to the order of the K-batched vs one-expert
matmuls); against the JAX package 1e-5 (float32 MLPs summed in another
order); dispatch stats exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_coherent import _mixed_rays
from test_torch_bucketed import _np_params

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops.encodings import HashGridConfig
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from nerfsys_tpu_torch.utils import interop

S = 8
CHUNK = 128


def _setup(margin=1.1, seed=0, K=2):
    cents = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)[:K]
    boxes = np.stack([np.stack([c - 1.2, c + 1.2]) for c in cents])
    gbox = np.array([[-2.5] * 3, [2.5] * 3], np.float32)
    expert = JN.NGPConfig(hidden=8, sigma_depth=1, color_hidden=8,
                          color_depth=1, geo_feat_dim=3,
                          hash=HashGridConfig(levels=2, min_res=4, max_res=8,
                                              log2_hashmap_size=8))
    cfg = JCo.ContainerConfig(num_experts=K, expert=expert,
                              boundary_margin=margin, bg_hidden=8)
    rng = np.random.default_rng(seed)
    np_params = _np_params(rng, cfg)
    binary = rng.uniform(size=(K, 2, 8, 8, 8)) > 0.4
    occ = {"binary": binary, "num_updates": np.int32(10),
           "occs": rng.uniform(size=binary.shape).astype(np.float32)}
    jst = JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                               jnp.asarray(gbox))
    jax_side = (jax.tree_util.tree_map(jnp.asarray, np_params), jst,
                {k: jnp.asarray(v) for k, v in occ.items()})
    port_side = (interop.container_params_from_jax(np_params, "cpu"),
                 interop.statics_from_jax(jst, "cpu"),
                 interop.occ_state_from_jax(occ, "cpu"))
    return cfg, interop.container_config_from_jax(cfg), jax_side, port_side


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("margin", [1.1, 1.0])
def test_routing_coherent_expert_matches_jax(margin):
    cfg, tcfg, (_, jst, _), (_, tst, _) = _setup(margin)
    pts = np.zeros((3, 4, 3), np.float32)
    pts[0, :, 1] = -1.0  # all samples deep in expert 0
    pts[1, :, 1] = 1.0  # expert 1
    pts[2, :, 1] = [-1.0, -0.02, 0.02, 1.0]  # crosses the boundary
    rng = np.random.default_rng(1)
    rand = (rng.uniform(-2, 2, (200, 1, 3))
            + rng.normal(scale=0.1, size=(200, 6, 3))).astype(np.float32)
    for p in (pts, rand):
        want = np.asarray(JCo.routing_coherent_expert(jst, cfg,
                                                      jnp.asarray(p)))
        got = TCo.routing_coherent_expert(tst, tcfg, torch.from_numpy(p))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() != [-1] * 200 and -1 in got.tolist()
    kid = TCo.routing_coherent_expert(tst, tcfg, torch.from_numpy(pts))
    assert kid.tolist() == [0, 1, -1]


def test_coherent_clamp_case_matches_jax():
    """Two centroids 5e-7 apart: at a point on the first, the unclamped
    distances (0, 5e-7) pass the margin test but the blend is two-expert;
    the 1e-6 clamp (routing_weights') marks the ray -1 on both sides."""
    cfg, tcfg, _, _ = _setup(1.1)
    cents = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 5e-7]], np.float32)
    jst = JCo.ContainerStatics(jnp.asarray(cents), jnp.zeros((2, 2, 3)),
                               jnp.zeros((2, 3)))
    tst = interop.statics_from_jax(jst, "cpu")
    pts = np.zeros((2, 3, 3), np.float32)
    pts[1, :, 2] = 3.0  # far away: d2 / d1 ~ 1, a boundary ray too
    want = np.asarray(JCo.routing_coherent_expert(jst, cfg, jnp.asarray(pts)))
    got = TCo.routing_coherent_expert(tst, tcfg, torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [-1, -1]
    hard = dataclasses.replace(tcfg, boundary_margin=1.0)
    assert TCo.routing_coherent_expert(tst, hard,
                                       torch.from_numpy(pts)).tolist() == [
        0, 1]


def _renderers(cfg, tcfg, jocc, tocc, mode, fog=False):
    if mode == "stratified":
        kw = dict(ray_samples=S, fog_stats=fog)
        return (JR.make_coherent_renderer(cfg, **kw),
                TR.make_coherent_renderer(tcfg, device="cpu", **kw))
    hard = mode.endswith("hard")
    kw = dict(ray_samples=S, occ_importance=True, occ_hard_mask=hard,
              fog_stats=fog,
              occ_probe_grid_res=16 if mode.startswith("union") else 0)
    return (JR.make_coherent_renderer(cfg, occ_state=jocc, **kw),
            TR.make_coherent_renderer(tcfg, occ_state=tocc, device="cpu",
                                      **kw))


@pytest.mark.parametrize("mode,margin", [
    ("stratified", 1.1), ("stratified", 1.0), ("occ_hard", 1.1),
    ("occ_soft", 1.1), ("union_hard", 1.1), ("union_soft", 1.1)])
def test_coherent_dispatch_matches_full_and_jax(mode, margin):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup(margin)
    rays = _mixed_rays(np.random.default_rng(0), 300)
    jren, tren = _renderers(cfg, tcfg, jocc, tocc, mode)
    t_stats, j_stats = {}, {}
    out = np.zeros((300, 5), np.float32)
    for ids, dev in TR.coherent_dispatch(tren, tp, tst, rays, CHUNK,
                                         stats=t_stats):
        out[ids] = np.concatenate(
            [d.numpy()[:len(ids)].reshape(len(ids), -1) for d in dev], 1)
    with jax.disable_jit():
        for _ in JR.coherent_dispatch(jren, jp, jst, rays, CHUNK,
                                      stats=j_stats):
            pass
        want = JR.render_rays_chunked(jren, jp, jst, rays, CHUNK)
    assert t_stats == j_stats
    assert t_stats["n_coherent"] > 150 and t_stats["n_boundary"] > 10
    _close(out, want, 1e-5)
    # the full routed program on every ray, chunk for chunk
    full = TR.render_rays_chunked(tren.full, tp, tst, rays, CHUNK)
    _close(out, full, 1e-6)
    if mode == "stratified":
        plain = TR.render_rays_chunked(
            TR.make_chunk_renderer(tcfg, ray_samples=S, device="cpu"), tp,
            tst, rays, CHUNK)
        _close(out, plain, 1e-6)
    elif not mode.startswith("union"):
        plain = TR.render_rays_chunked(
            TR.make_chunk_renderer(tcfg, ray_samples=S, occ_state=tocc,
                                   occ_importance=True,
                                   occ_hard_mask=mode.endswith("hard"),
                                   device="cpu"), tp, tst, rays, CHUNK)
        _close(out, plain, 1e-6)


def test_single_program_takes_the_expert_id():
    cfg, tcfg, (_, _, jocc), (tp, tst, tocc) = _setup()
    rays = torch.from_numpy(_mixed_rays(np.random.default_rng(1), 128))
    for mode in ("stratified", "occ_hard"):
        _, tren = _renderers(cfg, tcfg, jocc, tocc, mode)
        r0 = tren.single(tp, tst, rays, 0)
        r1 = tren.single(tp, tst, rays, 1)
        assert not torch.allclose(r0[0], r1[0])
        kid = tren.probe(tst, rays)
        assert kid.dtype == torch.int32 and kid.shape == (128,)


@pytest.mark.parametrize("fog", [False, True])
def test_render_rays_chunked_routes_the_coherent_bundle(fog):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup()
    rays = _mixed_rays(np.random.default_rng(2), 300)
    jren, tren = _renderers(cfg, tcfg, jocc, tocc, "occ_hard", fog=fog)
    t_stats, j_stats = {}, {}
    got = TR.render_rays_chunked(tren, tp, tst, rays, CHUNK, stats=t_stats,
                                 fog_stats=fog)
    with jax.disable_jit():
        want = JR.render_rays_chunked(jren, jp, jst, rays, CHUNK,
                                      stats=j_stats, fog_stats=fog)
    assert got.shape == (300, 7 if fog else 5)
    assert t_stats == j_stats and t_stats["mode"] == "coherent"
    _close(got[:, :5], want[:, :5], 1e-5)
    if fog:
        _close(got[:, 5], want[:, 5], 1e-5)
        _close(got[:, 6], want[:, 6], 1e-4)  # entropy: a sum of p log p
    # hard mode sends dead rays to expert 0 with the coherent ones
    assert t_stats["n_coherent"] > 150


def test_fog_flag_mismatch_raises():
    cfg, tcfg, (_, _, jocc), (tp, tst, tocc) = _setup()
    rays = _mixed_rays(np.random.default_rng(3), 64)
    for built in (False, True):
        _, tren = _renderers(cfg, tcfg, jocc, tocc, "stratified", fog=built)
        with pytest.raises(ValueError, match="fog_stats"):
            TR.render_rays_chunked(tren, tp, tst, rays, CHUNK,
                                   fog_stats=not built)


def test_halving_ladder_pads_tails():
    """A tail packs into the smallest ladder shape that fits: 1024-ray
    chunks give shapes 1024 and (at most 6 shapes, none below 1024) no
    smaller; rays_padded counts the rows rendered beyond the rays."""
    cfg, tcfg, (jp, jst, _), (tp, tst, _) = _setup()
    rays = _mixed_rays(np.random.default_rng(4), 1500)
    _, tren = _renderers(cfg, tcfg, None, None, "stratified")
    jren = JR.make_coherent_renderer(cfg, ray_samples=S)
    t_stats, j_stats = {}, {}
    pending = TR.coherent_dispatch(tren, tp, tst, rays, 2048, stats=t_stats)
    with jax.disable_jit():
        JR.coherent_dispatch(jren, jp, jst, rays, 2048, stats=j_stats)
    assert t_stats == j_stats
    sizes = {int(dev[0].shape[0]) for _, dev in pending}
    assert sizes <= {1024, 2048}
    assert t_stats["rays_padded"] == sum(
        int(dev[0].shape[0]) for _, dev in pending) - 1500
