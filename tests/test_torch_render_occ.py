"""Port parity: rays and the soft-occupancy render of one ray batch.

`render_rays_occ` (soft mode, importance probing, P=32 probes, S=8
samples) runs on both sides on the same numpy params, grids and rays
(K=2 experts, planes L=2 base 8 F=4, occupancy R=16 L=2). The JAX side
runs eagerly: op by op, no multiply-add is fused, so the two sides do the
same float operations in the same order and agree to 1e-5 (sums of 8-32
terms in another order). The jitted comparison of the whole frame is in
tests/test_torch_render.py.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfsys_tpu.data.native as jax_native
from nerfsys_tpu.data import ram_rays as JRays
from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.models import occupancy as JMO
from nerfsys_tpu.ops import rays as JRo
from nerfsys_tpu.ops import scene_box as JSb
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu_torch.data import ram_rays as TRays
from nerfsys_tpu_torch.models import occupancy as TMO
from nerfsys_tpu_torch.ops import rays as TRo
from nerfsys_tpu_torch.ops import scene_box as TSb
from nerfsys_tpu_torch.utils import interop


def _lin(rng, i, o, lead):
    s = 1.0 / np.sqrt(i)
    return {"w": rng.uniform(-s, s, (*lead, i, o)).astype(np.float32),
            "b": rng.uniform(-s, s, (*lead, o)).astype(np.float32)}


def _setup(seed=0, K=2):
    rng = np.random.default_rng(seed)
    expert = JN.NGPConfig(
        hidden=16, sigma_depth=2, color_hidden=16, color_depth=2,
        geo_feat_dim=7, xyz_encoding="planes",
        planes=PlaneEncodingConfig(levels=2, base_res=8, growth=2.0,
                                   features=4, matmul_bwd=True,
                                   pos_grad=False))
    cfg = JCo.ContainerConfig(num_experts=K, expert=expert,
                              boundary_margin=1.1, bg_hidden=8)
    lead = (K,)
    np_params = {
        "experts": {
            "planes_enc": {
                "planes": [rng.normal(0, 0.5, (K, 3, R * R, 4))
                           .astype(np.float32) for R in (8, 16)],
                "lines": [rng.normal(1, 0.1, (K, 3, R, 4)).astype(np.float32)
                          for R in (8, 16)]},
            "sigma_trunk": [_lin(rng, 24, 16, lead), _lin(rng, 16, 16, lead)],
            "sigma_head": _lin(rng, 16, 1, lead),
            "geo_head": _lin(rng, 16, 7, lead),
            "color_mlp": [_lin(rng, 23, 16, lead), _lin(rng, 16, 16, lead),
                          _lin(rng, 16, 3, lead)]},
        "bg": {"l0": _lin(rng, 16, 8, ()), "l1": _lin(rng, 8, 3, ())}}
    cents = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    boxes = np.stack([np.stack([c - 1.2, c + 1.2]) for c in cents])
    gbox = np.array([[-2.5] * 3, [2.5] * 3], np.float32)
    binary = rng.uniform(size=(K, 2, 16, 16, 16)) < 0.4
    occ = {"binary": binary, "num_updates": np.int32(10),
           "occs": np.where(binary, rng.uniform(size=binary.shape),
                            0.0).astype(np.float32)}
    statics = SimpleNamespace(centroids=cents, expert_aabbs=boxes,
                              global_aabb=gbox)
    jax_side = (jax.tree_util.tree_map(jnp.asarray, np_params),
                JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                                     jnp.asarray(gbox)),
                {k: jnp.asarray(v) for k, v in occ.items()})
    port_side = (interop.container_params_from_jax(np_params, "cpu"),
                 interop.statics_from_jax(statics, "cpu"),
                 interop.occ_state_from_jax(occ, "cpu"))
    return cfg, interop.container_config_from_jax(cfg), jax_side, port_side


def _camera(side, t=(0.1, -0.2, 2.0)):
    c2w = np.array([[1, 0, 0, t[0]], [0, 1, 0, t[1]], [0, 0, 1, t[2]]],
                   np.float32)
    return SimpleNamespace(H=side, W=side, c2w=c2w, intrinsics=np.array(
        [0.8 * side, 0.8 * side, side / 2, side / 2], np.float32))


def test_frame_rays_matches_jax(monkeypatch):
    """The port's default (native) path equals the reference's native C++
    generator bit for bit, and its plain version (native=False) the
    reference's numpy path."""
    md = _camera(24)
    aabb = np.array([[-2.5] * 3, [2.5] * 3], np.float32)
    for kw in (dict(aabb=aabb), dict(near=0.5, far=3.0)):
        native, native_valid = JRays.frame_rays(md.H, md.W, md.intrinsics,
                                                md.c2w, **kw)
        got, valid = TRays.frame_rays(md.H, md.W, md.intrinsics, md.c2w,
                                      **kw)
        np.testing.assert_array_equal(got, native)
        np.testing.assert_array_equal(valid, native_valid)
        plain, plain_valid = TRays.frame_rays(md.H, md.W, md.intrinsics,
                                              md.c2w, native=False, **kw)
        with monkeypatch.context() as m:
            m.setattr(jax_native, "native_available", lambda: False)
            want, want_valid = JRays.frame_rays(md.H, md.W, md.intrinsics,
                                                md.c2w, **kw)
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(plain_valid, want_valid)
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)
        assert valid.any()


def test_render_rays_occ_soft_matches_jax():
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup()
    md = _camera(8)
    rays, _ = TRays.frame_rays(md.H, md.W, md.intrinsics, md.c2w,
                               aabb=np.asarray(jst.global_aabb))
    rays[::7, 6:] = np.inf  # invalid rays render the background
    kw = dict(importance=True, hard_mask=False, n_probes=32)
    want = JMO.render_rays_occ(jp, cfg, jst, jocc, jnp.asarray(rays), 8, **kw)
    got = TMO.render_rays_occ(tp, tcfg, tst, tocc, torch.tensor(rays), 8,
                              **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    acc = got[3].numpy()
    assert 0.05 < acc.mean() < 0.99  # partly transparent: placement matters


def test_ray_ops_match_jax():
    dirs_j = JRo.get_ray_directions(6, 5, 4.0, 4.5, 2.5, 3.0)
    dirs_t = TRo.get_ray_directions(6, 5, 4.0, 4.5, 2.5, 3.0,
                                    device="cpu")
    np.testing.assert_allclose(dirs_t.numpy(), np.asarray(dirs_j), rtol=0,
                               atol=1e-7)
    c2w = np.array([[0.0, -1, 0, 0.3], [1, 0, 0, -0.2], [0, 0, 1, 2.5]],
                   np.float32)
    aabb = np.array([[-1.0, -1.5, -1.0], [1.0, 1.5, 1.0]], np.float32)
    want = JRo.get_rays(dirs_j, jnp.asarray(c2w),
                        JSb.SceneBox(jnp.asarray(aabb)))
    got = TRo.get_rays(dirs_t, torch.tensor(c2w),
                       TSb.SceneBox(torch.tensor(aabb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    rays = np.asarray(want).reshape(-1, 8).copy()
    rays[0, 6:] = [2.0, 1.0]  # far < near: invalid
    for kw in (dict(), dict(near_override=0.2, far_override=3.0)):
        jr, jv = JRo.clamp_rays_near_far(jnp.asarray(rays), **kw)
        tr, tv = TRo.clamp_rays_near_far(torch.tensor(rays), **kw)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tv[0] and tv.any()


def test_interop_rejects_unstacked_params():
    with pytest.raises(ValueError):
        interop.container_params_from_jax({"bg": {}}, "cpu")
    with pytest.raises(ValueError):
        interop.container_params_from_jax(
            {"experts": {"a": np.zeros((2, 3)), "b": np.zeros((3, 3))}},
            "cpu")
