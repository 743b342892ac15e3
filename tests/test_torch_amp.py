"""Port parity of `--use_amp` (NGPConfig.use_bf16: bfloat16 MLPs) and of
the container paths that reach the field with it.

The expert field (hidden 16; planes L=2 base 8 F=4 with float32 line
matmuls, which JAX on the CPU also computes in float32, and the hash grid
L=4 T=10 F=2) evaluates the same numpy points in the port and in the JAX
package run eagerly: eager JAX and PyTorch both round bf16(x) @ bf16(w)
and the bf16 bias add one op at a time. A jitted JAX expression fuses the
add into the product and rounds once (up to one bfloat16 ulp apart on
most values), so the served frame is held to the jitted renderer at
bfloat16 tolerances.

Tolerances, with what these inputs measure:
  - rgb and sigma against eager JAX: 2e-7 absolute (measured: rgb <=
    6.0e-8, sigma one float32 ulp, 1.2e-7, on 16% / 0.2% of the points);
  - gradients against eager JAX: weights and encoder tables 1e-6 of each
    leaf's max (measured <= 2.5e-7). A bias's
    gradient is the sum of its bfloat16 cotangent over the points: JAX's
    autodiff sums it with `lax.reduce` in bfloat16 on the CPU (7.6e-3 of
    the float32-accumulated sum at 500 rows; 2.8e-2 on the hash sigma
    head's), PyTorch in float32 before its one bfloat16 rounding. So JAX
    differentiates here with every bias broadcast to its (N, out) rows,
    which gives the per-point cotangents unsummed; their float64 sum is
    the bias gradients' reference, within one bfloat16 rounding, 2^-8 of
    each leaf's max (measured <= 3.4e-3);
  - the frame (--use_amp with float32 line matmuls) against the jitted
    renderer: rgb 3e-4, depth 5e-3, acc 1.5e-3 absolute (measured 1.37e-4,
    2.33e-3, 7.06e-4; the float32 frame is as far from it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import _camera
from test_torch_render import _setup as _render_setup

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops.encodings import HashGridConfig
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.models import ngp as TN
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map

N = 500


def _lin(rng, i, o):
    s = 1.0 / np.sqrt(i)
    return {"w": rng.uniform(-s, s, (i, o)).astype(np.float32),
            "b": rng.uniform(-s, s, (o,)).astype(np.float32)}


def _expert(enc, seed=0):
    """(JAX NGPConfig with use_bf16, one expert's numpy params, aabb)."""
    rng = np.random.default_rng(seed)
    cfg = JN.NGPConfig(
        hidden=16, sigma_depth=2, color_hidden=16, color_depth=2,
        geo_feat_dim=7, xyz_encoding=enc, use_bf16=True,
        planes=PlaneEncodingConfig(levels=2, base_res=8, features=4,
                                   pos_grad=False, lines_matmul=True),
        hash=HashGridConfig(levels=4, min_res=4, max_res=64,
                            log2_hashmap_size=10, hash_init_scale=0.5))
    if enc == "planes":
        enc_p = {"planes_enc": {
            "planes": [rng.normal(0, 0.5, (3, R * R, 4)).astype(np.float32)
                       for R in (8, 16)],
            "lines": [rng.normal(1, 0.1, (3, R, 4)).astype(np.float32)
                      for R in (8, 16)]}}
    else:
        enc_p = {"hash_table": rng.uniform(-0.5, 0.5, (4 * 1024, 2)).astype(
            np.float32)}
    params = {**enc_p,
              "sigma_trunk": [_lin(rng, cfg.xyz_enc_dim, 16),
                              _lin(rng, 16, 16)],
              "sigma_head": _lin(rng, 16, 1), "geo_head": _lin(rng, 16, 7),
              "color_mlp": [_lin(rng, 23, 16), _lin(rng, 16, 16),
                            _lin(rng, 16, 3)]}
    aabb = np.array([[-1.2, -1.2, -1.2], [1.2, 1.2, 1.2]], np.float32)
    return cfg, params, aabb


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.3, 1.3, (N, 3)).astype(np.float32),
            rng.normal(size=(N, 3)).astype(np.float32),
            rng.uniform(size=(N, 3)).astype(np.float32))


def _loss_jax(p, cfg, aabb, x, d, w):
    rgb, sigma = JN.ngp_apply(p, cfg, aabb, x, d)
    return jnp.sum(rgb * w) + jnp.sum(jnp.log1p(sigma))


def _rows(tree):
    """Every bias broadcast to one row a point (the params JAX
    differentiates, so that its bias gradients arrive unsummed)."""
    if isinstance(tree, dict):
        return {k: (jnp.broadcast_to(v, (N, v.shape[0])) if k == "b"
                    else _rows(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v) for v in tree]
    return tree


@pytest.fixture(scope="module", params=["planes", "hash"])
def field(request):
    """One eager JAX build (forward and gradients) serves the cases."""
    cfg, params, aabb = _expert(request.param)
    x, d, w = _inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    args = (cfg, jnp.asarray(aabb), jnp.asarray(x), jnp.asarray(d))
    with jax.disable_jit():
        want = JN.ngp_apply(jp, *args)
        grads = jax.grad(_loss_jax)(_rows(jp), *args, jnp.asarray(w))
    tcfg = interop.container_config_from_jax(JCo.ContainerConfig(
        num_experts=1, expert=cfg)).expert
    return dict(cfg=tcfg, params=params, aabb=aabb, x=x, d=d, w=w,
                want=[np.asarray(a) for a in want], grads=grads)


def _port(field, **over):
    cfg = dataclasses.replace(field["cfg"], **over)
    tp = tree_map(lambda a: torch.tensor(a, requires_grad=True),
                  field["params"])
    rgb, sigma = TN.ngp_apply(tp, cfg, torch.tensor(field["aabb"]),
                              torch.tensor(field["x"]),
                              torch.tensor(field["d"]))
    return tp, rgb, sigma


def test_interop_carries_use_bf16(field):
    cfg = field["cfg"]
    assert cfg.use_bf16
    assert cfg.planes.lines_matmul and not cfg.planes.lines_bf16


def test_field_matches_eager_jax(field):
    _, rgb, sigma = _port(field)
    assert rgb.dtype == sigma.dtype == torch.float32
    for got, want in zip((rgb, sigma), field["want"]):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=2e-7)
    # and bfloat16 moved it: the float32 field is another function
    _, rgb32, _ = _port(field, use_bf16=False)
    assert float((rgb32 - rgb).detach().abs().max()) > 1e-5


def test_field_gradients_match_eager_jax(field):
    tp, rgb, sigma = _port(field)
    loss = (rgb * torch.tensor(field["w"])).sum() + torch.log1p(sigma).sum()
    loss.backward()
    paths = jax.tree_util.tree_flatten_with_path(field["grads"])[0]
    got = [t.grad for t in tree_leaves(tp)]
    assert len(got) == len(paths)
    for (path, want), g in zip(paths, got):
        want = np.asarray(want)
        tol = 1e-6
        if jax.tree_util.keystr(path).endswith("['b']"):
            want, tol = want.astype(np.float64).sum(0), 2.0 ** -8
        assert g.dtype == torch.float32 and g.shape == want.shape
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol * float(np.abs(want).max()), (path, err)


def test_container_paths_reach_the_bf16_field():
    """The dense blend and the bucketed buckets evaluate the experts
    through ngp_density / ngp_color with use_bf16; the background MLP
    stays float32, as the reference's."""
    cfg, tcfg, (_, _, _), (tp, tst, _) = _render_setup(seed=4)
    amp = dataclasses.replace(tcfg, expert=dataclasses.replace(
        tcfg.expert, use_bf16=True))
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.uniform(-2.4, 2.4, (256, 3)).astype(np.float32))
    d = torch.tensor(rng.normal(size=(256, 3)).astype(np.float32))
    dense = TCo.container_apply(tp, amp, tst, x, d)
    dense32 = TCo.container_apply(tp, tcfg, tst, x, d)
    assert float((dense[0] - dense32[0]).abs().max()) > 1e-6
    for k in range(2):  # each expert is the bf16 field
        ek = tree_map(lambda a: a[k], tp["experts"])
        rgb_k, sig_k = TN.ngp_apply(ek, amp.expert, tst.expert_aabbs[k], x,
                                    d)
        rgb_s, sig_s = TN.ngp_apply(ek, amp.expert, tst.expert_aabbs[k:k + 1],
                                    x, d)
        assert torch.equal(rgb_s[0], rgb_k) and torch.equal(sig_s[0], sig_k)
    bucketed = TCo.container_apply(tp, dataclasses.replace(
        amp, bucketed=True, experts_per_point=2, capacity_factor=4.0), tst,
        x, d)
    for a, b in zip(bucketed, dense):
        assert float((a - b).abs().max()) <= 1e-6
    bg = TCo.container_bg_fn(tp, amp)
    assert torch.equal(bg(d), TCo.container_bg_fn(tp, tcfg)(d))
    assert bg(d).dtype == torch.float32


def test_amp_frame_matches_the_jitted_renderer():
    """--use_amp with float32 line matmuls (kernel 1's function) through
    the soft-occupancy chunk renderer and render_image."""
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _render_setup(seed=1)

    def amp(c):
        return dataclasses.replace(c, expert=dataclasses.replace(
            c.expert, use_bf16=True, planes=dataclasses.replace(
                c.expert.planes, lines_matmul=True)))

    md = _camera()
    kw = dict(scene_aabb=np.asarray(jst.global_aabb), chunk_rays=96)
    rk = dict(ray_samples=8, occ_importance=True, occ_hard_mask=False)
    served = JR.render_image(JR.make_chunk_renderer(
        amp(cfg), occ_state=jocc, **rk), jp, jst, md, **kw)
    got = TR.render_image(TR.make_chunk_renderer(
        amp(tcfg), occ_state=tocc, device="cpu", **rk), tp, tst, md, **kw)
    for g, s, tol in zip(got, served, (3e-4, 5e-3, 1.5e-3)):
        assert g.shape == s.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, s, rtol=0, atol=tol)
    rgb, _, acc = got
    assert 0.0 <= rgb.min() and rgb.max() <= 1.0 + 1e-6
    assert 0.05 < acc.mean() < 0.99
