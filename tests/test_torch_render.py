"""Port parity of the whole served slice: frame rays -> soft-occupancy MoE
render (probe, sampler, encoder, MLPs, compositor) -> render_image.

Params (K=2 experts, planes L=2, base 8, F=4, hidden 16), the occupancy
state (R=16, L=2) and the camera come from numpy seeds; JAX gets them as
arrays and the port through nerfsys_tpu_torch.utils.interop, on the CPU.

The frame is compared with the JAX render_image as served (jitted). XLA on
the CPU fuses a multiply and an add into one rounding inside jit, which
moves a probe point by an ulp and, rarely, across a grid cell; a flipped
probe cell moves that ray's samples. So at least 90% of the pixels agree to
1e-4 and all stay within 0.05. The same ops unfused (jit disabled) agree
to 1e-5: tests/test_torch_render_occ.py holds render_rays_occ to that.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.models import occupancy as TMO
from nerfsys_tpu_torch.ops import occupancy as TO
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from nerfsys_tpu_torch.utils import interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    experts = {
        "planes_enc": {
            "planes": [rng.normal(0, 0.5, (K, 3, R * R, 4)).astype(np.float32)
                       for R in (8, 16)],
            "lines": [rng.normal(1, 0.1, (K, 3, R, 4)).astype(np.float32)
                      for R in (8, 16)]},
        "sigma_trunk": [_lin(rng, 24, 16, lead), _lin(rng, 16, 16, lead)],
        "sigma_head": _lin(rng, 16, 1, lead),
        "geo_head": _lin(rng, 16, 7, lead),
        "color_mlp": [_lin(rng, 23, 16, lead), _lin(rng, 16, 16, lead),
                      _lin(rng, 16, 3, lead)],
    }
    experts["sigma_head"]["b"][:] = -1.0  # the reference's init bias
    np_params = {"experts": experts,
                 "bg": {"l0": _lin(rng, 16, 8, ()), "l1": _lin(rng, 8, 3, ())}}
    cents = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    boxes = np.stack([np.stack([c - 1.2, c + 1.2]) for c in cents])
    gbox = np.array([[-2.5] * 3, [2.5] * 3], np.float32)
    occ = {"occs": None, "binary": rng.uniform(size=(K, 2, 16, 16, 16)) < 0.4,
           "num_updates": np.int32(10)}
    occ["occs"] = np.where(occ["binary"], rng.uniform(size=occ["binary"].shape),
                           0.0).astype(np.float32)
    jax_side = (jax.tree_util.tree_map(jnp.asarray, np_params),
                JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                                     jnp.asarray(gbox)),
                {k: jnp.asarray(v) for k, v in occ.items()})
    port_side = (interop.container_params_from_jax(np_params, "cpu"),
                 interop.statics_from_jax(
                     SimpleNamespace(centroids=cents, expert_aabbs=boxes,
                                     global_aabb=gbox), "cpu"),
                 interop.occ_state_from_jax(occ, "cpu"))
    return cfg, interop.container_config_from_jax(cfg), jax_side, port_side


def _camera(side=16, t=(0.1, -0.2, 2.0)):
    c2w = np.array([[1, 0, 0, t[0]], [0, 1, 0, t[1]], [0, 0, 1, t[2]]],
                   np.float32)
    return SimpleNamespace(H=side, W=side, c2w=c2w, intrinsics=np.array(
        [0.8 * side, 0.8 * side, side / 2, side / 2], np.float32))


@pytest.mark.parametrize("seed", [1, 3])
def test_render_image_slice_matches_jax(seed):
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup(seed=seed)
    md = _camera()
    kw = dict(scene_aabb=np.asarray(jst.global_aabb), chunk_rays=96)
    jren = JR.make_chunk_renderer(cfg, ray_samples=8, occ_state=jocc,
                                  occ_importance=True, occ_hard_mask=False)
    tren = TR.make_chunk_renderer(tcfg, ray_samples=8, occ_state=tocc,
                                  occ_importance=True, occ_hard_mask=False,
                                  device="cpu")
    got = TR.render_image(tren, tp, tst, md, **kw)
    served = JR.render_image(jren, jp, jst, md, **kw)
    for g, s in zip(got, served):
        assert g.shape == s.shape and np.isfinite(g).all()
        assert np.mean(np.abs(g - s) <= 1e-4) >= 0.9
        np.testing.assert_allclose(g, s, rtol=0, atol=5e-2)
    rgb, _, acc = got
    assert 0.0 <= rgb.min() and rgb.max() <= 1.0 + 1e-6
    assert 0.05 < acc.mean() < 0.99


def test_stratified_branch_matches_jax():
    cfg, tcfg, (jp, jst, _), (tp, tst, _) = _setup(seed=2)
    md = _camera(12)
    kw = dict(near=0.5, far=4.0, chunk_rays=48)
    want = JR.render_image(JR.make_chunk_renderer(cfg, ray_samples=8),
                           jp, jst, md, **kw)
    got = TR.render_image(TR.make_chunk_renderer(tcfg, ray_samples=8,
                                                 device="cpu"),
                          tp, tst, md, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert TR.default_chunk_rays(32) == JR.default_chunk_rays(32) == 65536
    assert TR.default_chunk_rays(96) == JR.default_chunk_rays(96)


def test_unported_paths_raise():
    cfg, tcfg, _, (tp, tst, tocc) = _setup()
    with pytest.raises(NotImplementedError):  # hard mask = two-wave
        TR.make_chunk_renderer(tcfg, ray_samples=8, occ_state=tocc,
                               device="cpu")
    with pytest.raises(NotImplementedError):
        TR.make_chunk_renderer(tcfg, ray_samples=8, occ_state=tocc,
                               occ_hard_mask=False, early_stop_eps=1e-3,
                               device="cpu")
    with pytest.raises(NotImplementedError):
        TMO.render_rays_occ(tp, tcfg, tst, tocc, torch.zeros(4, 8), 8)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, tcfg, _, _ = _setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.make_chunk_renderer(tcfg, ray_samples=8)
    with pytest.raises(RuntimeError):
        TCo.init_container_params(tcfg)
    with pytest.raises(RuntimeError):
        TO.init_occ_state(TO.OccGridConfig(resolution=4, levels=1), 2)
    with pytest.raises(RuntimeError):
        interop.container_params_from_jax({"a": np.zeros(2)})


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerfsys_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, serve_ab\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'nerfsys_tpu' or n.startswith('nerfsys_tpu.')]\n"
        "assert not bad, bad\n"
        "mods = [n for n in sys.modules\n"
        "        if n.startswith('nerfsys_tpu_torch')]\n"
        "need = {'nerfsys_tpu_torch.' + m for m in ("
        "'pipelines.offline.meta_core', 'pipelines.offline.meta_train_step',"
        " 'utils.optim', 'utils.tree', 'ops.losses', 'ops.color_space')}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 21


def test_kernel_registry_covers_every_source():
    from pathlib import Path

    from nerfsys_tpu_torch import kernels

    srcs = {p.name for p in Path(kernels.CSRC).glob("*.cu")}
    assert srcs == {s for s, _ in kernels.SOURCES.values()}
    assert {k.stem for k in kernels.KERNELS} == set(kernels.SOURCES)
    for k in kernels.KERNELS:
        assert Path(REPO, k.source).is_file()
        assert k.replaces.startswith("nerfsys_tpu/")
    kernels.reset_launches()
    assert set(kernels.launches().values()) == {0}
    # the build hash follows the flags: --fmad=false builds are distinct
    assert kernels._lib_path("occ_probe") != kernels._lib_path("planes")
