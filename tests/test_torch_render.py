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
from nerfsys_tpu.models import occupancy as JMO
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.data import ram_rays as TRays
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
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup()
    # union-probe grids, probe_fns, field_expert and probe-bit masks are
    # ported; meshes still raise
    with pytest.raises(NotImplementedError):
        TR.make_chunk_renderer(tcfg, ray_samples=8, occ_state=tocc,
                               device="cpu", mesh=object())
    for kw in (dict(occ_probe_mask=True),
               dict(occ_probe_mask=True, occ_hard_mask=False)):
        TR.make_chunk_renderer(tcfg, ray_samples=8, occ_state=tocc,
                               device="cpu", **kw)
    TR.make_coherent_renderer(tcfg, ray_samples=8, occ_state=tocc,
                              occ_probe_mask=True, device="cpu")
    # the probe-bit mask renders as the reference's (soft mode ignores it)
    md = _camera(4)
    rays, _ = TRays.frame_rays(md.H, md.W, md.intrinsics, md.c2w,
                               aabb=np.asarray(jst.global_aabb))
    for kw in (dict(mask_from_probes=True),
               dict(mask_from_probes=True, hard_mask=False),
               dict(mask_from_probes=True, field_expert=0)):
        got = TMO.render_rays_occ(tp, tcfg, tst, tocc, torch.tensor(rays), 8,
                                  **kw)
        with jax.disable_jit():
            want = JMO.render_rays_occ(jp, cfg, jst, jocc, jnp.asarray(rays),
                                       8, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)


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
        " 'utils.optim', 'utils.tree', 'ops.losses', 'ops.color_space',"
        " 'models.baked', 'models.occupancy', 'ops.volrend',"
        " 'pipelines.online.runtime_adapt', 'ops.encodings',"
        " 'data.image_metadata', 'data.ram_rays', 'data.dataset',"
        " 'data.task_dataset', 'data.loaders', 'utils.logging',"
        " 'utils.checkpoint', 'utils.config', 'pipelines.offline.trainer',"
        " 'utils.metrics', 'runner', 'data.native',"
        " 'pipelines.video_gen')}\n"
        "from nerfsys_tpu_torch.models import occupancy as mo\n"
        "from nerfsys_tpu_torch.pipelines.online import runtime_adapt as ra\n"
        "assert all(hasattr(mo, f) for f in ('probe_rays_occ',"
        " 'render_rays_occ_dead', 'render_rays_occ_et_partial',"
        " 'render_rays_occ_et_resume', 'build_union_probe_grid',"
        " 'union_probe_fns', 'occ_sample_positions'))\n"
        "assert all(hasattr(ra, f) for f in ('TwoWaveOccRenderer',"
        " 'EarlyStopOccRenderer', 'two_wave_dispatch',"
        " 'CoherentExpertRenderer', 'make_coherent_renderer',"
        " 'coherent_dispatch', 'make_live_camera_renderer'))\n"
        "assert all(hasattr(mo, f) for f in ('make_occ_update_fn',"
        " 'premark_invisible_expert_cells', 'expert_render_step_sizes'))\n"
        "from nerfsys_tpu_torch.models import container as co\n"
        "assert all(hasattr(co, f) for f in ('bucket_dispatch_plain',"
        " 'bucket_combine_plain', 'bucket_combine_bwd_plain',"
        " 'coherent_expert_plain', 'routing_coherent_expert',"
        " 'container_density'))\n"
        "from nerfsys_tpu_torch.ops import encodings as enc\n"
        "assert all(hasattr(enc, f) for f in ('HashGridConfig', 'HashEncode',"
        " 'hash_encode_plain', 'hash_encode_packed_plain',"
        " 'hash_encode_bwd_plain'))\n"
        "from nerfsys_tpu_torch import runner\n"
        "assert all(hasattr(runner, f) for f in ('container_config_from_args',"
        " 'optim_config_from_args', 'meta_config_from_args',"
        " 'occ_config_from_args', 'build_context', 'train', 'evaluate',"
        " '_load_params_from_checkpoint', 'main'))\n"
        "assert all(hasattr(ra, f) for f in ('make_adapt_step',"
        " 'runtime_adapt', 'runtime_evaluate'))\n"
        "from nerfsys_tpu_torch.utils import checkpoint as ck, metrics as me\n"
        "assert all(hasattr(ck, f) for f in ('load_model_checkpoint',"
        " 'load_flax_tree'))\n"
        "assert all(hasattr(me, f) for f in ('ssim', 'lpips',"
        " 'load_lpips_weights', 'psnr'))\n"
        "from nerfsys_tpu_torch.data import loaders as lo\n"
        "assert hasattr(lo, 'EpochBatchSampler')\n"
        "from nerfsys_tpu_torch.data import native as na\n"
        "assert all(hasattr(na, f) for f in ('get_lib', 'native_available',"
        " 'compute_rays_native', 'compact_rays_native', 'route_rays_native',"
        " 'dda_route_native'))\n"
        "assert na._lib is None  # nothing is built at import time\n"
        "from nerfsys_tpu_torch.pipelines import video_gen as vg\n"
        "assert all(hasattr(vg, f) for f in ('render_video', 'suppress_fog',"
        " 'PATH_GENERATORS', 'write_video', 'poses_turntable_drb'))\n"
        "assert 'video' not in runner.UNPORTED_OPS\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in"
        " ('flax', 'optax', 'msgpack')]\n"
        "assert not bad, bad\n"
        "assert need <= set(mods), need - set(mods)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 32


def test_port_sources_name_neither_jax_nor_the_jax_package():
    """No import statement of the port's package or of its scripts names
    jax or the JAX package (nerfsys_tpu, not nerfsys_tpu_torch)."""
    import re
    from pathlib import Path

    root = Path(REPO)
    files = sorted((root / "nerfsys_tpu_torch").rglob("*.py")) + [
        root / name for name in ("chip_smoke.py", "serve_ab.py",
                                 "kernel_ab.py")]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|nerfsys_tpu)(\.|\s|$)")
    named = re.compile(r"import_module\(\s*[\"'](jax|nerfsys_tpu)[\"'.]")
    bad = [f"{f.relative_to(root)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line) or named.search(line)]
    assert len(files) > 30 and not bad, bad


def test_kernel_registry_covers_every_source():
    from pathlib import Path

    from nerfsys_tpu_torch import kernels

    srcs = {p.name for p in Path(kernels.CSRC).glob("*.cu")}
    assert srcs == {s for s, _ in kernels.SOURCES.values()}
    assert "baked.cu" in srcs and kernels.BAKED_TRILERP in kernels.KERNELS
    assert "--fmad=false" in kernels.SOURCES["baked"][1]
    assert "composite_seg.cu" in srcs and len(kernels.KERNELS) == 25
    assert len(kernels.SOURCES) == 15
    assert kernels.KERNELS[8] is kernels.COMPOSITE_SEG
    assert kernels.COMPOSITE_SEG.source.endswith("csrc/composite_seg.cu")
    assert kernels.KERNELS[9:12] == (kernels.HASH_FWD,
                                     kernels.HASH_FWD_PACKED,
                                     kernels.HASH_BWD)
    assert "--fmad=false" in kernels.SOURCES["hash_grid"][1]
    assert kernels.KERNELS[12:17] == (kernels.BUCKET_DISPATCH,
                                      kernels.BUCKET_COMBINE_FWD,
                                      kernels.BUCKET_COMBINE_BWD,
                                      kernels.COHERENT_EXPERT,
                                      kernels.OCC_QUERY)
    # the second-order products of second-order MAML: 4'' builds like 4'
    # (contracted), 5'' and 6'' like 5 and 6 (--fmad=false)
    assert kernels.KERNELS[17:20] == (kernels.VOLREND_BWD2,
                                      kernels.PLANES_BWD2_LIGHT,
                                      kernels.PLANES_BWD2)
    assert kernels.VOLREND_BWD2.source.endswith("csrc/volrend_bwd2.cu")
    assert kernels.SOURCES["volrend_bwd2"][1] == kernels.SOURCES[
        "volrend_bwd"][1]
    for k in kernels.KERNELS[18:20]:
        assert k.source.endswith("csrc/planes_bwd2.cu")
        assert k.replaces.startswith("nerfsys_tpu/ops/planes.py:")
    assert "--fmad=false" in kernels.SOURCES["planes_bwd2"][1]
    # row 12, trunc_exp: forward, backward and the backward's VJP, built
    # --fmad=false (bit-equal to the plain version)
    assert kernels.KERNELS[20:23] == (kernels.TRUNC_EXP_FWD,
                                      kernels.TRUNC_EXP_BWD,
                                      kernels.TRUNC_EXP_BWD2)
    for k in kernels.KERNELS[20:23]:
        assert k.source.endswith("csrc/activations.cu")
        assert k.replaces.startswith("nerfsys_tpu/ops/activations.py:")
    assert "--fmad=false" in kernels.SOURCES["activations"][1]
    # kernels 1b and 5b, the bfloat16 line matmuls: kernels 1 and 5's
    # sources, built --fmad=false (products of bfloat16 values are exact)
    assert kernels.KERNELS[23:] == (kernels.PLANES_FWD_LINES_BF16,
                                    kernels.PLANES_BWD_LIGHT_LINES_BF16)
    assert kernels.PLANES_FWD_LINES_BF16.source == kernels.PLANES_FWD.source
    assert (kernels.PLANES_BWD_LIGHT_LINES_BF16.source
            == kernels.PLANES_BWD_LIGHT.source)
    for k in kernels.KERNELS[23:]:
        assert k.replaces.startswith("nerfsys_tpu/ops/planes.py:")
    assert kernels.OCC_QUERY.source.endswith("csrc/occ_query.cu")
    assert "--fmad=false" in kernels.SOURCES["occ_query"][1]
    assert kernels.OCC_QUERY.replaces.startswith(
        "nerfsys_tpu/ops/occupancy.py:")
    for k in kernels.KERNELS[12:15]:
        assert k.source.endswith("csrc/bucket.cu")
        assert k.replaces.startswith("nerfsys_tpu/models/container.py:")
    assert kernels.COHERENT_EXPERT.source.endswith("csrc/coherent.cu")
    assert kernels.COHERENT_EXPERT.replaces.startswith(
        "nerfsys_tpu/models/container.py:198")
    for stem in ("bucket", "coherent"):
        assert "--fmad=false" in kernels.SOURCES[stem][1]
    for k in kernels.KERNELS[9:12]:
        assert k.source.endswith("csrc/hash_grid.cu")
        assert k.replaces.startswith("nerfsys_tpu/ops/encodings.py:")
    assert kernels.COMPOSITE_SEG.replaces.startswith(
        "nerfsys_tpu/ops/volrend.py:153")
    assert {k.stem for k in kernels.KERNELS} == set(kernels.SOURCES)
    for k in kernels.KERNELS:
        assert Path(REPO, k.source).is_file()
        assert k.replaces.startswith("nerfsys_tpu/")
    kernels.reset_launches()
    assert set(kernels.launches().values()) == {0}
    # the build hash follows the flags: --fmad=false builds are distinct
    assert kernels._lib_path("occ_probe") != kernels._lib_path("planes")
