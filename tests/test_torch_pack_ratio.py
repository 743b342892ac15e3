"""The live dispatcher's cost model under line matmuls, against the
reference's.

The two-wave dispatcher packs the alive rays of a frame into dense chunks
when packed_chunks * (1 + ratio) < alive_chunks, where the ratio is the
probe's gather rows over the field's (nerfsys_tpu/pipelines/online/
runtime_adapt.py:614-632 over utils/flops.py:157
`analytic_render_gather_rows_per_ray`). Under `lines_matmul` the
reference counts no gathered line rows (flops.py:192-194), so its ratio
rises (S=32, K=4, hard mask: 512 / 1,280 = 0.40 against 512 / 2,432 =
0.21 with gathered lines). The port's `_pack_cost_ratio` must equal the
reference's in every case, and a frame whose alive counts fall between
the two ratios must take the reference's mode.
"""
import dataclasses

import numpy as np
import pytest
from test_torch_early_stop import S, _rays_at, _world

from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu.utils.flops import analytic_render_gather_rows_per_ray
from nerfsys_tpu_torch.models.container import ContainerConfig
from nerfsys_tpu_torch.models.ngp import NGPConfig
from nerfsys_tpu_torch.ops.planes import PlaneEncodingConfig
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)


def _reference_ratio(S, K, active_expert, hard_mask, union_probe,
                     lines_matmul):
    """runtime_adapt.py:622-632 as the reference computes it."""
    probe_rows = 128.0 * (1 if union_probe or active_expert is not None
                          else K)
    total = analytic_render_gather_rows_per_ray(
        ray_samples=S, num_experts=K,
        experts_evaluated=1 if active_expert is not None else None,
        occ=True, occ_levels=4, union_probe=union_probe,
        hard_mask=hard_mask, lines_gathered=not lines_matmul)
    return probe_rows / max(total - probe_rows, 1.0)


def _cfg(K, lines_matmul, dtype="float32"):
    return ContainerConfig(num_experts=K, expert=NGPConfig(
        xyz_encoding="planes", planes=PlaneEncodingConfig(
            lines_matmul=lines_matmul, lines_mm_dtype=dtype)))


@pytest.mark.parametrize("S", [8, 32, 64])
@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("lines_matmul", [False, True])
def test_pack_ratio_equals_the_reference(S, K, lines_matmul):
    for active, hard, union in ((None, True, False), (None, False, False),
                                (None, True, True), (0, True, False)):
        want = _reference_ratio(S, K, active, hard, union, lines_matmul)
        for dtype in ("float32", "bfloat16"):  # both dtypes count no rows
            got = TR._pack_cost_ratio(_cfg(K, lines_matmul, dtype), S,
                                      active, hard, union)
            assert got == want, (active, hard, union, dtype, got, want)
    if (S, K) == (32, 4):
        assert TR._pack_cost_ratio(_cfg(4, lines_matmul), 32, None, True) \
            == (512 / 1280 if lines_matmul else 512 / 2432)


def test_two_wave_mode_follows_the_reference_under_line_matmuls():
    """K=2, S=12, hard mask: ratio 256/456 = 0.56 with gathered lines,
    256/240 = 1.07 with line matmuls. Four chunks of 64 rays, two of them
    half alive: 2 alive chunks, 1 packed chunk. 1 * 1.56 < 2 packs; 1 *
    2.07 >= 2 skips, which is the reference's mode under line matmuls."""
    cfg, tcfg, (_, _, jocc), (tp, tst, tocc) = _world()
    rng = np.random.default_rng(11)
    alive, dead = _rays_at(rng, 64, -1.0), _rays_at(rng, 192, 1.0)
    rays = np.concatenate([alive[:32], dead[:32], alive[32:], dead[32:]])
    modes = {}
    for mm in (False, True):
        jcfg = dataclasses.replace(cfg, expert=dataclasses.replace(
            cfg.expert, planes=dataclasses.replace(cfg.expert.planes,
                                                   lines_matmul=mm)))
        t_cfg = dataclasses.replace(tcfg, expert=dataclasses.replace(
            tcfg.expert, planes=dataclasses.replace(tcfg.expert.planes,
                                                    lines_matmul=mm)))
        kw = dict(ray_samples=S, occ_state=jocc, occ_importance=True)
        jren = JR.make_chunk_renderer(jcfg, **kw)
        tren = TR.make_chunk_renderer(t_cfg, **dict(kw, occ_state=tocc),
                                      device="cpu")
        assert tren.pack_cost_ratio == jren.pack_cost_ratio
        stats = {}
        out = TR.render_rays_chunked(tren, tp, tst, rays, 64, stats=stats)
        assert np.isfinite(out).all()
        assert (stats["alive_chunks"], -(-stats["n_alive"] // 64)) == (2, 1)
        # the reference's rule on its own ratio
        want = ("packed" if 1 * (1.0 + jren.pack_cost_ratio) < 2
                else "two_wave")
        assert stats["mode"] == want
        modes[mm] = (stats["mode"], out)
    assert modes[False][0] == "packed" and modes[True][0] == "two_wave"
    # float32 line matmuls compute the gathers' function: same frame
    np.testing.assert_allclose(modes[True][1], modes[False][1], rtol=0,
                               atol=1e-6)
