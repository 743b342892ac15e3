"""Port parity of the hash-grid slice (nerfsys_tpu_torch.ops.encodings hash
section, the hash expert, and the serve / train / bake paths through it)
against the JAX package on the CPU.

Tables, params, grids, rays and points come from numpy seeds at a small
size: K=2 experts, hash L=4 F=2 log2_hashmap_size 10-12 min_res 4 max_res
32, hidden 16. On CPU tensors the kernel wrappers run their plain versions.
JAX runs eagerly (`jax.disable_jit()`) wherever a grid cell is selected:
jitted XLA on the CPU contracts x * scale + 0.5 and the Smoothstep weight
into fused multiply-adds, which can move a point into the neighbouring
cell (at a hashed level an unrelated row) and moves weights by ulps.

Tolerances, each stated where it is used:
  - config helpers, tcnn param layout, corner rows: exact;
  - corner weights: exact (the same float operations, one rounding each);
  - forward (fp32 and packed): 1e-6 of the output's max (XLA sums the 8
    corner products as a matmul over the (N, L*8) row, in its own order);
  - table gradient: 1e-5 of the gradient's max (scatter-adds of hundreds
    of shares per row, in another order);
  - container fields, frames and bakes: 1e-5 (float32 MLPs summed in
    another order).
The FoMAML step through hash experts is in tests/test_torch_hash_train.py
(its eager JAX side alone compiles for about a minute).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import baked as JB
from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops import encodings as JE
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.models import baked as TB
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.models import ngp as TN
from nerfsys_tpu_torch.ops import encodings as TE
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from nerfsys_tpu_torch.utils import interop
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

SMALL = dict(levels=4, min_res=4, max_res=32, log2_hashmap_size=10)
FWD_TOL = 1e-6  # of the output's max: XLA's corner-sum order
GRAD_TOL = 1e-5  # of the gradient's max: scatter-add order


def _cfgs(**kw):
    """(reference HashGridConfig, port HashGridConfig) with the same
    fields."""
    return JE.HashGridConfig(**kw), TE.HashGridConfig(**kw)


def _points(n, seed=0, faces=True):
    """Points in [0,1]^3: random, plus points on the level lattices' cell
    faces (multiples of 1/32 and 1/(s - 1)), at eps, 1 - eps, 0 and 1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1e-6, 1 - 1e-6, (n, 3)).astype(np.float32)
    if faces:
        m = n // 4
        x[:m] = rng.integers(0, 33, (m, 3)) / np.float32(32)
        x[m:2 * m] = (rng.integers(0, 7, (m, 3)) + 0.5) / np.float32(6.0)
        x[2 * m:2 * m + 8] = 1e-6
        x[2 * m + 8:2 * m + 16] = 1 - 1e-6
        x[2 * m + 16:2 * m + 20] = 0.0
        x[2 * m + 20:2 * m + 24] = 1.0
    return x.astype(np.float32)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --------------------------- configuration -----------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(tcnn_layout=True), dict(SMALL), dict(SMALL, tcnn_layout=True),
    dict(levels=16, log2_hashmap_size=20, tcnn_layout=True),
    dict(levels=1, min_res=8, max_res=8),
])
def test_config_helpers_match_jax_exactly(kw):
    jc, tc = _cfgs(**kw)
    assert (tc.table_size, tc.out_dim) == (jc.table_size, jc.out_dim)
    assert tc.growth_factor == jc.growth_factor
    for name in ("level_scales", "level_resolutions", "level_dense_mask"):
        got, want = getattr(tc, name)(), getattr(jc, name)()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if tc.tcnn_layout:
        for got, want in zip(TE.tcnn_param_layout(tc),
                             JE.tcnn_param_layout(jc)):
            np.testing.assert_array_equal(got, want)
    else:
        with pytest.raises(ValueError):
            TE.tcnn_param_layout(tc)


# --------------------------- indices and weights -----------------------------
@pytest.mark.parametrize("tcnn", [False, True])
@pytest.mark.parametrize("mode", ["Linear", "Smoothstep"])
def test_indices_and_weights_match_jax_exactly(tcnn, mode):
    """Rows bit for bit (integer equality) and weights exactly, at points
    on cell faces and at the domain's edges too (tcnn: L=5 with dense
    coarse levels and hashed fine ones)."""
    kw = dict(SMALL, interpolation=mode, tcnn_layout=tcnn)
    if tcnn:
        kw.update(levels=5, max_res=64)
    jc, tc = _cfgs(**kw)
    if tcnn:
        assert 0 < tc.level_dense_mask().sum() < tc.levels
    x = _points(400, seed=1)
    with jax.disable_jit():
        jidx, jw = JE._encode_indices_weights(jnp.asarray(x), jc)
    idx, w = TE.encode_indices_weights(torch.from_numpy(x), tc)
    assert idx.dtype == torch.int64 and idx.shape == jidx.shape
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert int(idx.max()) < tc.levels * tc.table_size


# --------------------------- forward ------------------------------------------
@pytest.mark.parametrize("tcnn,mode", [
    (False, "Linear"), (False, "Smoothstep"), (True, "Linear"),
    (True, "Smoothstep"), (False, "Nearest")])
def test_plain_forward_matches_jax(tcnn, mode):
    """hash_encode_plain against hash_grid_encode_fused (Nearest: its
    hash_grid_encode branch), one expert and K=2 stacked."""
    jc, tc = _cfgs(**SMALL, interpolation=mode, tcnn_layout=tcnn)
    rng = np.random.default_rng(2)
    tables = rng.uniform(-1, 1, (2, 4 * 1024, 2)).astype(np.float32)
    x = np.stack([_points(300, seed=3), _points(300, seed=4)])
    with jax.disable_jit():
        want = np.stack([np.asarray(JE.hash_grid_encode_fused(
            jnp.asarray(tables[k]), jnp.asarray(x[k]), jc)) for k in (0, 1)])
        oracle = np.asarray(JE.hash_grid_encode(
            jnp.asarray(tables[0]), jnp.asarray(x[0]), jc))
    got = TE.hash_encode_plain(torch.from_numpy(tables), torch.from_numpy(x),
                               tc).numpy()
    assert got.shape == (2, 300, 8)
    assert _max_rel(got, want) <= FWD_TOL
    # the reference's own unfused version (Linear branch: the test oracle)
    assert _max_rel(got[0], oracle) <= FWD_TOL
    one = TE.hash_encode_plain(torch.from_numpy(tables[1]),
                               torch.from_numpy(x[1]).reshape(20, 15, 3), tc)
    assert one.shape == (20, 15, 8)
    np.testing.assert_array_equal(one.reshape(300, 8).numpy(), got[1])


def test_nearest_rounds_ties_to_even():
    """Points whose scaled coordinate is exactly k + 0.5 at some level: the
    port matches jnp.round (half to even), which differs there from
    rounding half away from zero."""
    jc, tc = _cfgs(**SMALL, interpolation="Nearest")
    scales = tc.level_scales()
    ties, parities = [], set()
    for s in scales:
        for k in range(int(s)):
            v = np.float32((k + 0.5) / float(s))
            if np.float32(v * s) == np.float32(k + 0.5):
                ties.append(v)
                parities.add(k % 2)
    assert parities == {0, 1}
    t = np.array(ties, np.float32)
    x = np.stack([t, t[::-1], np.roll(t, 3)], -1)
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (4 * 1024, 2)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(JE.hash_grid_encode(jnp.asarray(table),
                                              jnp.asarray(x), jc))
    got = TE.hash_encode_plain(torch.from_numpy(table), torch.from_numpy(x),
                               tc).numpy()
    np.testing.assert_array_equal(got, want)  # one row each: exact
    # half away from zero would read other rows at the even ties
    away = np.floor(x[:, None, :] * scales[:, None] + 0.5)
    even = np.round(x[:, None, :] * scales[:, None])
    assert (away != even).any()


def _unrounded_packed(table, x, tc):
    """The packed forward with the bf16 products summed unrounded: what a
    port that skipped the product rounding would compute."""
    packed = TE.pack_table_pairs(table)
    out = []
    for level in range(tc.levels):
        a0 = a1 = 0.0
        for row, w in TE.level_corners(x, tc, level):
            f0, f1 = TE.unpack_pairs(packed[row + level * tc.table_size])
            wb = w.to(torch.bfloat16).to(torch.float32)
            a0 = a0 + wb * f0.to(torch.float32)
            a1 = a1 + wb * f1.to(torch.float32)
        out += [a0, a1]
    return torch.stack(out, -1)


@pytest.mark.parametrize("tcnn,mode", [(False, "Linear"),
                                       (True, "Smoothstep")])
def test_packed_plain_matches_jax_and_rounds_products(tcnn, mode):
    """hash_encode_packed_plain against hash_grid_encode_packed to 1e-6 of
    the max; a version that skips rounding the bf16 products is more than
    ten times that away, so the check tells them apart."""
    jc, tc = _cfgs(**SMALL, interpolation=mode, tcnn_layout=tcnn,
                   packed=True)
    rng = np.random.default_rng(6)
    table = rng.uniform(-1, 1, (4 * 1024, 2)).astype(np.float32)
    x = _points(500, seed=7)
    with jax.disable_jit():
        want = np.asarray(JE.hash_grid_encode_packed(jnp.asarray(table),
                                                     jnp.asarray(x), jc))
        fp32 = np.asarray(JE.hash_grid_encode_fused(jnp.asarray(table),
                                                    jnp.asarray(x), jc))
    tt, tx = torch.from_numpy(table), torch.from_numpy(x)
    got = TE.hash_encode_packed_plain(tt, tx, tc).numpy()
    assert _max_rel(got, want) <= FWD_TOL
    assert _max_rel(_unrounded_packed(tt, tx, tc).numpy(), want) > 10 * FWD_TOL
    assert _max_rel(fp32, want) > 10 * FWD_TOL  # bf16 reads matter too
    # the packed table is the reference's uint32 pairs, bit for bit
    np.testing.assert_array_equal(
        TE.pack_table_pairs(tt).numpy(),
        np.asarray(JE.pack_table_pairs(jnp.asarray(table))).astype(np.int64))
    f0, f1 = TE.unpack_pairs(TE.pack_table_pairs(tt))
    assert torch.equal(torch.stack([f0, f1], -1), tt.to(torch.bfloat16))


# --------------------------- table gradient -----------------------------------
@pytest.mark.parametrize("tcnn,mode,packed", [
    (False, "Linear", False), (True, "Smoothstep", False),
    (False, "Nearest", False), (False, "Linear", True),
    (True, "Smoothstep", True)])
def test_table_gradient_matches_jax(tcnn, mode, packed):
    """hash_encode_bwd_plain, and autograd through hash_encode (the kernel
    wrapper on CPU tensors), against jax.grad of the fused or packed
    encode (the packed VJP scatters with the float32 weights)."""
    jc, tc = _cfgs(**SMALL, interpolation=mode, tcnn_layout=tcnn,
                   packed=packed)
    rng = np.random.default_rng(8)
    table = rng.uniform(-1, 1, (4 * 1024, 2)).astype(np.float32)
    x = _points(400, seed=9)
    ct = rng.normal(size=(400, 8)).astype(np.float32)
    enc = JE.hash_grid_encode_packed if packed else JE.hash_grid_encode_fused
    with jax.disable_jit():
        want = np.asarray(jax.grad(lambda t: (enc(t, jnp.asarray(x), jc)
                                              * ct).sum())(jnp.asarray(table)))
    tx, tct = torch.from_numpy(x), torch.from_numpy(ct)
    plain = TE.hash_encode_bwd_plain(tx, tct, tc, (4 * 1024, 2))
    assert _max_rel(plain.numpy(), want) <= GRAD_TOL
    tt = torch.from_numpy(table).requires_grad_(True)
    (TE.hash_encode(tt, tx, tc, packed=packed) * tct).sum().backward()
    assert _max_rel(tt.grad.numpy(), want) <= GRAD_TOL
    assert (want != 0).sum() > 100


def test_stacked_table_gradient_and_kernel_path_on_cpu():
    """K=2 stacked tables: one expert's gradient lands in its own slab; the
    kernel wrappers on CPU tensors equal the plain versions exactly."""
    _, tc = _cfgs(**SMALL)
    rng = np.random.default_rng(10)
    tables = torch.from_numpy(rng.uniform(-1, 1, (2, 4096, 2)).astype(
        np.float32))
    x = torch.from_numpy(np.stack([_points(100, 11), _points(100, 12)]))
    ct = torch.from_numpy(rng.normal(size=(2, 100, 8)).astype(np.float32))
    assert torch.equal(TE.hash_encode_kernel(tables, x, tc),
                       TE.hash_encode_plain(tables, x, tc))
    g = TE.hash_encode_bwd_kernel(x, ct, tc, tables.shape)
    for k in (0, 1):
        gk = TE.hash_encode_bwd_plain(x[k], ct[k], tc, (4096, 2))
        assert torch.equal(g[k], gk)
    t = tables.clone().requires_grad_(True)
    plain = TE.hash_encode(t, x, tc, use_kernels=False)
    (plain * ct).sum().backward()
    assert torch.equal(t.grad, g)


def test_hash_encode_guards():
    _, tc = _cfgs(**SMALL)
    table = torch.zeros(4096, 2)
    x = torch.rand(10, 3)
    with pytest.raises(RuntimeError, match="positions"):
        TE.hash_encode(table, x.clone().requires_grad_(True), tc)
    with pytest.raises(RuntimeError, match="no backward"):
        TE.hash_encode_kernel(table.clone().requires_grad_(True), x, tc)
    with pytest.raises(ValueError):
        TE.hash_encode(torch.zeros(4096, 4), x, tc)  # F does not match
    with pytest.raises(ValueError):  # stacked tables need (K, N, 3)
        TE.hash_encode(torch.zeros(2, 4096, 2), x, tc)
    tc4 = TE.HashGridConfig(**SMALL, features_per_level=4)
    with pytest.raises(ValueError, match="packed"):  # packed needs F == 2
        TE.hash_encode(torch.zeros(4096, 4), x, tc4, packed=True)
    with pytest.raises(ValueError):
        TE.HashGridConfig(interpolation="Cubic")
    near_tc = TE.HashGridConfig(**SMALL, interpolation="Nearest",
                                tcnn_layout=True)
    with pytest.raises(NotImplementedError):
        TE.hash_encode(table, x, near_tc)
    with pytest.raises(NotImplementedError):  # as the reference
        JE.hash_grid_encode(jnp.zeros((4096, 2)), jnp.zeros((10, 3)),
                            JE.HashGridConfig(**SMALL, interpolation="Nearest",
                                              tcnn_layout=True))
    for bad in (dict(features_per_level=3), dict(levels=33),
                dict(log2_hashmap_size=31)):
        with pytest.raises(ValueError):
            TE._level_table(dataclasses.replace(tc, **bad))
    lv = TE._level_table(TE.HashGridConfig(**SMALL, tcnn_layout=True,
                                           interpolation="Smoothstep"))
    assert (lv.levels, lv.log2_size, lv.tcnn, lv.mode) == (4, 10, 1, 1)
    assert list(lv.scale)[:4] == [float(s) for s in
                                  _cfgs(**SMALL, tcnn_layout=True)[1]
                                  .level_scales()]


# --------------------------- the hash expert ----------------------------------
def test_ngp_config_defaults_to_hash_like_the_reference():
    jn, tn = JN.NGPConfig(), TN.NGPConfig()
    assert tn.xyz_encoding == jn.xyz_encoding == "hash"
    assert dataclasses.asdict(tn.hash) == dataclasses.asdict(jn.hash)
    assert tn.xyz_enc_dim == jn.xyz_enc_dim == 32
    small = dict(hidden=16, color_hidden=16, color_depth=2, geo_feat_dim=7)
    jcfg = JN.NGPConfig(**small, hash=JE.HashGridConfig(**SMALL))
    tcfg = TN.NGPConfig(**small, hash=TE.HashGridConfig(**SMALL))
    want = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda k: JN.init_ngp_params(k, jcfg),
                       jax.random.PRNGKey(0)))
    own = TN.init_ngp_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    got = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                 interop.tree_to_numpy(own))
    assert got == want
    t = own["hash_table"]
    assert float(t.abs().max()) <= 1e-3 and float(t.abs().max()) > 5e-4


def _runner_cfg(*flags):
    from nerfsys_tpu.runner import container_config_from_args
    from nerfsys_tpu.utils.config import parse_args

    P = parse_args(list(flags))
    P.boundary_margin_effective = 1.1
    P.cluster_2d = True
    return container_config_from_args(P)


@pytest.mark.parametrize("flags", [(), ("--packed_gather",),
                                   ("--hash_tcnn_layout",)])
def test_runner_default_config_carries_over(flags):
    """The runner's flag defaults (K=4, hash L=16 F=2 T=20, 16-4096, Linear,
    hidden 64, depths 2, geo 15, bg 32) through container_config_from_jax,
    with --packed_gather and --hash_tcnn_layout."""
    cfg = _runner_cfg(*flags)
    tcfg = interop.container_config_from_jax(cfg)
    assert tcfg.expert.xyz_encoding == "hash"
    assert dataclasses.asdict(tcfg.expert.hash) == dataclasses.asdict(
        cfg.expert.hash)
    assert (tcfg.expert.hash.levels, tcfg.expert.hash.log2_hashmap_size,
            tcfg.expert.hash.packed, tcfg.expert.hash.tcnn_layout) == (
        16, 20, "--packed_gather" in flags, "--hash_tcnn_layout" in flags)
    for key in ("hidden", "sigma_depth", "color_hidden", "color_depth",
                "geo_feat_dim", "sh_levels"):
        assert getattr(tcfg.expert, key) == getattr(cfg.expert, key)
    assert (tcfg.num_experts, tcfg.bg_hidden, tcfg.boundary_margin) == (
        cfg.num_experts, cfg.bg_hidden, cfg.boundary_margin)
    assert tcfg.expert.xyz_enc_dim == cfg.expert.xyz_enc_dim == 32


def _lin(rng, i, o, lead):
    s = 1.0 / np.sqrt(i)
    return {"w": rng.uniform(-s, s, (*lead, i, o)).astype(np.float32),
            "b": rng.uniform(-s, s, (*lead, o)).astype(np.float32)}


def _setup(seed=0, K=2, sigma_bias=-1.0, **hash_kw):
    """A K=2 hash container on both sides: tables uniform(-1, 1) (so the
    encoder's rounding reaches the output), numpy MLPs, an R=16 L=2
    occupancy state about 40% occupied."""
    rng = np.random.default_rng(seed)
    hkw = dict(SMALL, log2_hashmap_size=11)
    hkw.update(hash_kw)
    expert = JN.NGPConfig(hidden=16, sigma_depth=2, color_hidden=16,
                          color_depth=2, geo_feat_dim=7,
                          hash=JE.HashGridConfig(**hkw))
    cfg = JCo.ContainerConfig(num_experts=K, expert=expert,
                              boundary_margin=1.1, bg_hidden=8)
    lead = (K,)
    experts = {
        "hash_table": rng.uniform(-1, 1, (K, 4 * 2**hkw["log2_hashmap_size"],
                                          2)).astype(np.float32),
        "sigma_trunk": [_lin(rng, 8, 16, lead), _lin(rng, 16, 16, lead)],
        "sigma_head": _lin(rng, 16, 1, lead),
        "geo_head": _lin(rng, 16, 7, lead),
        "color_mlp": [_lin(rng, 23, 16, lead), _lin(rng, 16, 16, lead),
                      _lin(rng, 16, 3, lead)],
    }
    experts["sigma_head"]["b"][:] = sigma_bias
    params = {"experts": experts,
              "bg": {"l0": _lin(rng, 16, 8, ()), "l1": _lin(rng, 8, 3, ())}}
    cents = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)[:K]
    boxes = np.stack([np.stack([c - 1.2, c + 1.2]) for c in cents])
    gbox = np.array([[-2.5] * 3, [2.5] * 3], np.float32)
    binary = rng.uniform(size=(K, 2, 16, 16, 16)) < 0.4
    occ = {"binary": binary, "num_updates": np.int32(10),
           "occs": np.where(binary, rng.uniform(size=binary.shape),
                            0.0).astype(np.float32)}
    statics = SimpleNamespace(centroids=cents, expert_aabbs=boxes,
                              global_aabb=gbox)
    jax_side = (jax.tree_util.tree_map(jnp.asarray, params),
                JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                                     jnp.asarray(gbox)),
                {k: jnp.asarray(v) for k, v in occ.items()})
    port_side = (interop.container_params_from_jax(params, "cpu"),
                 interop.statics_from_jax(statics, "cpu"),
                 interop.occ_state_from_jax(occ, "cpu"))
    return (cfg, interop.container_config_from_jax(cfg), jax_side,
            port_side, params, statics, occ)


VARIANTS = {"floor": {}, "packed": dict(packed=True),
            "tcnn": dict(tcnn_layout=True),
            "nearest": dict(interpolation="Nearest")}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_container_apply_hash_matches_jax(variant):
    cfg, tcfg, (jp, jst, _), (tp, tst, _), *_ = _setup(**VARIANTS[variant])
    assert tcfg.expert.hash == TE.HashGridConfig(**dataclasses.asdict(
        cfg.expert.hash))
    rng = np.random.default_rng(13)
    x = rng.uniform(-2.4, 2.4, (400, 3)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    with jax.disable_jit():
        want = JCo.container_apply(jp, cfg, jst, jnp.asarray(x),
                                   jnp.asarray(d))
        want1 = JCo.container_apply(jp, cfg, jst, jnp.asarray(x),
                                    jnp.asarray(d), active_expert=1)
    got = TCo.container_apply(tp, tcfg, tst, torch.from_numpy(x),
                              torch.from_numpy(d))
    got1 = TCo.container_apply(tp, tcfg, tst, torch.from_numpy(x),
                               torch.from_numpy(d), active_expert=1)
    for g, w in ((got, want), (got1, want1)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
    assert float(got[1].std()) > 0.01  # the encoding reaches sigma
    own = TCo.init_container_params(tcfg, seed=0, device="cpu")
    assert own["experts"]["hash_table"].shape == tp["experts"][
        "hash_table"].shape
    assert TCo.param_group_labels(own)["experts"]["hash_table"] == "encoding"


def _camera(side=16, t=(0.1, -0.2, 2.0)):
    c2w = np.array([[1, 0, 0, t[0]], [0, 1, 0, t[1]], [0, 0, 1, t[2]]],
                   np.float32)
    return SimpleNamespace(H=side, W=side, c2w=c2w, intrinsics=np.array(
        [0.8 * side, 0.8 * side, side / 2, side / 2], np.float32))


@pytest.mark.parametrize("variant", ["floor", "packed"])
def test_hash_frame_matches_eager_jax(variant):
    """A 16x16 frame through make_chunk_renderer (soft one-shot,
    importance probing) and render_image, both sides eager, both on their
    native ray path (the same C++ source under the same flags: the same
    rays bit for bit, so no probe cell moves): 1e-5."""
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc), *_ = _setup(
        seed=1, **VARIANTS[variant])
    md = _camera()
    kw = dict(scene_aabb=np.asarray(jst.global_aabb), chunk_rays=96)
    rkw = dict(ray_samples=8, occ_importance=True, occ_hard_mask=False)
    with jax.disable_jit():
        want = JR.render_image(JR.make_chunk_renderer(cfg, occ_state=jocc,
                                                      **rkw), jp, jst, md,
                               **kw)
    got = TR.render_image(TR.make_chunk_renderer(tcfg, occ_state=tocc,
                                                 device="cpu", **rkw),
                          tp, tst, md, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert 0.05 < got[2].mean() < 0.99


def test_bake_hash_container_matches_jax():
    """A 16³ dense f32 bake (SH-2, 8 directions, pack 8) of the hash
    container, both sides eager: within 1e-5 of the table's max."""
    cfg, tcfg, (jp, jst, _), (tp, tst, _), *_ = _setup(seed=3)
    kw = dict(resolution=16, sh_levels=2, n_dirs=8, chunk_cells=1024,
              corner_pack=8, dtype="float32")
    with jax.disable_jit():
        want = JB.bake_field(jp, cfg, jst, JB.BakedConfig(**kw))
    got = TB.bake_field(tp, tcfg, tst, TB.BakedConfig(**kw), device="cpu")
    w = np.asarray(want["table"])
    assert got["table"].shape == w.shape
    np.testing.assert_allclose(got["table"].numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    assert np.abs(w).max() > 0
