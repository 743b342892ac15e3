"""Port parity of baked snapshot serving: bake (dense, occupancy-skip,
sparse), the packers, the packed-corner trilinear lookup (kernel 8's plain
version), the baked renderers, on-device frame ray generation and the
snapshot format, each against the JAX package on the CPU.

Params (K=2 experts, planes L=2 base 8, F=4, hidden 8) and every grid come
from numpy seeds; JAX gets them as arrays and the port through
nerfsys_tpu_torch.utils.interop. The JAX bake jits its occupancy query and
field chunks, and jitted XLA on the CPU contracts multiply-adds (a cell
centre can move by an ulp), so it runs under `jax.disable_jit()` here, as
does the JAX camera renderer. Each test states its tolerance.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import baked as JB
from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.models.occupancy import union_binary_fn as j_union_binary
from nerfsys_tpu.ops import rays as JRays
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu.ops.scene_box import SceneBox as JSceneBox
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu_torch.models import baked as TB
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.models.occupancy import union_binary_fn
from nerfsys_tpu_torch.ops import rays as TRays
from nerfsys_tpu_torch.ops.scene_box import SceneBox
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from nerfsys_tpu_torch.utils import interop

GBOX = np.array([[-2.5] * 3, [2.5] * 3], np.float32)


def _lin(rng, i, o, lead):
    s = 1.0 / np.sqrt(i)
    return {"w": rng.uniform(-s, s, (*lead, i, o)).astype(np.float32),
            "b": rng.uniform(-s, s, (*lead, o)).astype(np.float32)}


def _setup(seed=0, K=2):
    """A tiny planes container and a ready occupancy state whose bottom
    35% of every level box is alive (so the top of the scene is dead)."""
    rng = np.random.default_rng(seed)
    expert = JN.NGPConfig(
        hidden=8, sigma_depth=1, color_hidden=8, color_depth=1,
        geo_feat_dim=3, xyz_encoding="planes",
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
        "sigma_trunk": [_lin(rng, 24, 8, lead)],
        "sigma_head": _lin(rng, 8, 1, lead),
        "geo_head": _lin(rng, 8, 3, lead),
        "color_mlp": [_lin(rng, 19, 8, lead), _lin(rng, 8, 3, lead)],
    }
    experts["sigma_head"]["b"][:] = 0.5
    np_params = {"experts": experts,
                 "bg": {"l0": _lin(rng, 16, 8, ()), "l1": _lin(rng, 8, 3, ())}}
    cents = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    boxes = np.stack([np.stack([c - 1.2, c + 1.2]) for c in cents])
    R, L = 8, 2
    binary = np.zeros((K, L, R, R, R), bool)
    for k in range(K):
        for lv in range(L):
            lo = boxes[k, 0, 2] * 2**lv
            hi = boxes[k, 1, 2] * 2**lv
            zc = lo + (np.arange(R) + 0.5) * (hi - lo) / R
            binary[k, lv, :, :, zc <= lo + 0.35 * (hi - lo)] = True
    occ = {"occs": np.where(binary, 0.1, 0.0).astype(np.float32),
           "binary": binary, "num_updates": np.int32(10),
           "ready_after": np.int32(1)}
    jax_side = (jax.tree_util.tree_map(jnp.asarray, np_params),
                JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                                     jnp.asarray(GBOX)),
                {k: jnp.asarray(v) for k, v in occ.items()})
    port_side = (interop.container_params_from_jax(np_params, "cpu"),
                 interop.statics_from_jax(
                     SimpleNamespace(centroids=cents, expert_aabbs=boxes,
                                     global_aabb=GBOX), "cpu"),
                 interop.occ_state_from_jax(occ, "cpu"))
    return cfg, interop.container_config_from_jax(cfg), jax_side, port_side


def _bits(a) -> np.ndarray:
    """Table -> numpy with bf16 as its uint16 bit patterns."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _to_jax_table(t: torch.Tensor):
    a = _bits(t)
    return jnp.asarray(a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16
                       else a)


def _rays(rng, n):
    o = np.tile([0.0, 0.0, 3.0], (n, 1)).astype(np.float32)
    o[:, :2] += rng.normal(scale=0.3, size=(n, 2))
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    d[:, :2] = rng.normal(scale=0.4, size=(n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nf = np.tile([0.5, 6.0], (n, 1)).astype(np.float32)
    rays = np.concatenate([o, d, nf], 1)
    rays[::7, 6:] = np.inf  # invalid rays render the background
    return rays


def _camera(side=16, t=(0.1, -0.2, 3.0)):
    c2w = np.array([[1, 0, 0, t[0]], [0, 1, 0, t[1]], [0, 0, 1, t[2]]],
                   np.float32)
    intr = np.array([0.8 * side, 0.8 * side, side / 2, side / 2], np.float32)
    return c2w, intr


def test_sh_projection_matrix_matches_jax():
    """Tolerance 1e-6: the same float32 solve on SH designs that agree to
    an ulp."""
    for n in (8, 16, 32):
        dirs = TB._fibonacci_sphere(n)
        np.testing.assert_array_equal(dirs, JB._fibonacci_sphere(n))
        for levels in (1, 2, 3):
            np.testing.assert_allclose(
                TB.sh_projection_matrix(levels, dirs),
                JB.sh_projection_matrix(levels, dirs), rtol=0, atol=1e-6)


def test_baked_config_matches_jax():
    import dataclasses

    for kw in ({}, {"resolution": 128, "sh_levels": 2},
               {"corner_pack": 4, "sparse_block": 8},
               {"resolution": 512, "dtype": "float32"},
               {"resolution": 256, "auto_pack_budget_gb": 1.0}):
        t, j = TB.BakedConfig(**kw), JB.BakedConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.n_bases, t.channels, t.padded_channels, t.resolved_pack(),
                t.row_width) == (j.n_bases, j.channels, j.padded_channels,
                                 j.resolved_pack(), j.row_width)
    # the viewer's default BakedConfig(resolution=256) resolves to pack 4
    assert TB.BakedConfig(resolution=256).resolved_pack() == 4
    for bad in ({"n_dirs": 4}, {"corner_pack": 3}, {"sparse_block": 1},
                {"resolution": 12, "sparse_block": 5}):
        with pytest.raises(ValueError):
            JB.BakedConfig(**bad)
        with pytest.raises(ValueError):
            TB.BakedConfig(**bad)


def test_query_binary_and_union_match_jax():
    """Exact: the same finest-level cell selection."""
    _, _, (_, jst, jocc), (_, tst, tocc) = _setup()
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    want = np.asarray(j_union_binary(jocc, jst)(jnp.asarray(pts)))
    got = union_binary_fn(tocc, tst)(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.95


def test_container_apply_multidir_matches_jax():
    """Tolerance 1e-5: the same MLPs, sums of K=2 weighted colors in
    another order."""
    cfg, tcfg, (jp, jst, _), (tp, tst, _) = _setup(seed=1)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2.4, 2.4, (700, 3)).astype(np.float32)
    dirs = TB._fibonacci_sphere(8)
    with jax.disable_jit():
        j_rgb, j_sigma = JCo.container_apply_multidir(
            jp, cfg, jst, jnp.asarray(pts), jnp.asarray(dirs))
    t_rgb, t_sigma = TCo.container_apply_multidir(
        tp, tcfg, tst, torch.from_numpy(pts), torch.from_numpy(dirs))
    assert tuple(t_rgb.shape) == (8, 700, 3)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(j_sigma),
                               rtol=1e-5, atol=1e-6)
    import dataclasses

    # bucketed dispatch falls back to one container_apply per direction
    with jax.disable_jit():
        jb_rgb, jb_sigma = JCo.container_apply_multidir(
            jp, dataclasses.replace(cfg, bucketed=True), jst,
            jnp.asarray(pts), jnp.asarray(dirs[:3]))
    tb_rgb, tb_sigma = TCo.container_apply_multidir(
        tp, dataclasses.replace(tcfg, bucketed=True), tst,
        torch.from_numpy(pts), torch.from_numpy(dirs[:3]))
    np.testing.assert_allclose(tb_rgb.numpy(), np.asarray(jb_rgb), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tb_sigma.numpy(), np.asarray(jb_sigma),
                               rtol=1e-5, atol=1e-6)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 at |x| (8 significant bits)."""
    ax = np.maximum(np.abs(x.astype(np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


@pytest.mark.parametrize("path,pack,dtype", [
    ("dense", 8, "float32"), ("dense", 4, "bfloat16"),
    ("occ", 2, "float32"), ("occ", 8, "bfloat16"),
    ("sparse", 8, "bfloat16"), ("sparse", 4, "float32"),
])
def test_bake_field_matches_jax(path, pack, dtype):
    """R=12, SH-2, 8 directions. f32 tables within 1e-5 of the table's
    max; bf16 tables >= 99.9% bit-identical and every entry within one
    bf16 ulp (a float32 value an ulp apart can round to the neighbouring
    bf16). The zero rows (dead cells, so the alive masks) and the block
    index are identical."""
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc) = _setup(seed=2)
    kw = dict(resolution=12, sh_levels=2, n_dirs=8, chunk_cells=700,
              corner_pack=pack, dtype=dtype,
              sparse_block=4 if path == "sparse" else 0)
    use_occ = path != "dense"
    with jax.disable_jit():
        want = JB.bake_field(jp, cfg, jst, JB.BakedConfig(**kw),
                             occ_state=jocc if use_occ else None,
                             occ_dilate=1)
    got = TB.bake_field(tp, tcfg, tst, TB.BakedConfig(**kw),
                        occ_state=tocc if use_occ else None, occ_dilate=1,
                        device="cpu")
    assert got["corner_pack"] == want["corner_pack"] == pack
    np.testing.assert_array_equal(got["aabb"].numpy(),
                                  np.asarray(want["aabb"]))
    g, w = _bits(got["table"]), _bits(want["table"])
    assert g.shape == w.shape and g.dtype == w.dtype
    if path == "sparse":
        np.testing.assert_array_equal(got["block_index"].numpy(),
                                      np.asarray(want["block_index"]))
        assert 0 < int((got["block_index"] > 0).sum()) < 27  # dead blocks
    gf = got["table"].to(torch.float32).numpy()
    wf = np.asarray(want["table"]).astype(np.float32)
    np.testing.assert_array_equal(gf == 0, wf == 0)
    if use_occ:
        assert (np.abs(gf).max(axis=1) == 0).any()  # dead cells were skipped
    if dtype == "float32":
        np.testing.assert_allclose(gf, wf, rtol=0,
                                   atol=1e-5 * np.abs(wf).max())
    else:
        assert np.mean(g == w) >= 0.999
        assert (np.abs(gf - wf) <= _bf16_ulp(np.maximum(np.abs(gf),
                                                        np.abs(wf)))).all()


def test_bake_alive_mask_matches_jax():
    """Exact: the occupancy query at the cell centres and the 3³ dilation
    of the reference (`union_binary_fn` + `_np_dilate3`)."""
    _, _, (_, jst, jocc), (_, tst, tocc) = _setup(seed=3)
    R = 12
    lo, hi = GBOX[0], GBOX[1]
    h = (hi - lo) / R
    centers = TB.cell_centers(R, torch.from_numpy(lo), torch.from_numpy(h))
    for dilate in (0, 1, 2):
        with jax.disable_jit():
            want = np.asarray(j_union_binary(jocc, jst)(
                jnp.asarray(centers.numpy()))).reshape(R, R, R)
        for _ in range(dilate):
            want = JB._np_dilate3(want)
        got = TB.bake_alive_mask(tocc, tst, centers, R, dilate)
        np.testing.assert_array_equal(got.numpy(), want)
    not_ready = dict(tocc, num_updates=torch.tensor(0, dtype=torch.int32))
    assert TB.bake_alive_mask(not_ready, tst, centers, R) is None


def _dense_np(vals_t, R, Cp, pack):
    """The reference's dense corner packing (bake_field :495-517)."""
    C = vals_t.shape[-1]
    g = np.zeros((R, R, R, Cp), vals_t.dtype)
    g[..., :C] = vals_t.reshape(R, R, R, C)
    clamped = np.minimum(np.arange(1, R + 1), R - 1)
    dense = np.empty((R, R, R, pack * Cp), vals_t.dtype)
    for bi, (dx, dy, dz) in enumerate(TB._deltas(pack)):
        b = g
        if dz:
            b = b.take(clamped, axis=2)
        if dy:
            b = b.take(clamped, axis=1)
        if dx:
            b = b.take(clamped, axis=0)
        dense[..., bi * Cp:(bi + 1) * Cp] = b
    return dense.reshape(R**3, pack * Cp)


@pytest.mark.parametrize("pack", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packers_bit_identical_to_jax(pack, dtype):
    """Exact: pack_dense against the reference's dense packing,
    pack_sparse against `_pack_sparse_from_vals`, compact_table against
    `_compact_np`, on values with dead cells and one f32 subnormal that the
    bf16 cast rounds to zero."""
    R, block = 12, 4
    rng = np.random.default_rng(11)
    jcfg = JB.BakedConfig(resolution=R, sh_levels=2, dtype=dtype,
                          corner_pack=pack, sparse_block=block)
    C, Cp = jcfg.channels, jcfg.padded_channels
    vals = rng.normal(size=(R, R, R, C)).astype(np.float32)
    vals[~(rng.uniform(size=(R, R, R)) < 0.15)] = 0.0
    vals[0, 0, 0, :] = 0.0
    vals[0, 0, 0, 1] = 1e-45
    vals_np = vals.reshape(-1, C).astype(np.dtype(jcfg.dtype))
    vals_t = torch.from_numpy(vals.reshape(-1, C)).to(
        TB.BakedConfig(dtype=dtype).table_dtype)
    np.testing.assert_array_equal(_bits(vals_t), _bits(vals_np))

    dense_np = _dense_np(vals_np, R, Cp, pack)
    dense_t = TB.pack_dense(vals_t, R, Cp, pack)
    np.testing.assert_array_equal(_bits(dense_t), _bits(dense_np))

    comp_j, idx_j = JB._pack_sparse_from_vals(vals_np, R, jcfg, pack)
    comp_t, idx_t = TB.pack_sparse(vals_t, R, block, Cp, pack)
    np.testing.assert_array_equal(_bits(comp_t), _bits(comp_j))
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)

    comp_jd, idx_jd = JB._compact_np(dense_np, jcfg)
    comp_td, idx_td = TB.compact_table(dense_t, R, block)
    np.testing.assert_array_equal(_bits(comp_td), _bits(comp_jd))
    np.testing.assert_array_equal(idx_td.numpy(), idx_jd)
    np.testing.assert_array_equal(_bits(comp_td), _bits(comp_t))


def _random_table(rng, R, Cp, pack, dtype, zero_blocks=(), block=4):
    """A random packed table of R³ rows with some sparse blocks zeroed."""
    table = rng.normal(size=(R, R, R, pack * Cp)).astype(np.float32)
    for bx, by, bz in zero_blocks:
        table[bx * block:(bx + 1) * block, by * block:(by + 1) * block,
              bz * block:(bz + 1) * block] = 0.0
    t = torch.from_numpy(table.reshape(R**3, pack * Cp))
    return t.to(TB.BakedConfig(dtype=dtype).table_dtype)


def _edge_points(lo, hi, rng, n=4096):
    """Uniform points in and around the box, plus its corners, faces and
    points just outside."""
    pts = [rng.uniform(lo - 0.3, hi + 0.3, (n, 3))]
    corners = np.array([[a, b, c] for a in (lo[0], hi[0])
                        for b in (lo[1], hi[1]) for c in (lo[2], hi[2])])
    pts.append(corners)
    face = rng.uniform(lo, hi, (64, 3))
    for ax in range(3):
        for v in (lo[ax], hi[ax], np.nextafter(hi[ax], np.float32(-9)),
                  hi[ax] + 1.0):
            f = face.copy()
            f[:, ax] = v
            pts.append(f)
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("R,pack,sparse,dtype", [
    (12, 8, False, "float32"), (12, 4, False, "bfloat16"),
    (12, 2, False, "float32"), (12, 8, True, "bfloat16"),
    (12, 4, True, "float32"), (12, 2, True, "bfloat16"),
    (64, 2, True, "float32"),  # float32(R - 1.000001) == R - 1 at R >= 64
])
def test_baked_trilerp_plain_matches_jax(R, pack, sparse, dtype):
    """Tolerance 1e-6 (absolute, payloads O(1)): the same cell selection
    and lerp tree as eager JAX, at points inside, on and outside the box."""
    rng = np.random.default_rng(R + pack)
    block = 4 if R == 12 else 8
    jcfg = JB.BakedConfig(resolution=R, sh_levels=2, dtype=dtype,
                          corner_pack=pack, sparse_block=block if sparse
                          else 0)
    Cp, Rb = jcfg.padded_channels, R // block
    if R == 64:  # only the blocks at the top corner of the box are alive
        alive = {(Rb - 1, Rb - 1, Rb - 1), (Rb - 1, Rb - 2, Rb - 1)}
        vals = torch.zeros((R**3, jcfg.channels))
        cells = torch.arange(R**3)
        x, y, z = cells // (R * R), (cells // R) % R, cells % R
        keep = torch.zeros(R**3, dtype=torch.bool)
        for bx, by, bz in alive:
            keep |= ((x // block == bx) & (y // block == by)
                     & (z // block == bz))
        vals[keep] = torch.from_numpy(rng.normal(
            size=(int(keep.sum()), jcfg.channels)).astype(np.float32))
        comp, index = TB.pack_sparse(vals, R, block, Cp, pack)
        tb = {"table": comp, "block_index": index}
    else:
        zero = [(bx, by, bz) for bx in range(Rb) for by in range(Rb)
                for bz in range(Rb) if (bx + 2 * by + 3 * bz) % 2]
        table = _random_table(rng, R, Cp, pack, dtype, zero, block)
        tb = {"table": table}
        if sparse:
            tb["table"], tb["block_index"] = TB.compact_table(table, R,
                                                              block)
    lo = np.array([-1.0, -0.5, -1.5], np.float32)
    hi = np.array([1.0, 1.5, 0.5], np.float32)
    tb["aabb"] = torch.from_numpy(np.stack([lo, hi]))
    jb = {"table": _to_jax_table(tb["table"]), "aabb": jnp.asarray(
        np.stack([lo, hi]))}
    if sparse:
        jb["block_index"] = jnp.asarray(tb["block_index"].numpy())
    pts = _edge_points(lo, hi, rng)
    if R == 64:  # most points where the alive blocks are
        pts = np.concatenate([pts, rng.uniform(hi - 0.1, hi + 0.1,
                                               (2048, 3))]).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(JB.baked_trilerp(jb, jcfg, jnp.asarray(pts)))
    tcfg = TB.BakedConfig(**{k: getattr(jcfg, k) for k in (
        "resolution", "sh_levels", "dtype", "corner_pack", "sparse_block")})
    got = TB.baked_trilerp(tb, tcfg, torch.from_numpy(pts)).numpy()
    assert got.shape == (pts.shape[0], jcfg.channels)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the kernel wrapper takes the plain version for CPU tensors
    ker = TB.baked_trilerp_kernel(
        tb["table"], tb["aabb"], torch.from_numpy(pts), R, jcfg.channels,
        Cp, pack, tb.get("block_index"), block if sparse else 0)
    np.testing.assert_array_equal(ker.numpy(), got)
    with pytest.raises(ValueError):  # sparsity must match the config
        wrong = TB.BakedConfig(resolution=R, sh_levels=2, dtype=dtype,
                               corner_pack=pack,
                               sparse_block=0 if sparse else block)
        TB.baked_trilerp(tb, wrong, torch.from_numpy(pts))


def _bake_pair(seed, **kw):
    cfg, tcfg, jax_side, port_side = _setup(seed=seed)
    tcfg_b = TB.BakedConfig(resolution=12, sh_levels=2, n_dirs=8, **kw)
    baked = TB.bake_field(port_side[0], tcfg, port_side[1], tcfg_b,
                          occ_state=port_side[2], occ_dilate=1, device="cpu")
    jbaked = {"table": _to_jax_table(baked["table"]),
              "aabb": jnp.asarray(baked["aabb"].numpy()),
              "corner_pack": baked["corner_pack"]}
    if "block_index" in baked:
        jbaked["block_index"] = jnp.asarray(baked["block_index"].numpy())
    jcfg_b = JB.BakedConfig(resolution=12, sh_levels=2, n_dirs=8, **kw)
    return (cfg, tcfg, jax_side, port_side, (jbaked, jcfg_b),
            (baked, tcfg_b))


@pytest.mark.parametrize("kw", [
    dict(dtype="float32", corner_pack=8),
    dict(dtype="bfloat16", corner_pack=4, sparse_block=4),
])
def test_render_rays_baked_matches_jax(kw):
    """Tolerance 1e-5 on every output (depth too, t up to 6): the same
    table, the same lookups; the SH contraction and the compositor sum in
    another order."""
    cfg, tcfg, (jp, _, _), (tp, _, _), (jb, jc), (tb, tc) = _bake_pair(4,
                                                                       **kw)
    rays = _rays(np.random.default_rng(5), 100)
    with jax.disable_jit():
        want = JB.render_rays_baked(jb, jc, jnp.asarray(rays), 12,
                                    bg_fn=JCo.container_bg_fn(jp, cfg))
    got = TB.render_rays_baked(tb, tc, torch.from_numpy(rays), 12,
                               bg_fn=TCo.container_bg_fn(tp, tcfg))
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol)
    acc = got[3].numpy()
    assert 0.05 < acc.mean() < 0.95 and (acc[::7] == 0).all()
    with jax.disable_jit():
        jq = JB.baked_query(jb, jc, jnp.asarray(rays[:, :3]),
                            jnp.asarray(rays[:, 3:6]))
    tq = TB.baked_query(tb, tc, torch.from_numpy(rays[:, :3]),
                        torch.from_numpy(rays[:, 3:6]))
    for g, w in zip(tq, jq):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("box", [True, False])
def test_frame_chunk_rays_matches_jax(box):
    """Tolerance 1e-6 on directions and origins, 1e-6 relative on near /
    far: the same pixel arithmetic, a 3x3 product and a norm summed in
    another order. Pixels past H*W-1 clamp to the last one."""
    H, W = 16, 20
    c2w, intr = _camera()
    c2w[:3, :3] = np.array([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]])
    kw = dict(near_override=0.7, far_override=5.0)
    for start, count in ((0, 64), (100, 64), (290, 64)):
        if box:
            jkw = dict(scene_box=JSceneBox(jnp.asarray(GBOX)))
            tkw = dict(scene_box=SceneBox(torch.from_numpy(GBOX)))
        else:
            jkw = tkw = dict(near=0.5, far=4.0)
        want = np.asarray(JRays.frame_chunk_rays(
            jnp.asarray(c2w), jnp.asarray(intr), jnp.int32(start), count, H,
            W, **jkw, **kw))
        got = TRays.frame_chunk_rays(
            torch.from_numpy(c2w), torch.from_numpy(intr), start, count, H,
            W, **tkw, **kw).numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                                   atol=1e-6)
        assert fin[:, 6].any()
        for bias in (0.0, 0.3):
            want_b = np.asarray(JR.frame_chunk_rays_biased(
                jnp.asarray(c2w), jnp.asarray(intr), jnp.int32(start), count,
                H, W, near_bias=bias, **{"scene_box": None, "near": None,
                                         "far": None, **jkw}, **kw))
            got_b = TR.frame_chunk_rays_biased(
                torch.from_numpy(c2w), torch.from_numpy(intr), start, count,
                H, W, near_bias=bias, **{"scene_box": None, "near": None,
                                         "far": None, **tkw}, **kw).numpy()
            np.testing.assert_allclose(got_b, want_b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["u8", "f32"])
def test_baked_camera_renderer_matches_jax(variant):
    """A 16x16 frame, camera pose in. uint8: every pixel within 1 level of
    JAX's (the tonemap truncates, so a 1e-7 difference can cross a level);
    float32 outputs (with invalid_black, fog stats, a near bias and
    map_outputs): within 1e-5."""
    cfg, tcfg, (jp, jst, _), (tp, tst, _), (jb, jc), (tb, tc) = _bake_pair(
        6, dtype="bfloat16", corner_pack=8, sparse_block=4)
    c2w, intr = _camera()
    kw = dict(H=16, W=16, ray_samples=12, chunk_rays=100, scene_aabb=GBOX)
    if variant == "f32":
        kw.update(out_u8=False, invalid_black=True, near_bias=0.2)
    with jax.disable_jit():
        want = JB.make_baked_camera_renderer(jb, jc, cfg, **kw)(
            jp, jst, c2w, intr)
    got = TB.make_baked_camera_renderer(tb, tc, tcfg, device="cpu", **kw)(
        tp, tst, c2w, intr)
    if variant == "u8":
        assert got.dtype == np.uint8 and got.shape == (16, 16, 3)
        diff = np.abs(got.astype(np.int16) - np.asarray(want, np.int16))
        assert diff.max() <= 1
        assert 20 < got.mean() < 250
        return
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-5)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)

    def stack(*outs):  # map_outputs sees rgb, depth, acc, wmax, entropy
        return (jnp if isinstance(outs[0], jax.Array) else torch).stack(
            [outs[1], outs[3], outs[4]], 1)

    kw.update(fog_stats=True, map_outputs=stack)
    with jax.disable_jit():
        want = JB.make_baked_camera_renderer(jb, jc, cfg, **kw)(
            jp, jst, c2w, intr)
    got = TB.make_baked_camera_renderer(tb, tc, tcfg, device="cpu", **kw)(
        tp, tst, c2w, intr)
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_baked_chunk_renderer_through_render_image():
    """The port's chunk renderer is a drop-in for render_image; within
    1e-5 (rgb, depth, acc) of JAX's through JAX's render_image.
    Fog stats add (wmax, entropy); a mesh raises."""
    cfg, tcfg, (jp, jst, _), (tp, tst, _), (jb, jc), (tb, tc) = _bake_pair(
        7, dtype="float32", corner_pack=2)
    c2w, intr = _camera(12)
    md = SimpleNamespace(H=12, W=12, c2w=c2w, intrinsics=intr)
    with jax.disable_jit():
        want = JR.render_image(
            JB.make_baked_chunk_renderer(jb, jc, cfg, ray_samples=12),
            jp, jst, md, scene_aabb=GBOX, chunk_rays=100)
    ren = TB.make_baked_chunk_renderer(tb, tc, tcfg, ray_samples=12,
                                       device="cpu")
    got = TR.render_image(ren, tp, tst, md, scene_aabb=GBOX, chunk_rays=100)
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-5)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)

    rays = torch.from_numpy(_rays(np.random.default_rng(8), 100))
    fog = TB.make_baked_chunk_renderer(tb, tc, tcfg, ray_samples=12,
                                       fog_stats=True, device="cpu")
    outs = fog(tp, tst, rays)
    assert len(outs) == 5 and tuple(outs[3].shape) == (100,)
    with jax.disable_jit():
        jouts = JB.make_baked_chunk_renderer(jb, jc, cfg, ray_samples=12,
                                             fog_stats=True)(
            jp, jst, jnp.asarray(rays.numpy()))
    for g, w in zip(outs[3:], jouts[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    mapped = TB.make_baked_chunk_renderer(
        tb, tc, tcfg, ray_samples=12, device="cpu",
        map_outputs=lambda rgb, depth, acc, gain: rgb * gain)(
        tp, tst, rays, 2.0)
    np.testing.assert_allclose(mapped.numpy(), 2.0 * outs[0].numpy())
    with pytest.raises(NotImplementedError):
        TB.make_baked_chunk_renderer(tb, tc, tcfg, ray_samples=12,
                                     mesh=object(), device="cpu")


def test_snapshot_saved_by_jax_loads_in_port(tmp_path):
    """A sparse bf16 snapshot written by JAX's save_baked loads bit for bit
    through the port's load_baked and renders the same frame as the port's
    own table; the port's snapshot loads in JAX. The guards refuse a
    changed BakedConfig, occupancy key or params fingerprint."""
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc), (jb, jc), (tb, tc) = \
        _bake_pair(9, dtype="bfloat16", corner_pack=8, sparse_block=4)
    occ_key = JB.occ_bake_fingerprint(jocc, 1)
    assert TB.occ_bake_fingerprint(tocc, 1) == occ_key
    assert TB.occ_bake_fingerprint(None, 1) == ""
    path = tmp_path / "snap"
    JB.save_baked(path, jb, jc, fingerprint="", occ_key=occ_key)
    loaded = TB.load_baked(path, tc, occ_key=occ_key, device="cpu")
    for k in ("table", "aabb", "block_index"):
        np.testing.assert_array_equal(_bits(loaded[k]), _bits(tb[k]))
    assert loaded["table"].dtype == torch.bfloat16
    assert loaded["corner_pack"] == 8
    c2w, intr = _camera()
    kw = dict(H=16, W=16, ray_samples=12, chunk_rays=128, scene_aabb=GBOX,
              device="cpu")
    np.testing.assert_array_equal(
        TB.make_baked_camera_renderer(loaded, tc, tcfg, **kw)(tp, tst, c2w,
                                                              intr),
        TB.make_baked_camera_renderer(tb, tc, tcfg, **kw)(tp, tst, c2w,
                                                          intr))

    import dataclasses

    fp = TB.params_fingerprint(tp)
    TB.save_baked(tmp_path / "port.npz", tb, tc, fingerprint=fp,
                  occ_key=occ_key)
    back = JB.load_baked(tmp_path / "port.npz", jc, occ_key=occ_key)
    np.testing.assert_array_equal(_bits(back["table"]), _bits(jb["table"]))
    assert TB.load_baked(tmp_path / "port", tc, fingerprint=fp,
                         occ_key=occ_key, device="cpu") is not None
    assert TB.load_baked(tmp_path / "missing", tc, device="cpu") is None
    assert TB.load_baked(path, dataclasses.replace(tc, n_dirs=16),
                         occ_key=occ_key, device="cpu") is None
    assert TB.load_baked(path, tc, occ_key="", device="cpu") is None
    tp2 = dict(tp, bg={"l0": tp["bg"]["l0"],
                       "l1": {"w": tp["bg"]["l1"]["w"] + 1e-3,
                              "b": tp["bg"]["l1"]["b"]}})
    fp2 = TB.params_fingerprint(tp2)
    assert fp2 != fp and TB.params_fingerprint(tp) == fp
    assert TB.load_baked(tmp_path / "port", tc, fingerprint=fp2,
                         occ_key=occ_key, device="cpu") is None


def test_compact_baked_and_guards():
    """compact_baked of a dense bake equals the sparse bake bit for bit and
    renders it exactly; it refuses a dense config and is idempotent."""
    import dataclasses

    _, tcfg, _, (tp, tst, tocc), _, (dense, dcfg) = _bake_pair(
        10, dtype="bfloat16", corner_pack=4)
    scfg = dataclasses.replace(dcfg, sparse_block=4)
    sparse = TB.bake_field(tp, tcfg, tst, scfg, occ_state=tocc,
                           occ_dilate=1, device="cpu")
    comp = TB.compact_baked(dense, scfg)
    np.testing.assert_array_equal(_bits(comp["table"]),
                                  _bits(sparse["table"]))
    np.testing.assert_array_equal(comp["block_index"].numpy(),
                                  sparse["block_index"].numpy())
    assert TB.compact_baked(comp, scfg) is comp
    with pytest.raises(ValueError):
        TB.compact_baked(dense, dcfg)
    rays = torch.from_numpy(_rays(np.random.default_rng(3), 64))
    for a, b in zip(TB.render_rays_baked(dense, dcfg, rays, 16),
                    TB.render_rays_baked(comp, scfg, rays, 16)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_baked_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, tcfg, _, (tp, tst, _) = _setup()
    bcfg = TB.BakedConfig(resolution=4, sh_levels=1, n_dirs=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.bake_field(tp, tcfg, tst, bcfg)
    baked = {"table": torch.zeros((64, 256)), "aabb": torch.zeros(2, 3),
             "corner_pack": 8}
    with pytest.raises(RuntimeError):
        TB.make_baked_camera_renderer(baked, bcfg, tcfg, H=4, W=4,
                                      ray_samples=4, scene_aabb=GBOX)
    with pytest.raises(RuntimeError):
        TB.make_baked_chunk_renderer(baked, bcfg, tcfg, ray_samples=4)
    with pytest.raises(RuntimeError):
        TB.load_baked("missing_snapshot", bcfg)
