"""Port parity: bucketed top-E MoE dispatch (`--bucketed_moe`, the routing
half of `--render_fast`), kernel row 10a's plain versions.

The JAX package and the port get the same numpy params (drawn from a seed
in the reference layout: K hash-grid experts, L=2 levels, 2^8 rows, hidden
8), centroids and points. On CPU tensors the kernel wrappers run their
plain versions.

Tolerances, each stated where it is used:
  - dispatch intermediates (idx, w, dest, counts, bucket_rows, rows):
    exact, against numpy recomputations of the reference's formulas
    (`_bucketed_eval`, nerfsys_tpu/models/container.py:301-336);
  - container outputs against the JAX package: 1e-5 (float32 MLPs summed
    in another order); bucketed against dense on points whose margin
    support fits in E: 1e-4 (the reference's own test's bound);
  - the overflow fallback against the dense blend: 1e-6 (the same
    program);
  - gradients: 1e-5 of each leaf's max (scatter-adds in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops.encodings import HashGridConfig
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils.tree import tree_leaves


def _np_params(rng, cfg):
    """numpy params of the reference's layout and shapes: hash tables
    U(-1, 1), linear layers U(-1/sqrt(in), 1/sqrt(in))."""
    shapes = jax.eval_shape(lambda k: JCo.init_container_params(k, cfg),
                            jax.random.PRNGKey(0))

    def draw(path, s):
        if "hash_table" in jax.tree_util.keystr(path):
            return rng.uniform(-1, 1, s.shape).astype(np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _setup(K, margin, seed=0, **kw):
    """(jax cfg, jax statics, jax params, port cfg, port statics, port
    params): well-separated centroids so the margin support fits in E=2."""
    rng = np.random.default_rng(seed)
    cents = rng.uniform(-3, 3, (K, 3)).astype(np.float32)
    boxes = np.stack([np.stack([c - 1.0, c + 1.0]) for c in cents])
    gbox = np.array([[-4.0] * 3, [4.0] * 3], np.float32)
    expert = JN.NGPConfig(hidden=8, sigma_depth=1, color_hidden=8,
                          color_depth=1, geo_feat_dim=3,
                          hash=HashGridConfig(levels=2, min_res=4, max_res=8,
                                              log2_hashmap_size=8))
    dense = JCo.ContainerConfig(num_experts=K, expert=expert,
                                boundary_margin=margin, bg_hidden=8)
    cfg = dataclasses.replace(dense, bucketed=True, **kw)
    np_params = _np_params(rng, dense)
    jst = JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                               jnp.asarray(gbox))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    return (cfg, jst, jp, interop.container_config_from_jax(cfg),
            interop.statics_from_jax(jst, "cpu"),
            interop.container_params_from_jax(np_params, "cpu"))


def _pts(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("margin", [1.0, 1.1])
def test_bucketed_matches_jax_and_dense(margin):
    """K=8, cf 4.0: no bucket overflows; the port's bucketed container
    equals the JAX package's, and the dense blend wherever the margin
    support fits in E=2 experts."""
    cfg, jst, jp, tcfg, tst, tp = _setup(8, margin, capacity_factor=4.0)
    x, d = _pts(513, -3.5, 3.5, 1)
    before = dict(TCo.bucket_stats)
    want = JCo.container_apply(jp, cfg, jst, jnp.asarray(x), jnp.asarray(d))
    got = TCo.container_apply(tp, tcfg, tst, torch.tensor(x),
                              torch.tensor(d))
    assert TCo.bucket_stats["calls"] == before["calls"] + 1
    assert TCo.bucket_stats["dense"] == before["dense"]
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
    dense = dataclasses.replace(tcfg, bucketed=False)
    rgb_d, sig_d = TCo.container_apply(tp, dense, tst, torch.tensor(x),
                                       torch.tensor(d))
    ok = (TCo.routing_weights(tst, dense, torch.tensor(x)) > 0).sum(1) <= 2
    assert ok.float().mean() > 0.9
    _close(got[1][ok], sig_d[ok], 1e-4)
    _close(got[0][ok], rgb_d[ok], 1e-4)
    sj = JCo.container_density(jp, cfg, jst, jnp.asarray(x))
    st = TCo.container_density(tp, tcfg, tst, torch.tensor(x))
    _close(st, sj, 1e-5)
    _close(st, got[1], 1e-6)


def test_overflow_takes_the_dense_branch_and_legacy_trash_slot():
    """cf 0.01 on K=2: every bucket overflows. With bucket_overflow_dense
    (the default) the call is the dense blend; without it the overflow
    pairs read the trash slot (sigma 0) and stay finite; both as the JAX
    package computes them."""
    cfg, jst, jp, tcfg, tst, tp = _setup(2, 1.0, capacity_factor=0.01)
    x, _ = _pts(300, -2, 2, 3)
    d = np.ones((300, 3), np.float32)
    before = TCo.bucket_stats["dense"]
    got = TCo.container_apply(tp, tcfg, tst, torch.tensor(x),
                              torch.tensor(d))
    assert TCo.bucket_stats["dense"] == before + 1
    dense = TCo.container_apply(tp, dataclasses.replace(tcfg, bucketed=False),
                                tst, torch.tensor(x), torch.tensor(d))
    _close(got[0], dense[0], 1e-6)
    _close(got[1], dense[1], 1e-6)
    want = JCo.container_apply(jp, cfg, jst, jnp.asarray(x), jnp.asarray(d))
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)

    legacy_j = dataclasses.replace(cfg, bucket_overflow_dense=False)
    legacy_t = dataclasses.replace(tcfg, bucket_overflow_dense=False)
    lj = JCo.container_apply(jp, legacy_j, jst, jnp.asarray(x),
                             jnp.asarray(d))
    lt = TCo.container_apply(tp, legacy_t, tst, torch.tensor(x),
                             torch.tensor(d))
    assert torch.isfinite(lt[0]).all() and torch.isfinite(lt[1]).all()
    _close(lt[0], lj[0], 1e-5)
    _close(lt[1], lj[1], 1e-5)
    # C = 128 per expert for 300 points: the overflow reads sigma 0
    n_trash = int((lt[1] == 0).sum())
    assert n_trash > 0 and n_trash == int((np.asarray(lj[1]) == 0).sum())


def test_coherent_chunk_top1_overflows_to_dense():
    """The --render_fast regression: a spatially coherent point set (all
    in expert 0's region) overflows the top-1 bucket; the dense fallback
    makes it exact, rgb, sigma and density."""
    cfg, jst, jp, tcfg, tst, tp = _setup(4, 1.0, capacity_factor=1.5,
                                         experts_per_point=1)
    rng = np.random.default_rng(7)
    c0 = np.asarray(jst.centroids)[0]
    x = (c0[None, :] + rng.uniform(-0.4, 0.4, (512, 3))).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    before = TCo.bucket_stats["dense"]
    got = TCo.container_apply(tp, tcfg, tst, torch.tensor(x),
                              torch.tensor(d))
    assert TCo.bucket_stats["dense"] == before + 1
    want = JCo.container_apply(jp, cfg, jst, jnp.asarray(x), jnp.asarray(d))
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
    _close(TCo.container_density(tp, tcfg, tst, torch.tensor(x)),
           JCo.container_density(jp, cfg, jst, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("margin", [1.0, 1.1])
def test_bucketed_gradients_match_jax(margin):
    """Gradients of sum(rgb) + sum(sigma) through the bucketed container
    (dispatch, bucket gather, the hash encode's VJP, the blend's VJP)
    against jax.grad, leaf by leaf."""
    cfg, jst, jp, tcfg, tst, tp = _setup(4, margin, capacity_factor=2.0)
    x, d = _pts(256, -3, 3, 2)
    g_j = jax.grad(lambda p: sum(jnp.sum(o) for o in JCo.container_apply(
        p, cfg, jst, jnp.asarray(x), jnp.asarray(d))))(jp)
    leaves = jax.tree_util.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), tp)
    rgb, sigma = TCo.container_apply(leaves, tcfg, tst, torch.tensor(x),
                                     torch.tensor(d))
    (rgb.sum() + sigma.sum()).backward()
    want = jax.tree_util.tree_leaves(g_j["experts"])
    got = [t.grad for t in tree_leaves(leaves["experts"])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale
    assert any(float(np.abs(np.asarray(w)).max()) > 0 for w in want)


def _numpy_dispatch(x, cents, cluster_2d, margin, E, C, dirs):
    """The reference's formulas in numpy float32: routing distances, top-E
    nearest first (lower index on ties), margin weights renormalised over
    E, the exclusive one-hot cumsum over pairs with w > 0, dest, counts,
    bucket rows (empty slots point 0) and the gathered rows."""
    f = np.float32
    sel = [1, 2] if cluster_2d else [0, 1, 2]
    xs, cs = x[:, sel], cents[:, sel]
    sx = np.zeros(len(x), f)
    sc = np.zeros(len(cents), f)
    dot = np.zeros((len(x), len(cents)), f)
    for j in range(len(sel)):
        sx = sx + xs[:, j] * xs[:, j] if j else xs[:, 0] * xs[:, 0]
        sc = sc + cs[:, j] * cs[:, j] if j else cs[:, 0] * cs[:, 0]
        prod = (f(2) * xs[:, None, j]) * cs[None, :, j]
        dot = dot + prod if j else prod
    dist = np.sqrt(np.maximum((sx[:, None] - dot) + sc[None, :], f(0)))
    idx = np.argsort(dist, axis=1, kind="stable")[:, :E]
    dsel = np.take_along_axis(dist, idx, 1)
    N, K = dist.shape
    if margin > 1.0:
        dsel = np.maximum(dsel, f(1e-6))
        invd = (f(1) / dsel) * (dsel <= f(margin) * dsel[:, :1])
        tot = invd[:, 0].copy()
        for e in range(1, E):
            tot = tot + invd[:, e]
        w = invd / np.maximum(tot, f(1e-6))[:, None]
    else:
        w = np.zeros((N, E), f)
        w[:, 0] = 1
    k_flat, w_flat = idx.reshape(-1), w.reshape(-1)
    onehot = np.eye(K, dtype=np.int64)[k_flat] * (w_flat > 0)[:, None]
    rank = np.cumsum(onehot, 0) - onehot
    slot = (rank * onehot).sum(1)
    keep = (slot < C) & (w_flat > 0)
    dest = np.where(keep, k_flat * C + slot, K * C)
    buf = np.zeros(K * C + 1, np.int64)
    buf[dest[keep]] = np.repeat(np.arange(N), E)[keep]
    rows_src = x if dirs is None else np.concatenate([x, dirs], 1)
    return {"idx": idx, "w": w, "dest": dest, "counts": onehot.sum(0),
            "bucket_rows": buf[:K * C].reshape(K, C),
            "rows": rows_src[buf[:K * C]].reshape(K, C, -1)}


@pytest.mark.parametrize("margin", [1.0, 1.1])
@pytest.mark.parametrize("E", [1, 2, 3])
@pytest.mark.parametrize("cluster_2d", [True, False])
def test_dispatch_intermediates_match_numpy(margin, E, cluster_2d):
    """Every dispatch output equals the numpy recomputation, with ties
    (points equidistant from two centroids), overflowing and roomy
    buckets; idx also equals lax.top_k's on the JAX package's own routing
    distances."""
    rng = np.random.default_rng(E)
    K = 5
    cents = rng.uniform(-2, 2, (K, 3)).astype(np.float32)
    # centroids 0 and 1 mirror each other through z = 0: a point with z = 0
    # is equidistant from both, bit for bit, in 2D and 3D routing
    cents[0, 2], cents[1] = -0.5, cents[0] * np.float32([1, 1, -1])
    x, dirs = _pts(600, -2.5, 2.5, 10 + E)
    x[:40, :2] = cents[0, :2] + rng.uniform(-0.1, 0.1, (40, 2))
    x[:40, 2] = 0.0
    for C, with_dirs in ((16, True), (TCo.bucket_capacity(600, K, E, 4.0),
                                      False)):
        dd = dirs if with_dirs else None
        got = TCo.bucket_dispatch_kernel(
            torch.tensor(x), None if dd is None else torch.tensor(dd),
            torch.tensor(cents), cluster_2d, margin, E, C)
        want = _numpy_dispatch(x, cents, cluster_2d, margin, E, C, dd)
        for key in ("idx", "dest", "counts", "bucket_rows"):
            np.testing.assert_array_equal(got[key].numpy(), want[key])
            assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got["w"].numpy(), want["w"])
        np.testing.assert_array_equal(got["rows"].numpy(), want["rows"])
        assert (got["counts"].numpy() > C).any() == (C == 16)
    # the tie points keep the lower expert first, as lax.top_k does
    ties = got["idx"][:40].tolist()
    assert sum(row[0] == 0 for row in ties) > 20
    for row in ties:
        assert 1 not in row or (0 in row and row.index(0) < row.index(1))
    jst = JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(cents),
                               jnp.asarray(cents))
    jcfg = JCo.ContainerConfig(num_experts=K, cluster_2d=cluster_2d)
    _, jidx = jax.lax.top_k(-JCo._routing_dist(jst, jcfg, jnp.asarray(x)), E)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(jidx))


def test_combine_and_its_transpose():
    """The blend (10a-ii) reads the trash slot as 0; its VJP (10a-iii)
    through BucketCombine equals autograd of the plain gather-and-sum."""
    rng = np.random.default_rng(4)
    N, E, K, C = 30, 2, 3, 16
    dest = rng.permutation(K * C + 20)[:N * E]
    dest = np.minimum(dest, K * C).astype(np.int32)  # some pairs trashed
    w = torch.tensor(rng.uniform(0, 1, (N, E)).astype(np.float32))
    sb = torch.tensor(rng.normal(size=K * C).astype(np.float32),
                      requires_grad=True)
    rb = torch.tensor(rng.normal(size=(K * C, 3)).astype(np.float32),
                      requires_grad=True)
    counts = torch.tensor(np.bincount(dest[dest < K * C] // C,
                                      minlength=K).astype(np.int32))
    sigma, rgb = TCo.BucketCombine.apply(w, torch.tensor(dest), counts, sb,
                                         rb, True)
    s_flat = torch.cat([sb, sb.new_zeros(1)])
    r_flat = torch.cat([rb, rb.new_zeros(1, 3)])
    keep = torch.tensor(dest < K * C).reshape(N, E)
    wk = torch.where(keep, w, 0.0)
    d64 = torch.tensor(dest).long().reshape(N, E)
    want_s = (wk * s_flat[d64]).sum(1)
    want_r = (wk[..., None] * r_flat[d64]).sum(1)
    _close(sigma.detach(), want_s.detach(), 1e-6)
    _close(rgb.detach(), want_r.detach(), 1e-6)
    gs, gr = torch.randn(N), torch.randn(N, 3)
    got = torch.autograd.grad((sigma * gs).sum() + (rgb * gr).sum(),
                              (sb, rb))
    want = torch.autograd.grad((want_s * gs).sum() + (want_r * gr).sum(),
                               (sb, rb))
    for g, ww in zip(got, want):
        _close(g, ww, 1e-6)


def test_multidir_falls_back_per_direction():
    cfg, jst, jp, tcfg, tst, tp = _setup(4, 1.1, capacity_factor=4.0)
    x, _ = _pts(200, -3, 3, 5)
    dirs_m = np.random.default_rng(6).normal(size=(3, 3)).astype(np.float32)
    want = JCo.container_apply_multidir(jp, cfg, jst, jnp.asarray(x),
                                        jnp.asarray(dirs_m))
    got = TCo.container_apply_multidir(tp, tcfg, tst, torch.tensor(x),
                                       torch.tensor(dirs_m))
    assert got[0].shape == (3, 200, 3) and got[1].shape == (200,)
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
    one = TCo.container_apply(tp, tcfg, tst, torch.tensor(x),
                              torch.tensor(dirs_m[1:2]).expand(200, 3))
    _close(got[0][1], one[0], 0.0)


def test_interop_carries_bucketed_keys_and_refuses_dropped_math():
    expert = JN.NGPConfig(xyz_encoding="planes",
                          planes=PlaneEncodingConfig(bwd_chunk=512))
    cfg = JCo.ContainerConfig(num_experts=4, expert=expert, bucketed=True,
                              experts_per_point=1, capacity_factor=1.3,
                              bucket_overflow_dense=False, expert_map=False)
    t = interop.container_config_from_jax(cfg)
    assert (t.bucketed, t.experts_per_point, t.capacity_factor,
            t.bucket_overflow_dense) == (True, 1, 1.3, False)
    # the precision options import: bfloat16 MLPs and line matmuls of
    # either dtype are carried (the port computes them)
    amp = interop.container_config_from_jax(dataclasses.replace(
        cfg, expert=dataclasses.replace(expert, use_bf16=True,
                                        planes=PlaneEncodingConfig(
                                            lines_mm_dtype="bfloat16",
                                            lines_matmul=True))))
    assert amp.expert.use_bf16 and amp.expert.planes.lines_bf16
    # except bfloat16 line matmuls under the autodiff backward
    # (matmul_bwd=False: the gradient of the bfloat16 dot)
    bad = dataclasses.replace(cfg, expert=dataclasses.replace(
        expert, planes=PlaneEncodingConfig(
            lines_mm_dtype="bfloat16", lines_matmul=True, matmul_bwd=False)))
    with pytest.raises(ValueError, match=r"expert\.planes\.matmul_bwd"):
        interop.container_config_from_jax(bad)
    # the reference reads lines_mm_dtype only under lines_matmul, float32
    # line matmuls compute the gathers' function, and its plane backward
    # runs in float32 whatever bwd_dtype says on every backend but the TPU:
    # these import to configs that compute what the default one does
    default = interop.container_config_from_jax(dataclasses.replace(
        cfg, expert=dataclasses.replace(expert,
                                        planes=PlaneEncodingConfig())))
    for planes in (PlaneEncodingConfig(lines_mm_dtype="bfloat16"),
                   PlaneEncodingConfig(lines_matmul=True),
                   PlaneEncodingConfig(lines_matmul=True, matmul_bwd=False),
                   PlaneEncodingConfig(bwd_dtype="float32"),
                   PlaneEncodingConfig(bwd_dtype="bfloat16")):
        ok = interop.container_config_from_jax(dataclasses.replace(
            cfg, expert=dataclasses.replace(expert, planes=planes)))
        assert (ok.expert.planes.lines_matmul, ok.expert.planes.lines_mm_dtype
                ) == (planes.lines_matmul, planes.lines_mm_dtype)
        assert not ok.expert.planes.lines_bf16
        assert ok == dataclasses.replace(default, expert=dataclasses.replace(
            default.expert, planes=dataclasses.replace(
                default.expert.planes, lines_matmul=planes.lines_matmul,
                lines_mm_dtype=planes.lines_mm_dtype)))
    assert "expert_map" in interop.DROPPED_KEYS["ContainerConfig"]
