"""Port parity: occupancy queries, probe CDF and sampler (kernels 2 and 3's
module) against JAX.

Small grids (K=2 experts, R=16, L=2), 64 rays, P=32 probes, S=8 samples,
from numpy seeds. The JAX side runs eagerly on the CPU; the port's kernel
wrappers run their plain versions on CPU tensors. Tolerances: cell
selection and occupancy bits must match exactly; the cdf within 1e-6
(values in [0, 1]; sums over 32 probes taken in another order than XLA's
cumsum); t_vals within 1e-5 (values up to ~4.5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models.container import ContainerStatics
from nerfsys_tpu.models.occupancy import expert_pair_fn as j_expert_pair_fn
from nerfsys_tpu.models.occupancy import union_pair_fn as j_union_pair_fn
from nerfsys_tpu.ops import occupancy as J
from nerfsys_tpu_torch.models import occupancy as TM
from nerfsys_tpu_torch.ops import occupancy as T
from nerfsys_tpu_torch.utils import interop


def _setup(seed=0, K=2, R=16, L=2):
    rng = np.random.default_rng(seed)
    cents = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)[:K]
    boxes = np.stack([np.stack([c - 1.2, c + 1.2]) for c in cents])
    gbox = np.array([[-2.5] * 3, [2.5] * 3], np.float32)
    occ = J.init_occ_state(J.OccGridConfig(resolution=R, levels=L,
                                           warmup_steps=0), K)
    binary = rng.uniform(size=occ["binary"].shape) < 0.4
    occs = np.where(binary, rng.uniform(size=binary.shape), 0.0)
    occs[rng.uniform(size=binary.shape) < 0.05] = -1.0  # invisible tags
    occ["binary"] = jnp.asarray(binary)
    occ["occs"] = jnp.asarray(occs.astype(np.float32))
    jst = ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                           jnp.asarray(gbox))
    tst = interop.statics_from_jax(
        ContainerStatics(cents, boxes, gbox), "cpu")
    tocc = interop.occ_state_from_jax(
        {k: np.asarray(v) for k, v in occ.items()}, "cpu")
    return rng, occ, jst, tocc, tst


def _rays(rng, n=64):
    o = (rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, 2.0]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near = rng.uniform(0.0, 0.5, n).astype(np.float32)
    far = (near + rng.uniform(2.0, 4.0, n)).astype(np.float32)
    return o, d, near, far


def test_level_aabbs_and_init_state():
    aabb = np.array([[-1.0, -2.0, 0.5], [1.5, 0.0, 2.0]], np.float32)
    want = np.asarray(J.level_aabbs(jnp.asarray(aabb), 3))
    got = T.level_aabbs(torch.tensor(aabb), 3).numpy()
    np.testing.assert_array_equal(got, want)
    st = T.init_occ_state(T.OccGridConfig(resolution=8, levels=2), 3,
                          device="cpu")
    assert st["occs"].shape == (3, 2, 8, 8, 8)
    assert st["binary"].dtype == torch.bool
    assert int(st["ready_after"]) == 16


def test_linspace01_matches_jax():
    for n in (2, 8, 9, 17, 33, 96, 129):
        np.testing.assert_array_equal(
            T.linspace01(n).numpy(),
            np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


def test_query_pair_per_expert_and_union():
    rng, occ, jst, tocc, tst = _setup()
    pts = rng.uniform(-4.0, 4.0, size=(4000, 3)).astype(np.float32)
    for k in range(2):
        jo, jv = j_expert_pair_fn(occ, jst, k)(jnp.asarray(pts))
        to, tv = TM.expert_pair_fn(tocc, tst, k)(torch.tensor(pts))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jo, jv = j_union_pair_fn(occ, jst)(jnp.asarray(pts))
    to, tv = TM.union_pair_fn(tocc, tst)(torch.tensor(pts))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert to.any() and not to.all()


@pytest.mark.parametrize("importance,ray_floor", [(True, 0.25), (False, 0.25),
                                                  (True, 0.0)])
def test_probe_cdf_matches_jax(importance, ray_floor):
    rng, occ, jst, tocc, tst = _setup(seed=1)
    o, d, near, far = _rays(rng)
    pair = j_union_pair_fn(occ, jst)
    want = J.occupancy_probe_cdf(
        lambda p: pair(p)[0], jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(near), jnp.asarray(far), 32, uniform_frac=0.25,
        ray_floor=ray_floor, pair_fn=pair if importance else None)
    got = T.occupancy_probe_cdf(
        tocc["occs"], tocc["binary"], tst.expert_aabbs, torch.tensor(o),
        torch.tensor(d), torch.tensor(near), torch.tensor(far), 32,
        importance=importance, uniform_frac=0.25, ray_floor=ray_floor)
    np.testing.assert_array_equal(got["occ"].numpy(), np.asarray(want["occ"]))
    np.testing.assert_array_equal(got["alive"].numpy(),
                                  np.asarray(want["alive"]))
    np.testing.assert_allclose(got["cdf"].numpy(), np.asarray(want["cdf"]),
                               rtol=0, atol=1e-6)
    assert got["cdf"].shape == (64, 33)
    assert got["alive"].any()


def test_sampler_fed_jax_cdf_matches_jax():
    rng, occ, jst, tocc, tst = _setup(seed=2)
    o, d, near, far = _rays(rng)
    pair = j_union_pair_fn(occ, jst)
    state = J.occupancy_probe_cdf(
        None, jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
        jnp.asarray(far), 32, uniform_frac=0.25, ray_floor=0.25,
        pair_fn=pair)
    want, want_alive = J.sample_tvals_from_cdf(
        state, jnp.asarray(near), jnp.asarray(far), 8)
    tstate = {"cdf": torch.tensor(np.asarray(state["cdf"])),
              "alive": torch.tensor(np.asarray(state["alive"]))}
    got, alive = T.sample_tvals_from_cdf(tstate, torch.tensor(near),
                                         torch.tensor(far), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(want_alive))
    assert (np.diff(got.numpy(), axis=1) >= 0).all()


def test_sampler_sorts_unsorted_placements_and_jitter_stays_in_range():
    # a cdf that is not monotone: the placements come out unsorted and the
    # sampler must still return them sorted (it never assumes monotone)
    cdf = torch.tensor([[0.0, 0.6, 0.2, 0.9, 1.0]])
    near, far = torch.tensor([1.0]), torch.tensor([3.0])
    u = torch.tensor([0.1, 0.3, 0.5, 0.7, 0.95])
    t = T.sample_tvals_kernel(cdf, near, far, u)
    assert (torch.diff(t, dim=1) >= 0).all()
    gen = torch.Generator().manual_seed(0)
    state = {"cdf": torch.linspace(0, 1, 9)[None].repeat(4, 1),
             "alive": torch.ones(4, dtype=torch.bool)}
    tj, _ = T.sample_tvals_from_cdf(state, torch.zeros(4), torch.ones(4), 8,
                                    generator=gen, randomized=True)
    assert tj.shape == (4, 8) and (tj >= 0).all() and (tj <= 1).all()
    with pytest.raises(ValueError):
        T.sample_tvals_from_cdf(state, torch.zeros(4), torch.ones(4), 8,
                                randomized=True)
