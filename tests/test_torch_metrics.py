"""Port parity of the image metrics (utils/metrics.py) against the JAX
package: SSIM on random images, an 11x11 image (one window) and constant
images; LPIPS on the AlexNet-shaped random weights of
`scripts.convert_lpips_weights.random_weights`, as test_lpips_golden.py
drives the JAX graph; the weight loader without a file.

Tolerances: SSIM within 1e-5, LPIPS within 1e-5 relative. A constant image
is the exception: its variances E[x^2] - mu^2 cancel to a rounding residue
of a few ulps of c^2, which XLA's and PyTorch's convolutions round apart,
and SSIM divides it by C2 = 9e-4. JAX itself reads 0.99947 for c = 0.77.
There the two must agree within 32 ulps of c^2 over C2 (measured: at most
16 over 60 constants in [0.01, 1]); an all-zero image is exact on both.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nerfsys_tpu.scripts.convert_lpips_weights import random_weights
from nerfsys_tpu.utils import metrics as JM
from nerfsys_tpu_torch.utils import metrics as TM
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

C2 = 0.03 ** 2


def _pair(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


def _ssims(a, b):
    return (float(JM.ssim(jnp.asarray(a), jnp.asarray(b))),
            float(TM.ssim(torch.from_numpy(a), torch.from_numpy(b))))


@pytest.mark.parametrize("shape,seed,noise", [
    ((48, 64, 3), 0, 0.1), ((33, 17, 3), 1, 0.5), ((11, 11, 3), 2, 0.1),
    ((11, 11, 1), 3, 0.3), ((40, 30, 3), 4, 0.0)])
def test_ssim_matches_jax(shape, seed, noise):
    j, t = _ssims(*_pair(shape, seed, noise))
    assert abs(j - t) <= 1e-5, (j, t)


@pytest.mark.parametrize("va,vb", [(0.0, 0.0), (0.3, 0.3), (0.77, 0.77),
                                   (0.2, 0.7)])
def test_ssim_on_constant_images(va, vb):
    a = np.full((24, 24, 3), va, np.float32)
    b = np.full((24, 24, 3), vb, np.float32)
    j, t = _ssims(a, b)
    ulps = 32 * float(np.spacing(np.float32(max(va, vb) ** 2))) / C2
    assert abs(j - t) <= max(1e-5, ulps), (j, t)
    if va == vb == 0.0:
        assert j == t == 1.0


def test_ssim_runs_in_float32_on_other_dtypes():
    a, b = _pair((20, 20, 3), 5)
    t64 = TM.ssim(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    assert t64.dtype == torch.float32
    assert float(t64) == float(TM.ssim(torch.from_numpy(a),
                                       torch.from_numpy(b)))


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "alex_random.npz"
    np.savez(path, **random_weights(seed=0))
    return str(path)


@pytest.mark.parametrize("shape,seed", [((64, 64, 3), 7), ((75, 100, 3), 8)])
def test_lpips_matches_jax(lpips_npz, shape, seed):
    a, b = _pair(shape, seed)
    j = float(JM.lpips(jnp.asarray(a), jnp.asarray(b),
                       weights_path=lpips_npz))
    t = float(TM.lpips(torch.from_numpy(a), torch.from_numpy(b),
                       weights_path=lpips_npz))
    assert np.isfinite(t) and t > 0
    assert abs(t - j) <= 1e-5 * abs(j), (t, j)
    assert float(TM.lpips(torch.from_numpy(a), torch.from_numpy(a),
                          weights_path=lpips_npz)) == 0.0


def test_lpips_weights_layout_cache_and_env(lpips_npz, monkeypatch):
    w = TM.load_lpips_weights(lpips_npz)
    raw = random_weights(seed=0)
    # HWIO in the file, OIHW for conv2d
    np.testing.assert_array_equal(
        w["conv1"]["w"].numpy(), np.transpose(raw["conv1/w"], (3, 2, 0, 1)))
    assert w["lin4"]["w"].shape == raw["lin4/w"].shape
    assert TM.load_lpips_weights(lpips_npz) is w
    monkeypatch.setenv("NERFSYS_LPIPS_WEIGHTS", lpips_npz)
    assert TM.load_lpips_weights() is w


def test_no_lpips_weights_gives_none(tmp_path, monkeypatch):
    monkeypatch.delenv("NERFSYS_LPIPS_WEIGHTS", raising=False)
    a, b = _pair((16, 16, 3), 9)
    assert TM.load_lpips_weights() is None
    assert TM.load_lpips_weights(str(tmp_path / "absent.npz")) is None
    assert TM.lpips(torch.from_numpy(a), torch.from_numpy(b)) is None
    assert JM.lpips(jnp.asarray(a), jnp.asarray(b)) is None


def test_psnr_reexports():
    a, b = _pair((8, 8, 3), 10)
    t = float(TM.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    j = float(JM.psnr(jnp.asarray(a), jnp.asarray(b)))
    assert t == pytest.approx(j, rel=1e-6)
    assert float(TM.psnr_from_mse(torch.tensor(0.01))) == pytest.approx(20.0)
