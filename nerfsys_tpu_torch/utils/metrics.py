"""Image quality metrics: PSNR, SSIM and the AlexNet LPIPS graph.

Port of nerfsys_tpu/utils/metrics.py (`ssim` :60, `load_lpips_weights`
:114, `_alex_features` :130, `lpips` :151):

  - PSNR = -10 log10(mse + 1e-24), re-exported from ops.losses.
  - SSIM: pytorch-msssim's defaults (Gaussian window 11, sigma 1.5,
    data_range 1, K1 0.01, K2 0.03) as a separable VALID filter, one
    `conv1d` over each axis in float32, with the variances clamped at 0.
  - LPIPS (AlexNet): five conv stages, unit-normalized channels, linear
    heads, spatial mean, summed over the stages. No pretrained weights ship
    with the repository: the graph runs only when a weights file (.npz,
    `conv{i}/w` HWIO, `conv{i}/b`, `lin{i}/w` (1, 1, C, 1)) is given by
    path or by NERFSYS_LPIPS_WEIGHTS; otherwise `lpips` returns None and
    the eval table reports NaN for the column.

These are metrics, not kernels: the reference computes them with XLA
convolutions, and the port with PyTorch's, TF32 off so that the card
computes in float32 as the CPU does.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerfsys_tpu_torch.ops.losses import psnr, psnr_from_mse  # noqa: F401


def _fp32_convs():
    """cuDNN without TF32: the E[x^2] - mu^2 variances of SSIM cancel
    catastrophically at reduced precision."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


# ------------------------------- SSIM ---------------------------------------
def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable VALID Gaussian filter over an (H, W, C) image: axis 0,
    then axis 1."""
    k = kernel.shape[0]

    def conv_axis(x, axis):
        x = x.movedim(axis, -1)
        shape = x.shape
        out = F.conv1d(x.reshape(-1, 1, shape[-1]), kernel.reshape(1, 1, k))
        return out.reshape(*shape[:-1], shape[-1] - k + 1).movedim(-1, axis)

    with _fp32_convs():
        return conv_axis(conv_axis(img, 0), 1)


def ssim(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over (H, W, C) images in [0, data_range] -> scalar."""
    pred = pred.to(torch.float32)
    gt = gt.to(torch.float32)
    kernel = _gaussian_kernel1d(win_size, sigma, pred.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _blur(pred, kernel)
    mu_y = _blur(gt, kernel)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    # true variances are nonnegative; cancellation can dip below zero
    sigma_xx = torch.clamp(_blur(pred * pred, kernel) - mu_xx, min=0.0)
    sigma_yy = torch.clamp(_blur(gt * gt, kernel) - mu_yy, min=0.0)
    sigma_xy = _blur(pred * gt, kernel) - mu_xy

    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
    return torch.mean(num / den)


# ------------------------------- LPIPS --------------------------------------
_ALEX_CFG = [
    # (out_ch, kernel, stride, pad)
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_lpips_weights_cache: Dict[str, Dict] = {}


def load_lpips_weights(path: Optional[str] = None) -> Optional[Dict]:
    """The LPIPS weights from an .npz file, conv weights transposed from
    HWIO to conv2d's OIHW once here, as CPU tensors; None without a file.
    Cached per path."""
    path = path or os.environ.get("NERFSYS_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    if path in _lpips_weights_cache:
        return _lpips_weights_cache[path]
    weights: Dict[str, Dict[str, torch.Tensor]] = {}
    with np.load(path) as raw:
        for key in raw.files:
            top, leaf = key.rsplit("/", 1)
            arr = np.asarray(raw[key], np.float32)
            if top.startswith("conv") and leaf == "w":
                arr = np.transpose(arr, (3, 2, 0, 1))
            weights.setdefault(top, {})[leaf] = torch.from_numpy(
                np.ascontiguousarray(arr))
    _lpips_weights_cache[path] = weights
    return weights


def _alex_features(weights: Dict, x: torch.Tensor):
    """x: (H, W, 3) in [-1, 1] -> the 5 relu feature maps (1, C, h, w)."""
    dev = x.device
    shift = torch.tensor(_SHIFT, device=dev)
    scale = torch.tensor(_SCALE, device=dev)
    h = ((x - shift) / scale).permute(2, 0, 1)[None]  # NCHW
    feats = []
    with _fp32_convs():
        for i, (_, _, stride, pad) in enumerate(_ALEX_CFG):
            wb = weights[f"conv{i}"]
            h = F.conv2d(h, wb["w"].to(dev), wb["b"].to(dev), stride=stride,
                         padding=pad)
            h = torch.relu(h)
            feats.append(h)
            # AlexNet max-pools after relu1 and relu2; LPIPS taps relu3..5
            # before any pool
            if i in (0, 1):
                h = F.max_pool2d(h, 3, stride=2)
    return feats


def lpips(pred: torch.Tensor, gt: torch.Tensor, weights=None,
          weights_path: Optional[str] = None) -> Optional[torch.Tensor]:
    """LPIPS (AlexNet) distance of (H, W, 3) sRGB images in [0, 1] -> a
    scalar, or None when no weights are available."""
    if weights is None:
        weights = load_lpips_weights(weights_path)
    if weights is None:
        return None
    a = pred.to(torch.float32) * 2.0 - 1.0
    b = gt.to(torch.float32) * 2.0 - 1.0
    total = torch.zeros((), device=a.device)
    for i, (x, y) in enumerate(zip(_alex_features(weights, a),
                                   _alex_features(weights, b))):
        xn = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                             min=1e-10)
        yn = y / torch.clamp(torch.linalg.norm(y, dim=1, keepdim=True),
                             min=1e-10)
        d = (xn - yn) ** 2
        lin_w = weights[f"lin{i}"]["w"].reshape(1, -1, 1, 1).to(a.device)
        total = total + torch.mean((d * lin_w).sum(dim=1))
    return total
