"""Image-quality metrics for SR validation: PSNR and SSIM.

Counterpart of ``resselt_tpu/metrics.py``, with its conventions
(BasicSR-style): float images in [0, 1], HW, HWC or NHWC, torch tensors
(on any device) or numpy arrays, an optional border crop of
``crop_border`` pixels, optional ITU-R BT.601 Y-channel evaluation.

SSIM is the original Wang et al. 2004 formulation: 11x11 Gaussian window
(sigma 1.5), K1=0.01, K2=0.03, C3=C2/2, computed per channel and averaged
over 'valid' windows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF


def _to_nhwc(img) -> torch.Tensor:
    img = torch.as_tensor(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim == 3:
        img = img[None]
    if img.ndim != 4:
        raise ValueError(f'expected HW/HWC/NHWC image, got shape {tuple(img.shape)}')
    return img.float()


def rgb_to_y(img) -> torch.Tensor:
    """ITU-R BT.601 luma of an RGB image in [0, 1] (the 16-235 digital-Y
    convention of the SR literature), rescaled back to [0, 1]; NHWC with
    one channel."""
    img = _to_nhwc(img)
    if img.shape[-1] != 3:
        raise ValueError(f'rgb_to_y expects 3 channels, got {img.shape[-1]}')
    w = torch.tensor([65.481, 128.553, 24.966], dtype=torch.float32, device=img.device) / 255.0
    return (img @ w + 16.0 / 255.0)[..., None]


def _prep(a, b, crop_border: int, test_y_channel: bool):
    a, b = _to_nhwc(a), _to_nhwc(b)
    if a.shape != b.shape:
        raise ValueError(f'shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}')
    b = b.to(a.device)
    if test_y_channel:
        a, b = rgb_to_y(a), rgb_to_y(b)
    if crop_border:
        c = crop_border
        a = a[:, c:-c, c:-c]
        b = b[:, c:-c, c:-c]
    return a, b


def psnr(a, b, crop_border: int = 0, test_y_channel: bool = False) -> float:
    """Peak signal-to-noise ratio in dB between [0,1] images."""
    a, b = _prep(a, b, crop_border, test_y_channel)
    mse = torch.mean((a - b) ** 2)
    return float(10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_valid(x: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 'valid' Gaussian filter over H, W of NHWC (per channel)."""
    c = x.shape[-1]
    k = torch.from_numpy(k1d).to(x.device)
    y = x.permute(0, 3, 1, 2)
    y = TF.conv2d(y, k.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1), groups=c)
    y = TF.conv2d(y, k.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1), groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(a, b, crop_border: int = 0, test_y_channel: bool = False) -> float:
    """Mean structural similarity (Wang et al. 2004) between [0,1] images."""
    a, b = _prep(a, b, crop_border, test_y_channel)
    if min(a.shape[1], a.shape[2]) < 11:
        raise ValueError(f'image {tuple(a.shape)} smaller than the 11x11 SSIM window')
    k = _gaussian_kernel()
    c1, c2 = 0.01**2, 0.03**2

    mu_a = _filter2d_valid(a, k)
    mu_b = _filter2d_valid(b, k)
    saa = _filter2d_valid(a * a, k) - mu_a * mu_a
    sbb = _filter2d_valid(b * b, k) - mu_b * mu_b
    sab = _filter2d_valid(a * b, k) - mu_a * mu_b

    m = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / ((mu_a * mu_a + mu_b * mu_b + c1) * (saa + sbb + c2))
    return float(torch.mean(m))
