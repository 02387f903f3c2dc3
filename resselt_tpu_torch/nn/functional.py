"""Functional NN ops with PyTorch semantics on NHWC tensors.

Counterpart of ``resselt_tpu/nn/functional.py``, holding what ESRGAN uses.
Feature maps are contiguous NHWC ``(N, H, W, C)``; conv weights keep the
torch OIHW layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """2-D convolution, torch semantics. ``x``: NHWC, ``w``: OIHW.

    ``padding`` may be an int, an (ph, pw) pair, or 'same' (odd kernels).
    The product runs in ``x``'s dtype; the result is contiguous NHWC."""
    kh, kw = w.shape[-2], w.shape[-1]
    dh, dw = _pair(dilation)
    if padding == 'same':
        padding = ((kh - 1) * dh // 2, (kw - 1) * dw // 2)
    y = TF.conv2d(
        x.permute(0, 3, 1, 2),
        w.to(x.dtype),
        None if b is None else b.to(x.dtype),
        stride=_pair(stride),
        padding=_pair(padding),
        dilation=(dh, dw),
        groups=groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def leaky_relu(x, negative_slope: float = 0.01):
    return TF.leaky_relu(x, negative_slope)


def pixel_unshuffle(x, r: int):
    """torch's PixelUnshuffle channel order, on NHWC."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


def pad2d(x, pads, mode: str = 'constant', value: float = 0.0):
    """Torch ``F.pad`` on NHWC spatial dims. ``pads`` = (left, right, top, bottom)."""
    if max(pads) == 0 and min(pads) == 0:
        return x
    y = TF.pad(x.permute(0, 3, 1, 2), tuple(pads), mode=mode, value=value if mode == 'constant' else None)
    return y.permute(0, 2, 3, 1).contiguous()


def interpolate_nearest(x, scale_factor=None, size=None):
    """torch F.interpolate(mode='nearest'): src = floor(dst * in/out)."""
    n, h, w, c = x.shape
    if size is not None:
        oh, ow = _pair(size)
    else:
        sfh, sfw = (scale_factor, scale_factor) if not isinstance(scale_factor, (tuple, list)) else scale_factor
        oh, ow = int(h * float(sfh)), int(w * float(sfw))
    if size is None and oh % h == 0 and ow % w == 0:
        ry, rx = oh // h, ow // w
        return x[:, :, None, :, None, :].expand(n, h, ry, w, rx, c).reshape(n, oh, ow, c)
    hi = torch.floor(torch.arange(oh, device=x.device, dtype=torch.float64) * (h / oh)).long()
    wi = torch.floor(torch.arange(ow, device=x.device, dtype=torch.float64) * (w / ow)).long()
    return x[:, hi][:, :, wi].contiguous()
