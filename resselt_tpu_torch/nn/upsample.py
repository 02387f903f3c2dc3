"""Shared upsamplers.

Counterpart of ``resselt_tpu/nn/upsample.py``, holding ``dysample`` (the
upsamplers of later families come with them).
"""

from __future__ import annotations

import torch

from . import functional as F
from .params import PTree


def dysample(p: PTree, x, scale: int, groups: int = 4, end_convolution: bool = True):
    """Content-adaptive upsampling (DySample) on NHWC ``x``.

    ``p`` scopes the DySample module keys: offset.{weight,bias},
    scope.weight, init_pos, [end_conv.{weight,bias}]."""
    n, h, w, c = x.shape
    s = scale
    g = groups

    offset = p.conv('offset', x)
    scope = F.conv2d(x, p['scope.weight'])
    init_pos = p['init_pos'].reshape(-1).to(x.dtype)  # (2*g*s*s,)
    offset = offset * F.sigmoid(scope) * 0.5 + init_pos

    # channel layout is [2, g, s, s] row-major (DySample._init_pos)
    off = offset.reshape(n, h, w, 2, g, s, s)

    # normalized sample coordinates; component 0 = x/W, 1 = y/H
    xs = (torch.arange(w, device=x.device, dtype=x.dtype) + 0.5).reshape(1, 1, w, 1, 1, 1)
    ys = (torch.arange(h, device=x.device, dtype=x.dtype) + 0.5).reshape(1, h, 1, 1, 1, 1)
    cx = 2 * (xs + off[:, :, :, 0]) / w - 1
    cy = 2 * (ys + off[:, :, :, 1]) / h - 1
    coords = torch.stack([cx, cy], dim=-1)  # (n, h, w, g, s, s, 2)

    # grid[b, gi, h*s+i, w*s+j] = coords[b, h, w, gi, i, j]
    grid = coords.permute(0, 3, 1, 4, 2, 5, 6).reshape(n * g, h * s, w * s, 2)

    xg = x.reshape(n, h, w, g, c // g).permute(0, 3, 1, 2, 4).reshape(n * g, h, w, c // g)
    out = F.grid_sample_bilinear(xg, grid, align_corners=False, padding_mode='border')
    out = out.reshape(n, g, h * s, w * s, c // g).permute(0, 2, 3, 1, 4).reshape(n, h * s, w * s, c)

    if end_convolution:
        out = p.conv('end_conv', out)
    return out
