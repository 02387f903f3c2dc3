"""The benchmark's own frozen copy of the overlap-tiling rule, so that the
reference computes the same windows the served path computes and no seam
differs between them.

Windows of ``tile + 2 * halo`` lie fully inside the image, edge windows
flush with its borders; each contributes its core (the window less its
halo, up to the border at an edge).  An image that fits one window runs
whole.  A side shorter than a window becomes one strip along that side,
its halo shrunk to fit.
"""

from __future__ import annotations

from typing import Callable

import torch


def _origins(size: int, window: int, stride: int) -> list[int]:
    if size <= window:
        return [0]
    return list(range(0, size - window, stride)) + [size - window]


def plan(h: int, w: int, tile: int, halo: int):
    """``None`` when the image runs whole, else ``(ys, xs, (wy, wx), (oy, ox))``."""
    window = tile + 2 * halo
    if h <= window and w <= window:
        return None
    ty = tx = tile
    oy = ox = halo
    if h < window:
        oy = min(halo, max(0, (h - 1) // 2))
        ty = max(1, h - 2 * oy)
    if w < window:
        ox = min(halo, max(0, (w - 1) // 2))
        tx = max(1, w - 2 * ox)
    wy, wx = ty + 2 * oy, tx + 2 * ox
    return _origins(h, wy, ty), _origins(w, wx, tx), (wy, wx), (oy, ox)


def upscale(forward: Callable[[torch.Tensor], torch.Tensor], image: torch.Tensor, scale: int, tile: int, halo: int,
            batch: int = 4) -> torch.Tensor:
    """``forward`` (NCHW -> NCHW x ``scale``) over the (C, H, W) ``image``
    by the tiling rule; returns (C_out, H * scale, W * scale)."""
    _, h, w = image.shape
    planned = plan(h, w, tile, halo)
    if planned is None:
        return forward(image[None])[0]
    ys, xs, (wy, wx), (oy, ox) = planned
    windows = [(y, x) for y in ys for x in xs]
    canvas = None
    for i in range(0, len(windows), batch):
        part = windows[i : i + batch]
        out = forward(torch.stack([image[:, y : y + wy, x : x + wx] for y, x in part]))
        if canvas is None:
            canvas = out.new_empty((out.shape[1], h * scale, w * scale))
        for t, (y, x) in zip(out, part):
            y0 = 0 if y == 0 else (y + oy) * scale
            y1 = h * scale if y + wy >= h else (y + wy - oy) * scale
            x0 = 0 if x == 0 else (x + ox) * scale
            x1 = w * scale if x + wx >= w else (x + wx - ox) * scale
            ty, tx = y0 - y * scale, x0 - x * scale
            canvas[:, y0:y1, x0:x1] = t[:, ty : ty + y1 - y0, tx : tx + x1 - x0]
    return canvas
