"""Overlap-tiled inference.

Counterpart of ``resselt_tpu/parallel/tiling.py``, with the same grid
planning, serving-hint resolution and crop geometry, so tiled outputs
match.  Fixed-size tile windows are batched, run through the model on its
device, and their halo-cropped cores written into one preallocated canvas.

Shifted inner tiling: every window lies fully inside the image, and edge
windows are flush with the image borders, so border pixels see the model's
own border handling exactly as a whole-image run would.  Output is
therefore identical to the un-tiled run wherever the model's receptive
field fits inside the halo.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.factory import as_torch_dtype


@dataclass(frozen=True)
class TileGrid:
    height: int
    width: int
    window: tuple[int, int]  # full tile window per axis (core + 2*halo)
    halo: tuple[int, int]
    ys: tuple[int, ...]  # window origins (top)
    xs: tuple[int, ...]  # window origins (left)


def _origins(size: int, window: int, stride: int) -> tuple[int, ...]:
    if size <= window:
        return (0,)
    xs = list(range(0, size - window, stride))
    xs.append(size - window)
    return tuple(xs)


def plan_grid(height: int, width: int, tile, halo) -> TileGrid:
    """``tile``/``halo``: int (square windows) or per-axis ``(y, x)`` pairs."""
    ty, tx = (tile, tile) if isinstance(tile, int) else tile
    oy, ox = (halo, halo) if isinstance(halo, int) else halo
    return TileGrid(
        height=height,
        width=width,
        window=(ty + 2 * oy, tx + 2 * ox),
        halo=(oy, ox),
        ys=_origins(height, ty + 2 * oy, ty),
        xs=_origins(width, tx + 2 * ox, tx),
    )


def _windows(grid: TileGrid) -> list[tuple[int, int]]:
    return [(y, x) for y in grid.ys for x in grid.xs]


def extract_tiles(image: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(H, W, C) -> (len(ys)*len(xs), window_y, window_x, C)."""
    wy, wx = grid.window
    return torch.stack([image[y : y + wy, x : x + wx] for y, x in _windows(grid)])


def _core(grid: TileGrid, y: int, x: int, scale: int):
    """Output rows/cols [y0, y1) x [x0, x1) that window (y, x) contributes,
    and where they start inside the window's output."""
    (wy, wx), (oy, ox) = grid.window, grid.halo
    h, w = grid.height * scale, grid.width * scale
    y0 = 0 if y == 0 else (y + oy) * scale
    y1 = h if y + wy >= grid.height else (y + wy - oy) * scale
    x0 = 0 if x == 0 else (x + ox) * scale
    x1 = w if x + wx >= grid.width else (x + wx - ox) * scale
    return y0, y1, x0, x1, y0 - y * scale, x0 - x * scale


def stitch_tiles(out_tiles: torch.Tensor, grid: TileGrid, scale: int) -> torch.Tensor:
    """Assemble the output image from upscaled tile windows: each window
    contributes its halo-cropped core, except at image borders where the
    window is flush with the border and contributes up to it."""
    canvas = out_tiles.new_zeros((grid.height * scale, grid.width * scale, out_tiles.shape[-1]))
    for t, (y, x) in zip(out_tiles, _windows(grid)):
        _paste(canvas, t, grid, y, x, scale)
    return canvas


def _paste(canvas, t, grid: TileGrid, y: int, x: int, scale: int) -> None:
    y0, y1, x0, x1, ty0, tx0 = _core(grid, y, x, scale)
    canvas[y0:y1, x0:x1] = t[ty0 : ty0 + y1 - y0, tx0 : tx0 + x1 - x0]


def _pad_to_multiple_hw(image: torch.Tensor, multiple: int):
    """Pad the trailing-spatial dims up to multiples (reflect; edge when the
    image is smaller than the pad). Returns (padded, orig_h, orig_w)."""
    h, w = image.shape[-3], image.shape[-2]
    ph = -h % multiple
    pw = -w % multiple
    if ph or pw:
        mode = 'reflect' if (ph < h and pw < w) else 'replicate'
        squeeze = image.ndim == 3
        x = image[None] if squeeze else image
        dtype = x.dtype
        if dtype == torch.uint8:  # torch pads floating tensors only
            x = x.float()
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode)
        x = x.permute(0, 2, 3, 1).to(dtype).contiguous()
        image = x[0] if squeeze else x
    return image, h, w


def upscale_padded(model, image, multiple: int = 64, dtype=None, precision: str | None = None):
    """Serve variable-size images padded (reflect; edge for tiny images) up
    to the next multiples of ``multiple``, cropping the output back.
    Interior output is identical to the unpadded run; pixels within the
    model's receptive field of the pad seam can differ slightly from the
    model's own border handling."""
    image = torch.as_tensor(image).to(model.device)
    squeeze = image.ndim == 3
    if squeeze:
        image = image[None]
    scale = model.metadata.upscale
    if not isinstance(scale, int):
        raise ValueError('upscale_padded requires an integer upscale factor')
    image, h, w = _pad_to_multiple_hw(image, multiple)
    out = model(image, dtype=dtype, precision=precision)
    out = out[:, : h * scale, : w * scale, :]
    return out[0] if squeeze else out


def _resolve_dtype_hint(val, eff_dtype):
    """Resolve an ``int | {'f32': n, 'bf16': m}`` serving hint against the
    dtype the tiles will actually run in."""
    if isinstance(val, dict):
        group = 'bf16' if as_torch_dtype(eff_dtype) in (torch.bfloat16, torch.float16) else 'f32'
        return val.get(group) or val.get('f32')
    return val


def _resolve_tile_hint(model, eff_dtype) -> int:
    """Resolve ``SRModel.serving_tile`` against the serving dtype;
    conv-model default 256."""
    return _resolve_dtype_hint(getattr(model, 'serving_tile', None), eff_dtype) or 256


def derive_halo(tile: int, floor: int, multiple: int | None) -> int:
    """Smallest halo ``h >= floor`` whose full window ``tile + 2*h`` is a
    multiple of the arch's spatial ``multiple``; the floor itself when no
    such halo exists within one period."""
    if not multiple or multiple <= 1:
        return floor
    for h in range(floor, floor + multiple):
        if (tile + 2 * h) % multiple == 0:
            return h
    return floor


def _resolve_halo_hint(model, tile: int, eff_dtype) -> int:
    """The loader's ``serving_halo`` at its ``serving_tile``; at any other
    tile, that halo (or the default 16) rounded up by :func:`derive_halo`
    to the arch's ``size_multiple``."""
    hint_tile = _resolve_tile_hint(model, eff_dtype)
    halo = _resolve_dtype_hint(getattr(model, 'serving_halo', None), eff_dtype)
    if tile == hint_tile and halo:
        return halo
    return derive_halo(tile, halo or 16, getattr(model, 'size_multiple', None))


def _plan_tiled(model, h: int, w: int, tile: int, halo: int, batch_size: int | None, eff_dtype):
    """Resolve the tile grid + batch for an (h, w) image, or None when the
    image fits in one window (callers run the model whole)."""
    window = tile + 2 * halo
    if h <= window and w <= window:
        return None
    # A dimension smaller than a window becomes a single strip: shrink the
    # window (and, for tiny dims, the halo) along THAT axis only.
    ty = tx = tile
    oy = ox = halo
    if h < window:
        oy = min(halo, max(0, (h - 1) // 2))
        ty = max(1, h - 2 * oy)
    if w < window:
        ox = min(halo, max(0, (w - 1) // 2))
        tx = max(1, w - 2 * ox)

    grid = plan_grid(h, w, (ty, tx), (oy, ox))
    n = len(grid.ys) * len(grid.xs)
    if batch_size is None:
        tb = _resolve_dtype_hint(getattr(model, 'tile_batch', None), eff_dtype)
        batch_size = min(n, tb or 8)
    return grid, min(batch_size, n)


def upscale_tiled(
    model,
    image,
    tile: int | None = None,
    halo: int | None = None,
    batch_size: int | None = None,
    mesh=None,
    dtype=None,
    precision: str | None = None,
    on_device: bool | None = None,
    unroll: int = 1,
    bucket: bool = False,
):
    """Run an SRModel over a large (H, W, C) image in [0, 1] via overlap
    tiling; returns the (H*s, W*s, C_out) output on the model's device.

    ``tile``/``halo`` default to the loader's hints (``serving_tile``,
    ``serving_halo``) or 256/16.  Tile windows run ``batch_size`` at a time
    (default: ``tile_batch`` or 8); the last batch is padded by repeating
    its last tile so every batch has one shape.  ``bucket`` pads (H, W) up
    to tile multiples (reflect) and crops the output.  ``mesh``, ``unroll``
    and ``on_device`` are accepted at their defaults only."""
    if mesh is not None or unroll != 1 or on_device is not None:
        raise NotImplementedError('mesh, unroll and on_device are not supported yet; leave them at their defaults')
    eff_dtype = dtype if dtype is not None else torch.float32
    if tile is None:
        tile = _resolve_tile_hint(model, eff_dtype)
    if halo is None:
        halo = _resolve_halo_hint(model, tile, eff_dtype)
    image = torch.as_tensor(image).to(model.device)
    if image.ndim != 3:
        raise ValueError('upscale_tiled expects an HWC image')
    scale = model.metadata.upscale
    if not isinstance(scale, int):
        raise ValueError('tiled inference requires an integer upscale factor')

    h0, w0, _ = image.shape
    if bucket:
        image, _, _ = _pad_to_multiple_hw(image, tile)
        if image.shape[0] != h0 or image.shape[1] != w0:
            out = upscale_tiled(model, image, tile=tile, halo=halo, batch_size=batch_size,
                                dtype=dtype, precision=precision)
            return out[: h0 * scale, : w0 * scale, :]

    h, w, _ = image.shape
    planned = _plan_tiled(model, h, w, tile, halo, batch_size, dtype if dtype is not None else image.dtype)
    if planned is None:
        return model(image, dtype=dtype, precision=precision)
    grid, batch_size = planned

    if image.dtype == torch.uint8:
        image = image.float() / 255.0
    if dtype is not None:
        image = image.to(as_torch_dtype(dtype))
    elif image.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        image = image.float()

    windows = _windows(grid)
    wy, wx = grid.window
    canvas = None
    for i in range(0, len(windows), batch_size):
        chunk = windows[i : i + batch_size]
        tiles = [image[y : y + wy, x : x + wx] for y, x in chunk]
        tiles += tiles[-1:] * (batch_size - len(chunk))
        out = model(torch.stack(tiles), precision=precision)
        if canvas is None:
            canvas = out.new_empty((h * scale, w * scale, out.shape[-1]))
        for t, (y, x) in zip(out, chunk):
            _paste(canvas, t, grid, y, x, scale)
    return canvas
