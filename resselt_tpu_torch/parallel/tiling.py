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

The tiled forward is one function of the image (:func:`_tiled_forward`).
The default path (``on_device`` None or True, as in JAX) runs it as one
dispatch per image: on the card a CUDA graph captured once per (grid,
batch, dtype, TF32 settings, kernel switches) and replayed, on the CPU
eagerly.
``on_device=False`` is the host loop: the same function, run eagerly.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from dataclasses import dataclass

import torch

from ..core.factory import _precision, as_torch_dtype

# graphs kept per model (see _program_for), as JAX's _TILED_FN_CACHE_MAX
_TILED_FN_CACHE_MAX = 8


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


def _tiled_forward(model, image: torch.Tensor, grid: TileGrid, scale: int, batch_size: int, precision):
    """The tiled forward as one function of the (H, W, C) image: every
    window extracted, the window list padded to whole batches by repeating
    the last window (as JAX's ``_make_fused_tiled_fn``), each batch run
    through the model, each window's core written into one canvas."""
    windows = _windows(grid)
    wy, wx = grid.window
    tiles = [image[y : y + wy, x : x + wx] for y, x in windows]
    tiles += tiles[-1:] * (-len(tiles) % batch_size)
    canvas = None
    for i in range(0, len(tiles), batch_size):
        out = model(torch.stack(tiles[i : i + batch_size]), precision=precision)
        if canvas is None:
            canvas = out.new_empty((grid.height * scale, grid.width * scale, out.shape[-1]))
        for t, (y, x) in zip(out, windows[i : i + batch_size]):
            _paste(canvas, t, grid, y, x, scale)
    return canvas


class TiledProgram:
    """The one-dispatch tiled forward for one planned grid:
    ``program(image)`` returns the (H*s, W*s, C_out) canvas of an (H, W, C)
    image in the compute dtype, on the model's device.

    On the card it holds a ``torch.cuda.CUDAGraph`` of :func:`_tiled_forward`,
    captured at the first call after one eager warm-up run on a side stream
    (which fills what a first forward builds: the prepared weights, shift
    masks and mask flags, cuFFT plans, the kernel libraries and their shared
    memory attributes), its static input image, and its static canvas.  A
    call copies the image in, replays the graph and returns a copy of the
    canvas, never the canvas itself.  ``replays``: the replays run.  A
    failed capture raises with its cause; nothing falls back to the host
    loop.  :meth:`release` frees the graph (the LRU calls it on eviction).
    On the CPU the program runs :func:`_tiled_forward` eagerly.

    Memory: every program of a model captures into the model's one graph
    memory pool (``pool``).  A replay's intermediates therefore take the
    room of the largest capture once, not once a graph, and each cached
    program adds only its static canvas.  Sharing is safe because replays
    of one model never overlap and nothing reads a graph's canvas but the
    copy right after its own replay: another graph's replay may overwrite
    it in between.  The warm-up run allocates from the caching allocator as
    the host loop does.

    Launch counts: the kernel wrappers count in Python, so the warm-up run
    and the capture count one launch for each kernel they launch or record
    into the graph, and a replay counts nothing.  The graph keeps its
    ``cudaGraph_t`` (``keep_graph=True``, ``graph.raw_cuda_graph()``), whose
    kernel nodes are what a replay launches.

    The program holds the model weakly (the model's program cache holds the
    program) and the weights a replay reads strongly, so a captured graph
    stays valid while the program lives."""

    def __init__(self, model, grid: TileGrid, scale: int, batch_size: int, precision, pool=None):
        self._model = weakref.ref(model)
        self._weights = None
        self.grid, self.scale, self.batch_size, self.precision = grid, scale, batch_size, precision
        self.pool = pool
        self.graph = None
        self.replays = 0
        self._in = self._out = None

    def _live_model(self):
        model = self._model()
        if model is None:
            raise RuntimeError('the model of this tiled program has been freed')
        return model

    def _run(self, image: torch.Tensor) -> torch.Tensor:
        return _tiled_forward(self._live_model(), image, self.grid, self.scale, self.batch_size, self.precision)

    def _capture(self, image: torch.Tensor) -> None:
        self._weights = self._live_model().weights(image.dtype)
        self._in = image.clone()
        side = torch.cuda.Stream(image.device)
        side.wait_stream(torch.cuda.current_stream(image.device))
        with torch.cuda.stream(side):
            self._run(self._in)
        torch.cuda.current_stream(image.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self._out = self._run(self._in)
            graph.instantiate()
        except RuntimeError as err:
            raise RuntimeError(f'CUDA graph capture of the tiled forward failed ({self._live_model().arch_id}, '
                               f'{image.dtype}, window {self.grid.window}, batch {self.batch_size})') from err
        self.graph = graph

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        if image.device.type != 'cuda':
            return self._run(image)
        if self.graph is None:
            self._capture(image)
        else:
            self._in.copy_(image)
        self.graph.replay()
        self.replays += 1
        return self._out.clone()

    def release(self) -> None:
        """Free the graph, its static tensors and its hold on the pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self._in = self._out = self._weights = None


def _kernel_switches() -> tuple[bool, bool]:
    """The process-wide kernel switches a forward reads (the CLI's
    ``--no-fused-attention`` / ``--no-fused-lk``)."""
    from ..nn.window import fused_attention_enabled
    from ..ops.fused_conv import fused_lk_enabled

    return fused_attention_enabled(), fused_lk_enabled()


def _program_for(model, grid: TileGrid, scale: int, batch_size: int, dtype: torch.dtype, precision):
    """The LRU-cached :class:`TiledProgram` for a planned grid, at most
    ``_TILED_FN_CACHE_MAX`` a model (serving many image sizes beyond that
    should pass ``bucket=True``); an evicted program's graph is freed.  The
    key holds the TF32 settings that ``precision`` leaves in effect (cuDNN's
    switch and the matmul precision, as they are at this call), since a
    graph keeps the kernels chosen at its capture."""
    with _precision(precision):
        tf32 = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    cache = model.__dict__.setdefault('_tiled_fn_cache', OrderedDict())
    key = (grid, batch_size, dtype, tf32, _kernel_switches())
    program = cache.get(key)
    if program is None:
        pool = model.__dict__.get('_tiled_graph_pool')
        if pool is None and model.device.type == 'cuda':
            pool = model.__dict__['_tiled_graph_pool'] = torch.cuda.graph_pool_handle()
        program = cache[key] = TiledProgram(model, grid, scale, batch_size, precision, pool)
        while len(cache) > _TILED_FN_CACHE_MAX:
            cache.popitem(last=False)[1].release()
    else:
        cache.move_to_end(key)
    return program


def _resolve_window(model, tile, halo, dtype, mesh, unroll) -> tuple[int, int, int]:
    """The preamble of :func:`tiled_program` and :func:`upscale_tiled`:
    refuse ``mesh``, check ``unroll``, resolve the tile and halo hints
    against ``dtype`` (f32 when None) and check the scale.  Returns
    ``(tile, halo, scale)``."""
    if mesh is not None:
        raise NotImplementedError('mesh= (tiles sharded over devices) is not ported yet')
    if not isinstance(unroll, int) or isinstance(unroll, bool) or unroll < 1:
        raise ValueError(f'unroll must be an int >= 1, got {unroll!r}')
    eff_dtype = dtype if dtype is not None else torch.float32
    if tile is None:
        tile = _resolve_tile_hint(model, eff_dtype)
    if halo is None:
        halo = _resolve_halo_hint(model, tile, eff_dtype)
    scale = model.metadata.upscale
    if not isinstance(scale, int):
        raise ValueError('tiled inference requires an integer upscale factor')
    return tile, halo, scale


def tiled_program(model, h: int, w: int, *, tile: int | None = None, halo: int | None = None,
                  batch_size: int | None = None, mesh=None, dtype=None, precision: str | None = None,
                  unroll: int = 1):
    """The one-dispatch tiled program for an (h, w, C) image.

    Returns ``(fn, scale)``, where ``fn(image)`` runs the tiled forward
    exactly as ``upscale_tiled`` would (the same grid planning, batch
    resolution and cache entry; ``image`` in the compute dtype, on the
    model's device), or ``(None, scale)`` when the image fits one window.
    JAX's ``fn`` also takes the params; here the program reads the model's
    prepared weights.  ``unroll`` (any int >= 1) changes nothing: it
    unrolls JAX's scan, and the port has none.  ``mesh`` raises
    NotImplementedError."""
    tile, halo, scale = _resolve_window(model, tile, halo, dtype, mesh, unroll)
    eff_dtype = as_torch_dtype(dtype) or torch.float32
    planned = _plan_tiled(model, h, w, tile, halo, batch_size, eff_dtype)
    if planned is None:
        return None, scale
    grid, batch_size = planned
    return _program_for(model, grid, scale, batch_size, eff_dtype, precision), scale


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
    to tile multiples (reflect) and crops the output, so that the sizes of
    one bucket share one program.  ``precision`` is forwarded to the model
    (see ``SRModel.__call__``).

    ``on_device`` (default None, which means True, as in JAX): one dispatch
    per image, a CUDA graph replay on the card (:class:`TiledProgram`, kept
    in a bounded LRU on the model), the same function run eagerly on the
    CPU.  A new image size costs one warm-up run and a capture before its
    first replay.  False: the host loop, one forward per tile batch, with
    nothing kept between images.  Both give the same pixels.  ``unroll``
    (any int >= 1) leaves the output unchanged: it unrolls JAX's scan, and
    the port has none.  ``mesh`` raises NotImplementedError."""
    tile, halo, scale = _resolve_window(model, tile, halo, dtype, mesh, unroll)
    image = torch.as_tensor(image).to(model.device)
    if image.ndim != 3:
        raise ValueError('upscale_tiled expects an HWC image')

    h0, w0, _ = image.shape
    if bucket:
        image, _, _ = _pad_to_multiple_hw(image, tile)
        if image.shape[0] != h0 or image.shape[1] != w0:
            out = upscale_tiled(model, image, tile=tile, halo=halo, batch_size=batch_size, dtype=dtype,
                                precision=precision, on_device=on_device, unroll=unroll)
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

    if on_device is None or on_device:
        return _program_for(model, grid, scale, batch_size, image.dtype, precision)(image)
    return _tiled_forward(model, image, grid, scale, batch_size, precision)
