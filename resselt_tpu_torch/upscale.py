"""Command-line upscaler.

    python -m resselt_tpu_torch.upscale MODEL INPUT OUTPUT [--tile 256] [--halo 4] [--bf16] [--int8]
        [--precision highest|tensorfloat32|bfloat16] [--trace DIR]

``INPUT``/``OUTPUT`` may be single images or directories (batch mode); the
next image is read and the last one written on a background thread while
the card computes.  Tiled, an image whose size (padded, with ``--bucket``)
another input of the run shares runs the one-dispatch path, a CUDA graph
captured once for the size and replayed; an image of a size of its own
runs the host loop, since a capture costs more than it saves on one
image.  ``MODEL`` is any supported checkpoint, or a ``.npz``
cache written by ``resselt_tpu_torch.cache`` / ``python -m
resselt_tpu_torch.convert`` (or the JAX package's).  The model runs on
``--device`` (default cuda).  Counterpart of ``resselt_tpu/upscale.py``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger('resselt_tpu_torch')

IMAGE_EXTS = ('.png', '.jpg', '.jpeg', '.bmp', '.webp', '.tif', '.tiff')


def load_image(path: str) -> np.ndarray:
    """Load as float [0,1] HWC; RGBA stays 4-channel, everything else RGB."""
    from PIL import Image

    img = Image.open(path)
    if img.mode in ('RGBA', 'LA', 'PA'):
        img = img.convert('RGBA')
    else:
        img = img.convert('RGB')
    return np.asarray(img, dtype=np.float32) / 255.0


def save_image(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def adapt_channels(img: np.ndarray, c_in: int):
    """Split an image into model-input planes for a ``c_in``-channel model.

    Returns (main, alpha_or_None): RGBA images run their alpha through the
    model as a separate replicated-gray pass; grayscale models get the
    ITU-R luma of color inputs."""
    has_alpha = img.shape[-1] == 4
    rgb = img[..., :3]
    alpha = img[..., 3:4] if has_alpha else None
    if c_in == 4:
        if not has_alpha:
            img = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
        return img, None
    if c_in == 1:
        luma = rgb @ np.asarray([0.299, 0.587, 0.114], np.float32)
        return luma[..., None], alpha
    if c_in == 3:
        return rgb, alpha
    raise ValueError(f'cannot adapt a {img.shape[-1]}-channel image to a {c_in}-channel model')


def repeated_sizes(paths, tile: int, bucket: bool) -> set:
    """The (h, w) tiled sizes that more than one of ``paths`` has, read from
    the image headers; with ``bucket``, each size padded up to tile
    multiples as ``upscale_tiled(bucket=True)`` pads it."""
    from collections import Counter

    from PIL import Image

    sizes = []
    for path in paths:
        with Image.open(path) as img:
            sizes.append(tiled_size(img.height, img.width, tile, bucket))
    shared = {size for size, n in Counter(sizes).items() if n > 1}
    logger.info('%d of %d images share a tiled size with another (one CUDA graph a size); the rest run the '
                'host loop', sum(size in shared for size in sizes), len(sizes))
    return shared


def tiled_size(h: int, w: int, tile: int, bucket: bool) -> tuple[int, int]:
    return (h - h % -tile, w - w % -tile) if bucket else (h, w)


def load_model(path: str, device='cuda'):
    """A checkpoint through detection, or a ``.npz`` cache, onto ``device``."""
    import resselt_tpu_torch

    if path.endswith('.npz'):
        from resselt_tpu_torch.cache import load_model as load_cached

        return load_cached(path, device=device)
    return resselt_tpu_torch.load_from_file(path, device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='Upscale image(s) with an auto-detected SR model.')
    parser.add_argument('model', help='checkpoint file (.pth/.pt/.ckpt/.safetensors) or .npz cache')
    parser.add_argument('input', help='input image or directory')
    parser.add_argument('output', help='output image or directory')
    parser.add_argument('--tile', default='0',
                        help="tile size for tiled inference (0 = whole image; 'auto' = the arch's hint or 256); "
                             'sizes that several inputs share run one CUDA graph a size, the others the host loop')
    parser.add_argument('--scale', type=int, default=None,
                        help='pick a scale on an arbitrary-scale checkpoint (default = base scale)')
    parser.add_argument('--halo', type=int, default=None,
                        help="tile halo/overlap (default: the arch's hint at its tile, else derived)")
    parser.add_argument('--bucket', action='store_true',
                        help='pad inputs to tile multiples, so that the sizes of one bucket share one CUDA graph '
                             '(slight border deviation within the halo)')
    parser.add_argument('--bf16', action='store_true', help='run compute in bfloat16')
    parser.add_argument('--int8', action='store_true',
                        help='int8-quantize eligible conv weights (lossy; its speed on the card is in PERF.md)')
    parser.add_argument('--no-fused-attention', action='store_true',
                        help='run every window attention on the plain path instead of the window-attention kernel')
    parser.add_argument('--no-fused-lk', action='store_true',
                        help="run PLKSR's large-kernel convs as plain convs instead of the large-kernel kernel")
    parser.add_argument('--no-chunked-attention', action='store_true',
                        help="accepted for the JAX package's CLI; no effect: the port does not chunk attention")
    parser.add_argument('--precision', default=None, choices=['highest', 'tensorfloat32', 'bfloat16'],
                        help='f32 matmul/conv precision of the plain torch ops (default: torch\'s settings; '
                             'highest = TF32 off)')
    parser.add_argument('--device', default='cuda', help="torch device to run on (default cuda; 'cpu' runs the plain versions)")
    parser.add_argument('--trace', metavar='DIR', default=None,
                        help='write a torch.profiler trace of the run, loading included, to DIR, with the '
                             "library's spans (tile.*, model.*, load.*) as ranges")
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format='%(asctime)s %(name)s %(levelname)s %(message)s',
    )

    if not args.trace:
        return serve(args)
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(args.device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        rc = serve(args)
    os.makedirs(args.trace, exist_ok=True)
    path = os.path.join(args.trace, 'resselt_tpu_torch.trace.json')
    prof.export_chrome_trace(path)
    logger.info('wrote the profiler trace %s', path)
    return rc


def serve(args) -> int:
    """The CLI's work on parsed ``args``: load the model, then upscale
    every input.  ``main`` runs it under the profiler with ``--trace``, so
    that the trace holds the spans of loading and capture too."""
    import torch

    from .nn.window import fused_attention_enabled, use_fused_attention
    from .ops.fused_conv import fused_lk_enabled, use_fused_lk
    from .parallel import upscale_padded, upscale_tiled
    from .parallel.tiling import _resolve_tile_hint

    t0 = time.perf_counter()
    model = load_model(args.model, args.device)
    meta = model.metadata
    logger.info(
        'detected arch=%s name=%s upscale=%s in_ch=%d out_ch=%d config=%s on %s (%.2fs)',
        model.arch_id, meta.name, meta.upscale, meta.in_channels, meta.out_channels,
        type(model.config).__name__, model.device, time.perf_counter() - t0,
    )
    if args.scale is not None:
        scales = meta.upscale if isinstance(meta.upscale, (list, tuple)) else [meta.upscale]
        if args.scale not in scales:
            logger.error('model %s supports scale(s) %s, not %d', meta.name, list(scales), args.scale)
            return 1
        if hasattr(model.config, 'eval_scale'):
            model = model.with_config(eval_scale=args.scale)
    if args.int8:
        model = model.quantize_int8()
        logger.info('int8-quantized %d eligible conv weights (lossy serving mode)',
                    sum(v.dtype == torch.int8 for v in model.params.values()))

    dtype = torch.bfloat16 if args.bf16 else None
    if args.tile == 'auto':
        args.tile = _resolve_tile_hint(model, dtype or torch.float32)
        logger.info('tile auto -> %d', args.tile)
    else:
        try:
            args.tile = int(args.tile)
        except ValueError:
            logger.error("--tile must be an integer or 'auto', got %r", args.tile)
            return 1

    if os.path.isdir(args.input):
        names = sorted(n for n in os.listdir(args.input) if n.lower().endswith(IMAGE_EXTS))
        if not names:
            logger.error('no images found in %s', args.input)
            return 1
        pairs = [(os.path.join(args.input, n), os.path.join(args.output, n)) for n in names]
        os.makedirs(args.output, exist_ok=True)
    else:
        pairs = [(args.input, args.output)]
        out_dir = os.path.dirname(args.output)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    shared = repeated_sizes([src for src, _ in pairs], args.tile, args.bucket) if args.tile else set()

    def run_plane(img):
        if args.tile and (img.shape[0] > args.tile or img.shape[1] > args.tile):
            key = tiled_size(img.shape[0], img.shape[1], args.tile, args.bucket)
            return upscale_tiled(model, img, tile=args.tile, halo=args.halo, dtype=dtype, precision=args.precision,
                                 on_device=None if key in shared else False, bucket=args.bucket)
        if args.tile and args.bucket:
            return upscale_padded(model, img, multiple=args.tile, dtype=dtype, precision=args.precision)
        return model(img, dtype=dtype, precision=args.precision)

    def run(img):
        main_plane, alpha = adapt_channels(img, meta.in_channels)
        out = run_plane(main_plane)
        if alpha is not None:
            a3 = np.repeat(alpha, 3, axis=-1) if meta.in_channels == 3 else alpha
            a_out = run_plane(a3).float().mean(dim=-1, keepdim=True)
            rgb = out[..., :3] if out.shape[-1] >= 3 else out.repeat(1, 1, 3)
            out = torch.cat([rgb.float(), a_out], dim=-1)
        # quantize on the device: the uint8 copy to the host is 4x smaller than f32
        q = torch.clamp(out.float() * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        return q.cpu().numpy()

    def write_out(dst, out):
        save_image(dst, out)
        logger.info('wrote %s', dst)

    def run_all():
        # overlap host-side IO with the card: the next image decodes while
        # the card runs, and the PNG encode and write of one image happen
        # behind the next one's forward
        from concurrent.futures import ThreadPoolExecutor

        total_mp = 0.0
        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            next_img = pool.submit(load_image, pairs[0][0])
            pending_write = None
            try:
                for i, (src, dst) in enumerate(pairs):
                    img = next_img.result()
                    next_img = None
                    if i + 1 < len(pairs):
                        next_img = pool.submit(load_image, pairs[i + 1][0])
                    logger.info('input %s %dx%d', src, img.shape[1], img.shape[0])
                    ts = time.perf_counter()
                    out = run(img)
                    dt = time.perf_counter() - ts
                    mp = out.shape[0] * out.shape[1] / 1e6
                    total_mp += mp
                    logger.info('upscaled to %dx%d in %.2fs (%.2f MP out)', out.shape[1], out.shape[0], dt, mp)
                    if pending_write is not None:
                        pending_write.result()  # surface a write failure promptly
                    pending_write = pool.submit(write_out, dst, out)
                if pending_write is not None:
                    pending_write.result()
                    pending_write = None
            finally:
                # on an error: drain the futures in flight so that their
                # exceptions are reported here, not dropped
                for fut in (next_img, pending_write):
                    if fut is not None:
                        try:
                            fut.result()
                        except Exception as e:  # noqa: BLE001 - a second failure behind the first
                            logger.error('background IO failed: %s', e)
        if len(pairs) > 1:
            dt = time.perf_counter() - t1
            logger.info('%d images, %.2f MP total in %.2fs (%.2f MP/s)', len(pairs), total_mp, dt,
                        total_mp / max(dt, 1e-9))

    switches = fused_attention_enabled(), fused_lk_enabled()
    if args.no_fused_attention:
        use_fused_attention(False)
        logger.info('window-attention kernel off for this run (--no-fused-attention): plain path')
    if args.no_fused_lk:
        use_fused_lk(False)
        logger.info('large-kernel conv kernel off for this run (--no-fused-lk): plain conv')
    if args.no_chunked_attention:
        logger.info('--no-chunked-attention has no effect: the port does not chunk attention')
    try:
        run_all()
    finally:
        use_fused_attention(switches[0])
        use_fused_lk(switches[1])
    return 0


if __name__ == '__main__':
    sys.exit(main())
