"""Command-line upscaler.

    python -m resselt_tpu_torch.upscale MODEL INPUT OUTPUT [--tile 256] [--halo 4] [--bf16]

``INPUT``/``OUTPUT`` may be single images or directories (batch mode).
``MODEL`` is any supported checkpoint.  The model runs on ``--device``
(default cuda).  Counterpart of ``resselt_tpu/upscale.py``.
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='Upscale image(s) with an auto-detected SR model.')
    parser.add_argument('model', help='checkpoint file (.pth/.pt/.ckpt/.safetensors)')
    parser.add_argument('input', help='input image or directory')
    parser.add_argument('output', help='output image or directory')
    parser.add_argument('--tile', default='0',
                        help="tile size for tiled inference (0 = whole image; 'auto' = the arch's hint or 256)")
    parser.add_argument('--scale', type=int, default=None,
                        help='pick a scale on an arbitrary-scale checkpoint (default = base scale)')
    parser.add_argument('--halo', type=int, default=None,
                        help="tile halo/overlap (default: the arch's hint at its tile, else derived)")
    parser.add_argument('--bucket', action='store_true',
                        help='pad inputs to tile multiples (slight border deviation within the halo)')
    parser.add_argument('--bf16', action='store_true', help='run compute in bfloat16')
    parser.add_argument('--device', default='cuda', help="torch device to run on (default cuda; 'cpu' runs the plain versions)")
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format='%(asctime)s %(name)s %(levelname)s %(message)s',
    )

    import torch

    import resselt_tpu_torch

    from .parallel import upscale_padded, upscale_tiled
    from .parallel.tiling import _resolve_tile_hint

    t0 = time.perf_counter()
    model = resselt_tpu_torch.load_from_file(args.model, device=args.device)
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

    def run_plane(img):
        if args.tile and (img.shape[0] > args.tile or img.shape[1] > args.tile):
            return upscale_tiled(model, img, tile=args.tile, halo=args.halo, dtype=dtype, bucket=args.bucket)
        if args.tile and args.bucket:
            return upscale_padded(model, img, multiple=args.tile, dtype=dtype)
        return model(img, dtype=dtype)

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

    total_mp = 0.0
    t1 = time.perf_counter()
    for src, dst in pairs:
        img = load_image(src)
        logger.info('input %s %dx%d', src, img.shape[1], img.shape[0])
        ts = time.perf_counter()
        out = run(img)
        dt = time.perf_counter() - ts
        mp = out.shape[0] * out.shape[1] / 1e6
        total_mp += mp
        logger.info('upscaled to %dx%d in %.2fs (%.2f MP out)', out.shape[1], out.shape[0], dt, mp)
        save_image(dst, out)
        logger.info('wrote %s', dst)
    if len(pairs) > 1:
        dt = time.perf_counter() - t1
        logger.info('%d images, %.2f MP total in %.2fs (%.2f MP/s)', len(pairs), total_mp, dt, total_mp / max(dt, 1e-9))
    return 0


if __name__ == '__main__':
    sys.exit(main())
