"""Checkpoint pre-conversion CLI.

    python -m resselt_tpu_torch.convert MODEL OUT.npz           # fast-startup cache
    python -m resselt_tpu_torch.convert MODEL OUT.safetensors   # torch-ecosystem export

Counterpart of ``resselt_tpu/convert.py``.  ``.npz``: detects the
architecture, runs every load-time weight transform (key remapping,
reparameterization collapse, config inference) once, and writes the
ready-to-serve model (``resselt_tpu_torch.cache``, the JAX package's
layout); loading it skips pickle parsing and all transforms.
``.safetensors``: writes the loaded weights in the standard safetensors
format, readable by torch tooling and by this package's detection; also
the safe way to defuse an untrusted ``.pth``.  The model is loaded on
``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

logger = logging.getLogger('resselt_tpu_torch')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='Convert a checkpoint to a resselt_tpu_torch .npz cache.')
    parser.add_argument('model', help='checkpoint file (.pth/.pt/.ckpt/.safetensors)')
    parser.add_argument('output', help='output path (.npz cache or .safetensors export)')
    parser.add_argument('--device', default='cuda', help="torch device to load on (default cuda)")
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format='%(asctime)s %(name)s %(levelname)s %(message)s',
    )
    if not args.output.endswith(('.npz', '.safetensors')):
        parser.error('output must end in .npz or .safetensors')

    import resselt_tpu_torch
    from resselt_tpu_torch.cache import save_model
    from resselt_tpu_torch.io import write_safetensors

    t0 = time.perf_counter()
    model = resselt_tpu_torch.load_from_file(args.model, device=args.device)
    meta = model.metadata
    logger.info(
        'detected arch=%s name=%s upscale=%s in_ch=%d out_ch=%d (%.2fs)',
        model.arch_id, meta.name, meta.upscale, meta.in_channels, meta.out_channels,
        time.perf_counter() - t0,
    )
    if args.output.endswith('.safetensors'):
        params = {k: v.detach().cpu().numpy() for k, v in model.params.items()}
        write_safetensors(params, args.output, metadata={'arch': model.arch_id, 'name': meta.name})
    else:
        save_model(model, args.output)
    logger.info('wrote %s', args.output)
    return 0


if __name__ == '__main__':
    sys.exit(main())
