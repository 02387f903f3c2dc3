"""Checkpoint inspector CLI.

    python -m resselt_tpu_torch.inspect MODEL [--size H W] [--json]

Counterpart of ``resselt_tpu/inspect.py``, with its ``--json`` fields:
the detected architecture, inferred config, parameter count and the cost
of one forward at the given size (``SRModel.cost``: FLOPs counted by
``torch.utils.flop_counter`` over the plain path on the CPU; no byte
count, reported as -1).  ``MODEL`` is a checkpoint or a ``.npz`` cache;
it is loaded on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description='Inspect a checkpoint: detection, config, cost.')
    parser.add_argument('model', help='checkpoint file or .npz cache')
    parser.add_argument('--size', type=int, nargs=2, default=(256, 256), metavar=('H', 'W'),
                        help='input size for the cost analysis')
    parser.add_argument('--json', action='store_true', help='machine-readable output')
    parser.add_argument('--device', default='cuda', help='torch device to load on (default cuda)')
    args = parser.parse_args(argv)

    from resselt_tpu_torch.upscale import load_model

    model = load_model(args.model, args.device)
    meta = model.metadata
    cfg = dataclasses.asdict(model.config) if dataclasses.is_dataclass(model.config) else {}
    cost = model.cost(*args.size)

    info = {
        'arch': model.arch_id,
        'name': meta.name,
        'upscale': meta.upscale if isinstance(meta.upscale, int) else list(meta.upscale),
        'in_channels': meta.in_channels,
        'out_channels': meta.out_channels,
        'params': cost['params'],
        'config': {k: (list(v) if isinstance(v, tuple) else v) for k, v in cfg.items()
                   if isinstance(v, (int, float, str, bool, tuple)) or v is None},
        'cost_at_size': {'input': list(args.size), 'gflops': round(cost['flops'] / 1e9, 2),
                         'gbytes_accessed': round(cost['bytes_accessed'] / 1e9, 3)},
    }
    if args.json:
        print(json.dumps(info))
        return 0
    print(f'arch:        {info["arch"]} ({info["name"]})')
    print(f'upscale:     {info["upscale"]}x, {meta.in_channels}ch -> {meta.out_channels}ch')
    print(f'params:      {cost["params"]:,}')
    print(f'cost @{args.size[0]}x{args.size[1]}: {info["cost_at_size"]["gflops"]} GFLOP '
          '(bytes accessed: not counted)')
    print('config:')
    for k, v in info['config'].items():
        print(f'  {k} = {v}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
