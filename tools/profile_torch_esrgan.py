#!/usr/bin/env python3
"""Where one bf16 ESRGAN RRDBNet-23 4x forward of resselt_tpu_torch spends
its device time, at bench.py's config (batch 16 of 256x256 tiles).

    python3 tools/profile_torch_esrgan.py [--reps 2] [--seed 0]

Runs on a CUDA device only.  Warms up, then records ``--reps`` forwards
under torch.profiler and prints one JSON line: the window's wall time per
forward, device time per forward summed by kernel name (the top entries),
the share of it in the conv3x3 kernel, and the device busy share of the
window (the union of device-event intervals over the wall time).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--reps', type=int, default=2)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--top', type=int, default=8)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print('profile_torch_esrgan: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import resselt_tpu_torch
    from resselt_tpu_torch.zoo import make_esrgan

    model = resselt_tpu_torch.load_from_state_dict(make_esrgan(64, 23, 4, seed=args.seed), device='cuda')
    x = torch.rand((16, 256, 256, 3), generator=torch.Generator().manual_seed(args.seed)).cuda()
    for _ in range(2):
        model(x, dtype=torch.bfloat16)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            model(x, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies); CUPTI's "Command Buffer
    # Full" marks the host waiting on a full launch queue, not device work
    by_name: dict[str, list[float]] = {}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith('Command Buffer Full'):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += (e.time_range.end - e.time_range.start) / 1e3
        acc[1] += 1
    rows = [(k, ms / args.reps, n // args.reps) for k, (ms, n) in by_name.items()]
    busy_us, last_end = 0.0, None
    for start, end in sorted(spans):
        if last_end is None or start >= last_end:
            busy_us += end - start
            last_end = end
        elif end > last_end:
            busy_us += end - last_end
            last_end = end
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    conv_ms = sum(r[1] for r in rows if 'conv3x3' in r[0])
    out = {
        'device': torch.cuda.get_device_name(0),
        'config': 'ESRGAN RRDBNet-23 nf64 4x, bf16, batch 16 x 256x256',
        'wall_ms_per_forward': wall * 1e3 / args.reps,
        'device_ms_per_forward': device_ms,
        'conv3x3_ms_per_forward': conv_ms,
        'conv3x3_share_of_device': conv_ms / device_ms if device_ms else None,
        'device_busy_share': busy_us / 1e3 / (wall * 1e3) if device_ms else None,
        'top': [{'kernel': k[:120], 'ms_per_forward': ms, 'launches_per_forward': n} for k, ms, n in rows[: args.top]],
    }
    print(json.dumps(out))
    if not device_ms:
        print('profile_torch_esrgan: the profiler recorded no device time', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
