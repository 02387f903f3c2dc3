#!/usr/bin/env python3
"""Where one bf16 forward of resselt_tpu_torch spends its device time, at
bench.py's serving shape (batch 16 of 256x256 tiles): ESRGAN RRDBNet-23 4x
(default), PLKSR dim 64, 28 blocks, k 17, 4x (``--model plksr``), SwinIR-M
4x classical, embed 180, depths and heads (6,) x 6, window 8
(``--model swinir``), EIMN_L, embed 64, 16 stages, mlp ratio 2.66, 4x
(``--model eimn``), ATD-light 4x, embed 48, depths (6,) x 5, window 16
(``--model atd``), HAT-S 4x, embed 144, depths (6,) x 6, window 16
(``--model hat``), DAT-S 4x, embed 180, depth and heads (6,) x 6, split
(8, 16) (``--model dat``), RGT-S 4x, embed 180, depth and heads (6,) x 6,
split (8, 32) (``--model rgt``), DRCT 4x, embed 180, six groups, 6 heads,
window 16, gc 32 (``--model drct``), FDAT-M 4x, embed 120, 4 groups of 3
spatial / channel pairs, 4 heads, window 8, transpose+conv (``--model
fdat``), OmniSR 4x, 64 features, five groups of one OSA block, window 8
(``--model omni``), or one of the six 3x3-conv families on the conv3x3
kernel: Compact 4x, 64 features, 16 convs (``--model compact``), SPAN 4x, 48
features (``--model span``), SPANPlus 2x, blocks (4,), 48 features, ``ps``
(``--model spanplus``), MoSR 4x, 24 blocks, dim 64, ``ps`` (``--model
mosr``), SpanPP 2x, 48 features, zoo.make_spanpp's IGConv (``--model
spanpp``), RCAN 4x, 10 groups of 20 RCABs, 64 features (``--model rcan``),
or CUGAN 2x, UpCunet2x, all plain torch (``--model cugan``), or one of the
restoration U-nets and the MoSR lineage at chip_smoke.py's widths: GateR
1x, dim 64, blocks (2, 2, 2, 4, 2, 2, 2), FLPVT2 latent (``--model
gater``), MoSRv2 4x, dim 64, 24 blocks, pixelshuffledirect (``--model
mosrv2``), MoESR 4x, dim 64, 6 x 6 blocks, expansion 2.5 (``--model
moesr``), GateRv2 1x, dim 32, enc (2, 2, 4), dec (4, 2, 2), 6 latent blocks
(``--model gaterv2``), GateRV3 1x, dim 32, the same U-Net, 4 latent blocks
with channel attention, 4 SPABs (``--model gaterv3``), or one of the last
eight at chip_smoke.py's widths: RTMoSR 2x, dim 64, 2 blocks, unshuffle
(``--model rtmosr``), SMoSR 4x, dim 64, 2 middle blocks (``--model
smosr``), RHA 4x, dim 64, 4 groups of 6 blocks (``--model rha``), FlexNet
4x, dim 64, six groups of six blocks, with the window-attention kernel too
(``--model flexnet``), GFISR 4x, dim 64, 24 blocks (``--model gfisr``),
GFISRV2 4x, dim 64, 22 blocks (``--model gfisrv2``), FIGSR 4x, dim 64, 18
blocks (``--model figsr``), LAWFFT 4x, dim 64, 4 x 6 meta blocks
(``--model lawfft``).

    python3 tools/profile_torch_esrgan.py
        [--model esrgan|plksr|swinir|eimn|atd|hat|dat|rgt|drct|fdat|omni|compact|span|spanplus|mosr|spanpp|rcan
                 |cugan|gater|mosrv2|moesr|gaterv2|gaterv3|rtmosr|smosr|rha|flexnet|gfisr|gfisrv2|figsr|lawfft]
        [--reps 2] [--seed 0]

Runs on a CUDA device only.  Warms up, then records ``--reps`` forwards
under torch.profiler and prints one JSON line: the window's wall time per
forward, device time per forward summed by kernel name (the top entries),
the share of it in the model's hand-written kernels (conv3x3 / conv_lk /
wattn / molrcm / row_gather; ATD has two, reported together and apart),
and the device busy share of the window (the union of device-event
intervals over the wall time).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--model', choices=('esrgan', 'plksr', 'swinir', 'eimn', 'atd', 'hat', 'dat', 'rgt', 'drct',
                                            'fdat', 'omni', 'compact', 'span', 'spanplus', 'mosr', 'spanpp', 'rcan',
                                            'cugan', 'gater', 'mosrv2', 'moesr', 'gaterv2', 'gaterv3', 'rtmosr',
                                            'smosr', 'rha', 'flexnet', 'gfisr', 'gfisrv2', 'figsr', 'lawfft'),
                        default='esrgan')
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
    from resselt_tpu_torch.zoo import (make_atd, make_compact, make_cugan, make_dat, make_drct, make_eimn,
                                       make_esrgan, make_fdat, make_figsr, make_flexnet, make_gater, make_gaterv2,
                                       make_gaterv3, make_gfisr, make_gfisrv2, make_hat, make_lawfft, make_moesr,
                                       make_mosr, make_mosrv2, make_omni, make_plksr, make_rcan, make_rgt, make_rha,
                                       make_rtmosr, make_smosr, make_span, make_spanplus, make_spanpp, make_swinir)

    conv_families = {
        'compact': (lambda: make_compact(64, 16, 4, seed=args.seed), 'Compact 4x feat64 16 convs'),
        'span': (lambda: make_span(48, 4, seed=args.seed), 'SPAN 4x feat48'),
        'spanplus': (lambda: make_spanplus(48, (4,), 2, seed=args.seed), 'SPANPlus 2x blocks (4,) feat48 ps'),
        'mosr': (lambda: make_mosr(64, 24, 4, seed=args.seed), 'MoSR 4x 24 blocks dim64 ps'),
        'spanpp': (lambda: make_spanpp(48, seed=args.seed), 'SpanPP 2x feat48 IGConv k3 implicit256 latent4'),
        'rcan': (lambda: make_rcan(seed=args.seed), 'RCAN 4x 10 groups x 20 RCABs feat64 reduction16'),
        'cugan': (lambda: make_cugan('2x', seed=args.seed), 'CUGAN 2x UpCunet2x, plain torch (no kernel)'),
        'gater': (lambda: make_gater(64, (2, 2, 2, 4, 2, 2, 2), seed=args.seed, latent_att=True),
                  'GateR 1x dim64 blocks (2,2,2,4,2,2,2) FLPVT2 latent'),
        'mosrv2': (lambda: make_mosrv2(64, 24, 4, seed=args.seed), 'MoSRv2 4x dim64 24 blocks pixelshuffledirect rms'),
        'moesr': (lambda: make_moesr(64, 6, 6, 4, seed=args.seed), 'MoESR 4x dim64 6x6 blocks expansion2.5'),
        'gaterv2': (lambda: make_gaterv2(32, (2, 2, 4), (4, 2, 2), 6, seed=args.seed),
                    'GateRv2 1x dim32 enc(2,2,4) dec(4,2,2) latent6'),
        'gaterv3': (lambda: make_gaterv3(32, (2, 2, 4), (4, 2, 2), 4, seed=args.seed),
                    'GateRV3 1x dim32 enc(2,2,4) dec(4,2,2) latent4 attention span4'),
        'rtmosr': (lambda: make_rtmosr(seed=args.seed), 'RTMoSR 2x dim64 2 blocks ffn2 unshuffle dccm se'),
        'smosr': (lambda: make_smosr(seed=args.seed), 'SMoSR 4x dim64 2 middle blocks pixelshuffledirect'),
        'rha': (lambda: make_rha(seed=args.seed), 'RHA 4x dim64 down (8,4,2,1) x 6 blocks window8 pixelshuffle'),
        'gfisr': (lambda: make_gfisr(seed=args.seed), 'GFISR 4x dim64 24 blocks fft_mode pixelshuffledirect'),
        'gfisrv2': (lambda: make_gfisrv2(seed=args.seed), 'GFISRV2 4x dim64 22 blocks pixelshuffledirect'),
        'figsr': (lambda: make_figsr(seed=args.seed), 'FIGSR 4x dim64 18 blocks gc8 pixelshuffledirect'),
        'lawfft': (lambda: make_lawfft(seed=args.seed), 'LAWFFT 4x dim64 4x6 meta blocks window8'),
    }
    if args.model in conv_families:
        make, config = conv_families[args.model]
        sd, kernel = make(), 'conv3x3'
    elif args.model == 'flexnet':
        sd, kernel, config = (make_flexnet(seed=args.seed), 'conv3x3+wattn',
                              'FlexNet 4x dim64 linear 6 groups x 6 blocks window8 ps')
    elif args.model == 'fdat':
        sd, kernel, config = (make_fdat(120, 4, 3, 4, 8, 2.0, 8, 64, 'transpose+conv', 4, seed=args.seed), 'wattn',
                              'FDAT-M 4x embed120 4 groups x 3 pairs heads4 window8 transpose+conv')
    elif args.model == 'omni':
        sd, kernel, config = (make_omni(64, 1, True, 8, 5, 4, seed=args.seed), 'wattn',
                              'OmniSR 4x feat64 5 groups x 1 OSA block window8 pe')
    elif args.model == 'dat':
        sd, kernel, config = (make_dat(180, (6,) * 6, (6,) * 6, (8, 16), 2.0, 4, seed=args.seed), 'wattn',
                              'DAT-S 4x embed180 depth6x6 split8x16')
    elif args.model == 'rgt':
        sd, kernel, config = (make_rgt(180, (6,) * 6, (6,) * 6, (8, 32), 2.0, 0.5, 4, seed=args.seed), 'wattn',
                              'RGT-S 4x embed180 depth6x6 split8x32')
    elif args.model == 'drct':
        sd, kernel, config = (make_drct(180, 6, 6, 16, 32, 2.0, 4, seed=args.seed), 'wattn',
                              'DRCT 4x embed180 6 groups heads6 window16 gc32')
    elif args.model == 'atd':
        sd, kernel, config = (make_atd(48, (6,) * 5, (4,) * 5, 16, 64, 8, 7, 1.0, 4, seed=args.seed),
                              'wattn+row_gather', 'ATD-light 4x embed48 depths6x5 window16 category128')
    elif args.model == 'hat':
        sd, kernel, config = (make_hat(144, (6,) * 6, (6,) * 6, 16, 0.5, 24, 24, 2.0, 4, 64, seed=args.seed),
                              'wattn', 'HAT-S 4x embed144 depths6x6 window16 overlap0.5')
    elif args.model == 'eimn':
        sd, kernel, config = (make_eimn(64, 16, 1, 2.66, 4, seed=args.seed), 'molrcm',
                              'EIMN_L embed64 16 stages mlp2.66 4x')
    elif args.model == 'swinir':
        sd, kernel, config = (make_swinir(180, (6,) * 6, (6,) * 6, 8, upscale=4, img_size=64, seed=args.seed),
                              'wattn', 'SwinIR-M 4x classical embed180 depths6x6 window8')
    elif args.model == 'plksr':
        sd, kernel, config = make_plksr(64, 28, 4, 17, seed=args.seed), 'conv_lk', 'PLKSR dim64 28 blocks k17 4x'
    else:
        sd, kernel, config = make_esrgan(64, 23, 4, seed=args.seed), 'conv3x3', 'ESRGAN RRDBNet-23 nf64 4x'
    model = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    if args.model == 'spanpp':
        model = model.with_config(eval_scale=2)
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
    parts = {k: sum(r[1] for r in rows if k in r[0]) for k in kernel.split('+')}
    kernel_ms = sum(parts.values())
    out = {
        'device': torch.cuda.get_device_name(0),
        'config': config + ', bf16, batch 16 x 256x256',
        'wall_ms_per_forward': wall * 1e3 / args.reps,
        'device_ms_per_forward': device_ms,
        f'{kernel}_ms_per_forward': kernel_ms,
        f'{kernel}_share_of_device': kernel_ms / device_ms if device_ms else None,
        **({f'{k}_ms_per_forward': ms for k, ms in parts.items()} if len(parts) > 1 else {}),
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
