#!/usr/bin/env python3
"""Time variants of one CUDA source of the port against each other, in one
process on one card.

    python3 tools/time_kernel_variants.py conv_lk '' '@_scratch/conv_lk_old.cu'
    python3 tools/time_kernel_variants.py molrcm '' '@_scratch/molrcm_no_r.cu'

Each argument after the source's name is one variant: extra nvcc flags
('' is the source as it stands), optionally led by ``@path``, another copy
of the source to build instead (an earlier version, or a copy with a stage
edited out to time it).  Every variant's library exports the C entry
points of the source as it stands; for conv_lk only the launch entry
(``resselt_conv_lk_bf16``, called here directly), for molrcm the entries
the wrapper types.  Every other variant is built from
``resselt_tpu_torch/csrc/<name>.cu``; each goes into a temporary directory,
then each is timed in turn at the bench shapes of the kernel (for conv_lk:
PLKSR's 16 -> 16 k 17 partial conv and the 16-channel-multiple shapes
whose path is chosen between tiles and mma.sync; for molrcm: EIMN_L's 16 x
256 x 256 x 64), bf16, with CUDA events, in the order A B .. B A so that a
drift of the card's clock shows.  Every variant's largest difference from
the plain version is reported beside its times (a copy with a stage edited
out is a timing probe and is expected to differ).  Prints one JSON line per
shape and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _cases(name: str):
    """(label, call(lib), plain, library or None) at the kernel's bench
    shapes; call(lib) runs the kernel of one variant's library."""
    import torch
    import torch.nn.functional as TF

    from resselt_tpu_torch.ops import _build

    gen = torch.Generator(device='cuda').manual_seed(0)
    if name == 'conv_lk':
        from resselt_tpu_torch.ops import fused_conv as fc

        def launch(lib, x, taps, b, y, k):
            fn = lib.resselt_conv_lk_bf16
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            n, h, w_, cin = x.shape
            rc = fn(x.data_ptr(), taps.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, w_, cin, y.shape[-1],
                    x.stride(2), k, 0, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f'launch failed: CUDA error {rc}')
            return y

        # PLKSR's bench shape, then the Cin 16 / 32 / 64 shapes that the tiles and mma paths share
        for n, h, w_, cin, cout, k, pitch in ((16, 256, 256, 16, 16, 17, 64), (16, 256, 256, 32, 32, 17, 32),
                                               (16, 256, 256, 64, 64, 17, 64), (16, 256, 256, 16, 16, 31, 16),
                                               (16, 256, 256, 32, 24, 13, 32), (16, 256, 256, 64, 64, 3, 64),
                                               (1, 21, 23, 64, 40, 31, 64)):
            wide = torch.randn((n, h, w_, pitch), generator=gen, device='cuda').to(torch.bfloat16)
            x = wide[..., :cin]
            w = torch.randn((cout, cin, k, k), generator=gen, device='cuda') / (k * cin ** 0.5)
            b = torch.randn((cout,), generator=gen, device='cuda')
            taps = fc.pack_conv_lk_weight(w, torch.bfloat16)
            y = torch.empty((n, h, w_, cout), dtype=torch.bfloat16, device='cuda')
            x_cl = x.contiguous().permute(0, 3, 1, 2)
            wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            yield (f'k{k} {cin}->{cout} {n}x{h}x{w_}',
                   lambda lib, x=x, taps=taps, b=b, y=y, k=k: launch(lib, x, taps, b, y, k),
                   lambda x=x, taps=taps, b=b, k=k: fc.fused_conv_lk_ref(x.float(), taps.float(), b, k=k),
                   lambda x_cl=x_cl, wb=wb, b=b, k=k: TF.conv2d(x_cl, wb, b.to(torch.bfloat16), padding=k // 2))
    elif name == 'molrcm':
        from resselt_tpu_torch.nn.params import PTree
        from resselt_tpu_torch.ops import molrcm as mo

        def launch(lib, x, packed):
            _build._libs['molrcm'] = lib  # the wrapper's next load() returns it (and types it anew)
            return mo.fused_molrcm(x, packed)

        params = {}
        for key, (o, i, k) in {'proj_value.0': (64, 64, 1), 'proj_query.0': (64, 64, 1), 'region': (64, 1, 5),
                               'spatial_1': (24, 1, 5), 'spatial_2': (32, 1, 7), 'fusion': (64, 64, 1),
                               'out': (64, 64, 1)}.items():
            params[f'{key}.weight'] = torch.randn((o, i, k, k), generator=gen, device='cuda') / (k * i ** 0.5)
            params[f'{key}.bias'] = torch.randn((o,), generator=gen, device='cuda') * 0.1
        x = torch.randn((16, 256, 256, 64), generator=gen, device='cuda').to(torch.bfloat16)
        packed = mo.pack_molrcm_weights(PTree(params), torch.bfloat16)
        yield ('bench 16x256x256x64', lambda lib: launch(lib, x, packed),
               lambda: mo.fused_molrcm_ref(x.float(), packed), None)
    else:
        raise SystemExit(f'no cases for {name!r}')


def main(argv: list[str]) -> int:
    import torch

    from resselt_tpu_torch.ops import _build

    if len(argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    name, variants = argv[0], argv[1:]
    src = os.path.join(_build.CSRC, f'{name}.cu')
    libs = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, flags in enumerate(variants):
            out = os.path.join(tmp, f'{name}-{i}.so')
            extra = flags.split()
            source = extra.pop(0)[1:] if extra and extra[0].startswith('@') else src
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-I', _build.CSRC, *extra, '-o', out, source]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out))
        for flags, (proc, out) in zip(variants, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(log[-6000:], file=sys.stderr)
                return 1
            warn = [ln.strip()[:160] for ln in log.splitlines() if 'Potential Performance Loss' in ln]
            regs = [ln.split('Used ')[1].split(',')[0] for ln in log.splitlines() if 'Used ' in ln]
            spills = [ln.strip() for ln in log.splitlines() if 'spill stores' in ln and not ln.strip().startswith('0 bytes stack')]
            print(json.dumps({'variant': flags, 'registers': regs, 'spills': spills,
                              'serialization_warnings': warn}), flush=True)
            libs.append(ctypes.CDLL(out))

    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for label, call, plain, library in _cases(name):
        want = plain()
        times: dict[int, list[float]] = {i: [] for i in range(len(libs))}
        errs = {}
        for i in range(len(libs)):
            got = call(libs[i]).float()
            errs[variants[i] or 'as is'] = float((got - want.float()).abs().max())
        for i in order:
            times[i].append(_ms(lambda: call(libs[i])))
        row = {'shape': label, 'ms': {variants[i] or 'as is': times[i] for i in times}, 'max_abs_err': errs,
               'max_abs_plain': float(want.float().abs().max())}
        if library is not None:
            row['library_ms'] = _ms(library)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
