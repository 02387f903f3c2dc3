#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (resselt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each: device, build (nvcc of resselt_tpu_torch/csrc/*.cu),
kernels (every ESRGAN 3x3 conv shape: kernel against its plain version in
f32 and bf16, then kernel / plain / library / bound times at the bench
shapes), load (a seeded ESRGAN RRDBNet-23 4x checkpoint written as
.safetensors and .pth and loaded through the public entry points), model
(f32 on the card against the CPU, 351 kernel launches per forward, bf16
against f32), serve (the main path: the bench config, batch 16 of 256x256
tiles in bf16, then a tiled 1280x720 image, then the upscale CLI on a PNG;
the launch counts start from 0 just before it, the bench forwards must
launch 351 convs each, all at shapes the kernels phase checked, and each
shape's launches per forward are read from those forwards' counts).  Then the
card's name and power limit, one JSON line of kernel figures, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without a
CUDA device, or without the package beside this script, it exits 1 before
printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's headline configuration
BENCH = {'num_blocks': 23, 'num_filters': 64, 'scale': 4, 'tile': 256, 'batch': 16}

# H100 SXM dense peaks (NVIDIA data sheet) for bound_ms
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12

F32_TOL = 1e-4     # rtol = atol: exact f32 FMA against cuDNN f32 with TF32 off
BF16_RTOL = 2e-2   # bf16 output rounding (2^-9 relative) with margin
BF16_ATOL = 1e-3
MODEL_TOL = 5e-4   # tests/test_conv_archs.py's TOL for ESRGAN
BF16_PSNR = 35.0   # tests/test_parallel.py's bf16-vs-f32 floor


def log(phase: str, **fields) -> None:
    print(f'[{phase}] ' + ' '.join(f'{k}={v}' for k, v in fields.items()), flush=True)


def conv_shapes(n: int, tile: int) -> list[dict]:
    """Every distinct 3x3 conv (shape, activation) of ESRGAN RRDBNet nf64
    gc32 4x at a batch of ``n`` ``tile``-square inputs, plus the
    pixel-unshuffle checkpoints' heads and the pack2 entry.  How often the
    main path launches each is counted in the serve phase, not listed here."""
    t, t2, t4 = tile, 2 * tile, 4 * tile
    rows = [
        ('head 3->64', 'act', n, t, t, 3, 64, 'linear'),
        ('rdb stage0 64->192', 'act', n, t, t, 64, 192, 'linear'),
        ('rdb stage1 32->160', 'act', n, t, t, 32, 160, 'linear'),
        ('rdb stage2 32->128', 'act', n, t, t, 32, 128, 'linear'),
        ('rdb stage3 32->96', 'act', n, t, t, 32, 96, 'linear'),
        ('rdb stage4 32->64', 'act', n, t, t, 32, 64, 'linear'),
        ('trunk 64->64', 'act', n, t, t, 64, 64, 'linear'),
        ('upconv1 64->64', 'act', n, t2, t2, 64, 64, 'lrelu'),
        ('upconv2/hrconv 64->64', 'act', n, t4, t4, 64, 64, 'lrelu'),
        ('last 64->3', 'act', n, t4, t4, 64, 3, 'linear'),
        ('unshuffle2 head 12->64', 'act', n, t // 2, t // 2, 12, 64, 'linear'),
        ('unshuffle4 head 48->64', 'act', n, t // 4, t // 4, 48, 64, 'linear'),
        ('pack2 64->64', 'pack2', n, t, t, 64, 64, 'lrelu'),
    ]
    keys = ('name', 'entry', 'n', 'h', 'w', 'cin', 'cout', 'act')
    return [dict(zip(keys, r)) for r in rows]


def shape_key(s: dict) -> tuple:
    """The key under which the wrapper's ``by_shape`` counts ``s``."""
    return (s['n'], s['h'], s['w'], s['cin'], s['cout'], s['act'])


def _ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(s: dict, dtype_name: str) -> tuple[float, str]:
    """Least time for one conv on an H100: the larger of its bytes (x read
    once, weights and bias read once, y written once) over the memory rate
    and its FLOPs over the dense peak for the dtype."""
    size = 2 if dtype_name == 'bfloat16' else 4
    px = s['n'] * s['h'] * s['w']
    nbytes = px * (s['cin'] + s['cout']) * size + 9 * s['cin'] * s['cout'] * size + 4 * s['cout']
    flops = 2 * px * 9 * s['cin'] * s['cout']
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def phase_kernels(device, shapes: list[dict], reps: int) -> list[dict]:
    """Each shape: kernel against its plain version in f32 (TF32 off) and in
    bf16 (plain version in f32 from the same bf16 inputs), then kernel /
    plain / library / bound times in bf16."""
    import torch
    import torch.nn.functional as TF

    from resselt_tpu_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for s in shapes:
        entry = fc.fused_conv3x3_act if s['entry'] == 'act' else fc.fused_conv3x3_pack2
        ref = fc.fused_conv3x3_act_ref if s['entry'] == 'act' else fc.fused_conv3x3_pack2_ref
        x = torch.randn((s['n'], s['h'], s['w'], s['cin']), generator=gen, device=device)
        w = torch.randn((s['cout'], s['cin'], 3, 3), generator=gen, device=device) / (3 * s['cin'] ** 0.5)
        b = torch.randn((s['cout'],), generator=gen, device=device)

        taps32 = fc.pack_conv3x3_weight(w, torch.float32)
        got = entry(x, taps32, b, act=s['act'])
        want = ref(x, taps32, b, act=s['act'])
        err32 = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)

        xb = x.to(torch.bfloat16)
        tapsb = fc.pack_conv3x3_weight(w, torch.bfloat16)
        gotb = entry(xb, tapsb, b, act=s['act'])
        wantb = ref(xb.float(), tapsb.float(), b, act=s['act'])
        errb = (gotb.float() - wantb).abs().max().item()
        torch.testing.assert_close(gotb.float(), wantb, rtol=BF16_RTOL, atol=BF16_ATOL)
        del got, want, gotb, wantb

        row = {'name': s['name'], 'entry': s['entry'], 'shape': [s['n'], s['h'], s['w'], s['cin'], s['cout']],
               'act': s['act'], 'max_abs_err_f32': err32, 'max_abs_err_bf16': errb}
        wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x_cl = xb.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW view
        bb = b.to(torch.bfloat16)
        row['ms'] = _ms(lambda: entry(xb, tapsb, b, act=s['act']), reps)
        row['plain_ms'] = _ms(lambda: ref(xb, tapsb, b, act=s['act']), reps)
        row['library_ms'] = _ms(lambda: TF.conv2d(x_cl, wb, bb, padding=1), reps)
        row['bound_ms'], row['bound_by'] = bound_ms(s, 'bfloat16')
        if s['name'] == 'rdb stage0 64->192':
            row['ms_f32'] = _ms(lambda: entry(x, taps32, b, act=s['act']), reps)
            row['bound_ms_f32'] = bound_ms(s, 'float32')[0]
        del x, xb, x_cl, wb
        torch.cuda.empty_cache()
        out.append(row)
    return out


def phase_load(device, num_filters: int, num_blocks: int, scale: int, tmp: str):
    """Write a seeded checkpoint as .safetensors and .pth, load both."""
    import numpy as np
    import torch

    import resselt_tpu_torch
    from resselt_tpu_torch.core import ModelMetadata
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.zoo import make_esrgan

    sd = make_esrgan(num_filters, num_blocks, scale, seed=0)
    st = os.path.join(tmp, 'esrgan.safetensors')
    pth = os.path.join(tmp, 'esrgan.pth')
    write_safetensors(sd, st)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    models = [resselt_tpu_torch.load_from_file(p, device=device) for p in (st, pth)]
    for m in models:
        if m.arch_id != 'ESRGAN' or m.metadata != ModelMetadata(3, 3, scale, 'ESRGAN'):
            raise AssertionError(f'detected {m.arch_id} {m.metadata}')
        for k, v in sd.items():
            if not np.array_equal(m.params[k].cpu().numpy(), v):
                raise AssertionError(f'{k} differs after load')
    return models[0], sd, st


def phase_model(model, sd, size: int):
    """f32 on the card against the CPU, launch count, bf16 against f32."""
    import numpy as np
    import torch

    import resselt_tpu_torch
    from resselt_tpu_torch.ops import fused_conv as fc

    x = np.random.default_rng(0).random((1, size, size, 3), dtype=np.float32)
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    want = cpu(x).numpy()
    before = fc.fused_conv3x3_act.launches
    got32 = model(x)
    torch.cuda.synchronize()
    launches = fc.fused_conv3x3_act.launches - before
    err = float(np.abs(got32.cpu().numpy() - want).max())
    if got32.shape != want.shape or not err < MODEL_TOL:
        raise AssertionError(f'f32 card vs cpu: shape {tuple(got32.shape)} vs {want.shape}, max err {err}')
    gotb = model(x, dtype=torch.bfloat16).float()
    mse = float(((gotb - got32) ** 2).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    if not psnr > BF16_PSNR:
        raise AssertionError(f'bf16 vs f32 PSNR {psnr:.2f} dB')
    return {'max_abs_err_f32': err, 'launches_per_forward': launches, 'bf16_psnr_db': round(psnr, 2)}


def phase_serve(model, ckpt: str, tmp: str, batch: int, tile: int, timed_reps: int, img_hw: tuple[int, int]):
    """The main path: the bench config through SRModel.__call__, a tiled
    image through upscale_tiled, and a PNG through the CLI.  Every launch
    count starts from 0 just before the timed bench forwards; their counts
    are read just after them (``bench_counts``), and the whole phase's at
    its end (``launches``)."""
    import numpy as np
    import torch

    from resselt_tpu_torch import upscale
    from resselt_tpu_torch.ops import fused_conv as fc
    from resselt_tpu_torch.parallel import upscale_tiled

    entries = {'act': fc.fused_conv3x3_act, 'pack2': fc.fused_conv3x3_pack2}
    res = {}
    x = torch.rand((batch, tile, tile, 3), generator=torch.Generator().manual_seed(1)).to(model.device)
    for _ in range(2):
        y = model(x, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    for e in entries.values():
        e.launches = 0
        e.by_shape.clear()
    t0 = time.perf_counter()
    for _ in range(timed_reps):
        y = model(x, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed_reps
    res['bench_counts'] = {k: (e.launches, dict(e.by_shape)) for k, e in entries.items()}
    s = model.metadata.upscale
    if y.shape != (batch, tile * s, tile * s, 3) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f'bench forward: shape {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}')
    res['bench_ms_per_forward'] = dt * 1e3
    res['bench_mp_per_s'] = batch * (tile * s) ** 2 / 1e6 / dt
    del x, y

    h, w = img_hw
    img = np.random.default_rng(2).random((h, w, 3), dtype=np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = upscale_tiled(model, img, tile=tile, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    res['tiled_s'] = time.perf_counter() - t0
    if out.shape != (h * s, w * s, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f'tiled: shape {tuple(out.shape)}')
    res['tiled_shape'] = list(out.shape)
    del out

    from PIL import Image

    src = os.path.join(tmp, 'in.png')
    dst = os.path.join(tmp, 'out.png')
    Image.fromarray((np.random.default_rng(3).random((48, 64, 3)) * 255).astype(np.uint8)).save(src)
    rc = upscale.main([ckpt, src, dst, '--bf16', '--device', str(model.device)])
    size = Image.open(dst).size
    if rc != 0 or size != (64 * s, 48 * s):
        raise AssertionError(f'cli: rc {rc}, output size {size}')
    res['cli_out'] = list(size)
    res['launches'] = {k: e.launches for k, e in entries.items()}
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, 'resselt_tpu_torch')):
        print('chip_smoke: resselt_tpu_torch/ is not beside this script', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log('device', kind=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)

    from resselt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    took = _build.build()
    ptxas = [ln.strip() for name in took for ln in _build.build_log(name).splitlines()
             if 'registers' in ln or 'spill' in ln]
    log('build', seconds=round(time.perf_counter() - t0, 2), kernels=took, ptxas=json.dumps(ptxas))

    shapes = conv_shapes(BENCH['batch'], BENCH['tile'])
    rows = phase_kernels('cuda', shapes, reps=10)
    log('kernels', f32_tol=F32_TOL, bf16_rtol=BF16_RTOL, bf16_atol=BF16_ATOL, rows=json.dumps(rows))

    with tempfile.TemporaryDirectory() as tmp:
        model, sd, ckpt = phase_load('cuda', BENCH['num_filters'], BENCH['num_blocks'], BENCH['scale'], tmp)
        log('load', arch=model.arch_id, metadata=repr(model.metadata), files='safetensors,pth')

        res = phase_model(model, sd, 64)
        if res['launches_per_forward'] != 351:
            raise AssertionError(f"{res['launches_per_forward']} kernel launches per forward, expected 351")
        log('model', tol=MODEL_TOL, **res)

        reps = 5
        serve = phase_serve(model, ckpt, tmp, BENCH['batch'], BENCH['tile'], timed_reps=reps, img_hw=(720, 1280))
        counts = serve.pop('bench_counts')
        launches = serve.pop('launches')['act']
        if launches == 0:
            raise AssertionError('the main path launched no conv3x3 kernel')
        bench_launches = counts['act'][0] + counts['pack2'][0]
        if bench_launches != 351 * reps:
            raise AssertionError(f'{bench_launches} kernel launches in {reps} bench forwards, expected 351 each')
        checked = {(r['entry'], shape_key(s)) for r, s in zip(rows, shapes)}
        ran = {(k, key) for k, (_, by_shape) in counts.items() for key in by_shape}
        if ran - checked:
            raise AssertionError(f'the bench forwards ran shapes the kernels phase did not check: {sorted(ran - checked)}')
        for r, s in zip(rows, shapes):
            r['per_forward'] = counts[r['entry']][1].get(shape_key(s), 0) / reps
        conv_ms = sum(r['ms'] * r['per_forward'] for r in rows)
        log('serve', dtype='bfloat16', batch=BENCH['batch'], tile=BENCH['tile'], launches=launches,
            launches_per_bench_forward=bench_launches / reps, conv_ms_per_bench_forward=conv_ms, **serve)

    head = next(r for r in rows if r['name'] == 'rdb stage0 64->192')
    kernels = [{
        'name': 'fused_conv3x3_act',
        'route': 'cuda',
        'source': 'resselt_tpu_torch/csrc/conv3x3.cu',
        'replaces': 'resselt_tpu/ops/fused_conv.py:59',
        'launches': launches,
        'max_abs_err': max(r['max_abs_err_bf16'] for r in rows),
        'ms': head['ms'],
        'plain_ms': head['plain_ms'],
        'bound_ms': head['bound_ms'],
        'bound_by': head['bound_by'],
        'library_ms': head['library_ms'],
        'timed_shape': head['name'] + ' bf16 ' + 'x'.join(map(str, head['shape'])),
        'ms_per_bench_forward': conv_ms,
        'shapes': rows,
    }]
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
