#!/usr/bin/env python3
"""Time the port's hand-written kernels shape by shape on one NVIDIA GPU.

    python3 chip_smoke.py [--parent-conv3x3 PATH] [--parent-window-attn PATH]

It builds resselt_tpu_torch/csrc/*.cu (one nvcc per source, all started
together; ptxas's registers, shared memory and spills per kernel), then
runs one phase per kernel family, one line each: kernels (conv3x3 at
ESRGAN's shapes and the kernel's other shape classes), step_kernels
(ESRGAN's producer steps, each equal bit for bit to the chain of a conv
launch and PyTorch ops), lk_kernels (PLKSR's large-kernel conv, each bf16
launch on the path its row names), wattn_kernels (the window attention of
the eight window transformers and FlexNet), wcross_kernels (HAT's
overlapping cross-attention, against the plain path it replaced),
molrcm_kernels (EIMN's
MOLRCM), gather_kernels (ATD's row gather) and conv_family_kernels (every
3x3 conv of the conv families).  Each row holds the kernel against its
plain version in f32, bf16 and fp16 and gives kernel / plain / library /
bound ms a launch in bf16, at a batch of 16 tiles of 256^2 unless the row
says otherwise; a time is the mean over CUDA graph replays of ten calls,
replayed for at least 20 ms, so that a short kernel's row reads the device
and not the host's launch rate.  train_grads holds each kernel's autograd
Function against autograd through its plain version, f32, at the training
shapes, with the backward's ms at each kernel's main shape (timed eagerly).
With --parent-conv3x3 (an earlier copy of csrc/conv3x3.cu) the conv3x3
rows also hold that build's 16-bit outputs equal to the kernel's bit for
bit and time both in turns; each line lists the rows over 2% slower than
the parent.  --parent-window-attn does the same for an earlier
csrc/window_attn.cu at the window-attention rows (DRCT-L's served pair
launches among them, each row with its bound's share of its time).  Then
the card's name and power limit, one JSON line of each
kernel's figures a launch with, under ``served_launches``, the launches a
tile-batch forward by wrapper and route of BENCHMARK.json's four
configurations at their published widths, each loaded and served a 720p
frame through ``upscale_tiled`` at the loader's hints, and last
``{"ok": true, "device": {...}}``.

The card tests (tests/test_torch_kernels_cuda.py and
tests/test_torch_tiling_graph.py, marked ``cuda``) hold the port's
correctness on the card; h100_bench/run.py times the served path end to
end.  Any failure exits non-zero; without a CUDA device, or without the
package beside this script, it exits 1 before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the batch the kernel rows are timed at: bench.py's 16 tiles of 256^2
BENCH = {'tile': 256, 'batch': 16}
# PLKSR at the widths tools/bench_families.py gives the reference (DCCM
# mixer, PLK, EA), served at the same batch and tile
PLKSR = {'dim': 64, 'n_blocks': 28, 'scale': 4, 'kernel_size': 17, 'pdim': 16}
# SwinIR-M x4 classical (official SwinIR main_test_swinir.py define_model,
# classical_sr, patch 64: 001_classicalSR_DF2K_s64w8_SwinIR-M_x4); it
# serves tiled at the loader's bf16 hints: tile 160, halo 8, one tile a batch
SWINIR = {'embed_dim': 180, 'depths': (6,) * 6, 'num_heads': (6,) * 6, 'window_size': 8, 'scale': 4,
          'img_size': 64, 'tile': 160, 'halo': 8}
# EIMN_L: the reference's eimn() defaults (EIMN paper, Liu et al., ECAI
# 2023), tools/bench_families.py's 'eimn 4x'; no serving hints, so it
# serves tiled at the defaults (tile 256, halo 16, 8 tiles a batch)
EIMN = {'embed_dims': 64, 'num_stages': 16, 'depths': 1, 'mlp_ratio': 2.66, 'scale': 4, 'tile': 256, 'halo': 16}
# ATD-light x4 (ATD paper, Zhang et al., CVPR 2024; tools/bench_families.py's
# 'atd-light 4x'); tiled at the loader's bf16 hints, two windows a batch
ATD = {'name': 'ATD-light', 'embed_dim': 48, 'depths': (6,) * 5, 'num_heads': (4,) * 5, 'window_size': 16,
       'category_size': 128, 'num_tokens': 64, 'reducted_dim': 8, 'convffn_kernel_size': 7, 'mlp_ratio': 1.0,
       'scale': 4, 'tile': 160, 'halo': 8, 'tile_batch': 2}
# HAT-S x4 (HAT paper, Chen et al., CVPR 2023; tools/bench_families.py's
# 'hat-s 4x'); tiled at the loader's hints, two windows a batch
HAT = {'name': 'HAT-S', 'embed_dim': 144, 'depths': (6,) * 6, 'num_heads': (6,) * 6, 'window_size': 16,
       'overlap_ratio': 0.5, 'compress_ratio': 24, 'squeeze_factor': 24, 'mlp_ratio': 2.0, 'num_feat': 64,
       'scale': 4, 'tile': 192, 'halo': 16, 'tile_batch': 2}
# DAT-S x4 (DAT paper, Chen et al., ICCV 2023; tools/bench_families.py's
# 'dat-s 4x'); tiled at the loader's bf16 hints, eight windows a batch
DAT = {'name': 'DAT-S', 'embed_dim': 180, 'depth': (6,) * 6, 'num_heads': (6,) * 6, 'split_size': (8, 16),
       'expansion_factor': 2.0, 'scale': 4, 'tile': 96, 'halo': 8, 'tile_batch': 8}
# RGT-S x4 (RGT paper, Chen et al., ICLR 2024, the RGT-S option of its
# official code); tiled at the loader's bf16 hints, two windows a batch
RGT = {'name': 'RGT-S', 'embed_dim': 180, 'depth': (6,) * 6, 'num_heads': (6,) * 6, 'split_size': (8, 32),
       'mlp_ratio': 2.0, 'c_ratio': 0.5, 'scale': 4, 'tile': 160, 'halo': 8, 'tile_batch': 2}
# DRCT x4 (DRCT paper, Hsu et al., CVPRW 2024: six groups, where DRCT-L has
# twelve; tools/bench_families.py's row labelled 'drct-l 4x' is this model);
# tiled at the loader's bf16 hints, one window a batch
DRCT = {'name': 'DRCT', 'embed_dim': 180, 'num_layers': 6, 'num_heads': (6,) * 6, 'window_size': 16, 'gc': 32,
        'mlp_ratio': 2.0, 'scale': 4, 'img_size': 64, 'tile': 128, 'halo': 8, 'tile_batch': 1}

# FDAT-M x4: the reference FDAT class defaults (tools/bench_families.py's
# 'fdat-m 4x', built as FDAT()); tiled at the loader's hints, two windows a batch
FDAT = {'name': 'FDAT-M', 'embed_dim': 120, 'num_groups': 4, 'depth_per_group': 3, 'num_heads': 4, 'window_size': 8,
        'ffn_expansion_ratio': 2.0, 'aim_reduction_ratio': 8, 'mid_dim': 64, 'upsampler': 'transpose+conv',
        'scale': 4, 'tile': 128, 'halo': 8, 'tile_batch': 2}
# OmniSR x4 (OmniSR paper, Wang et al., CVPR 2023; tools/bench_families.py's
# 'omni 4x'); no serving hints, so it serves tiled at the defaults (tile 256,
# halo 16, 8 windows a batch)
OMNI = {'name': 'OmniSR', 'num_feat': 64, 'block_num': 1, 'res_num': 5, 'pe': True, 'window_size': 8, 'scale': 4,
        'tile': 256, 'halo': 16, 'tile_batch': 8}
# FlexNet 4x at the zoo's widths: its one-head, zero-bias windows of 64
FLEXNET = {'name': 'FlexNet', 'dim': 64, 'num_blocks': (6,) * 6, 'window_size': 8, 'hidden_rate': 4, 'scale': 4,
           'tile': 256, 'halo': 16, 'tile_batch': 8}
# H100 SXM dense peaks (NVIDIA data sheet) for bound_ms
PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12

F32_TOL = 1e-4     # rtol = atol: exact f32 FMA against cuDNN f32 with TF32 off
BF16_RTOL = 2e-2   # bf16 output rounding (2^-9 relative) with margin; fp16 is held to the same
BF16_ATOL = 1e-3
WATTN_BF16_ATOL = 1e-2  # window attention: P is rounded to bf16 (fp16) before P V
MOLRCM_TOL = 1.5e-3  # x max|plain|: tests/test_pallas_ops.py's tolerance for the JAX MOLRCM kernel


def log(phase: str, **fields) -> None:
    print(f'[{phase}] ' + ' '.join(f'{k}={v}' for k, v in fields.items()), flush=True)


def conv_shapes(n: int, tile: int) -> list[dict]:
    """Every distinct 3x3 conv (shape, activation) of ESRGAN RRDBNet nf64
    gc32 4x at a batch of ``n`` ``tile``-square inputs, plus the
    pixel-unshuffle checkpoints' heads and the pack2 entry."""
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
        # the kernel's other shape classes: every N tile of the wgmma path (8, 16, 32, 48, 64, 80, 96), Cout
        # split with a ragged last slice, Cout 3 / 7 / 8, Cin 3 / 12 / 48, H and W that are no multiples of
        # the 16-pixel tile, the four activations, a Cin too large for the wgmma path
        ('edge 64->8 silu', 'act', 2, 37, 29, 64, 8, 'silu'),
        ('edge 32->16 mish', 'act', 1, 40, 23, 32, 16, 'mish'),
        ('edge 16->24 lrelu', 'act', 1, 17, 50, 16, 24, 'lrelu'),
        ('edge 48->48 silu', 'act', 2, 31, 18, 48, 48, 'silu'),
        ('edge 32->128 mish', 'act', 1, 25, 33, 32, 128, 'mish'),
        ('edge 64->100 lrelu', 'act', 1, 21, 37, 64, 100, 'lrelu'),
        ('edge 32->7 linear', 'act', 1, 18, 20, 32, 7, 'linear'),
        ('edge 64->3 mish', 'act', 1, 33, 17, 64, 3, 'mish'),
        ('edge 3->64 silu', 'act', 1, 19, 21, 3, 64, 'silu'),
        ('edge 12->64 mish', 'act', 2, 9, 40, 12, 64, 'mish'),
        ('edge 256->320 linear', 'act', 1, 7, 3, 256, 320, 'linear'),
    ]
    keys = ('name', 'entry', 'n', 'h', 'w', 'cin', 'cout', 'act')
    return [dict(zip(keys, r)) for r in rows]


def conv_family_shapes(n: int, tile: int) -> list[dict]:
    """Every distinct 3x3 conv (shape, activation) of the bench forwards of
    the conv families (SPAN 4x, SPANPlus 2x, SpanPP 2x, Compact 4x, MoSR
    4x, RCAN 4x; GateR 1x, MoSRv2 4x, MoESR 4x, GateRv2 1x, GateRV3 1x;
    RTMoSR 2x, SMoSR 4x, RHA 4x, FlexNet 4x, GFISR 4x, GFISRV2 4x, FIGSR 4x,
    LAWFFT 4x) at a batch of ``n`` ``tile``-square inputs; several families
    share a row where their convs coincide (MoSRv2's are all MoSR's, RHA's
    and GFISR's are all earlier rows).  SMoSR runs at its 2-pixel reflect
    pad, FIGSR at its 4-pixel halo."""
    t = tile
    rows = [
        ('SPAN/SPANPlus/SpanPP stem 3->48', t, 3, 48, 'linear'),
        ('SPAN/SpanPP c1 c2 48->48 silu', t, 48, 48, 'silu'),
        ('SPANPlus c1 c2 48->48 mish', t, 48, 48, 'mish'),
        ('SPAN/SPANPlus/SpanPP c3 conv_2, SPAN head 48->48', t, 48, 48, 'linear'),
        ('SPANPlus/SpanPP 2x head 48->12', t, 48, 12, 'linear'),
        ('Compact/MoSR/RCAN/RHA/FlexNet/GFISR/GFISRV2/LAWFFT stem 3->64', t, 3, 64, 'linear'),
        ('Compact/RCAN body, RHA tail.0, GFISRV2 tail 64->64', t, 64, 64, 'linear'),
        ('Compact/MoSR/GFISR/GFISRV2/LAWFFT 4x head 64->48', t, 64, 48, 'linear'),
        ('MoSR/RHA/GFISR/GFISRV2 fc1 64->192', t, 64, 192, 'linear'),
        ('MoSR/RHA/GFISR fc2 96->64 mish', t, 96, 64, 'mish'),
        ('MoSR tail 64->128 mish', t, 64, 128, 'mish'),
        ('MoSR tail, FlexNet ConvBlock 128->64 mish', t, 128, 64, 'mish'),
        ('MoSR/FlexNet shortcut 3->64 mish', t, 3, 64, 'mish'),
        ('MoSR/FlexNet shortcut, FlexNet ConvBlock 64->64 mish', t, 64, 64, 'mish'),
        ('RCAN/RHA tail.0.0 64->256', t, 64, 256, 'linear'),
        ('RCAN/RHA tail.0.2 64->256', 2 * t, 64, 256, 'linear'),
        ('RCAN/RHA tail.1 64->3', 4 * t, 64, 3, 'linear'),
        ('GateR enc1.0 64->32', t, 64, 32, 'linear'),
        ('GateR enc2.0 128->64', t // 2, 128, 64, 'linear'),
        ('GateR latent.0 256->128', t // 4, 256, 128, 'linear'),
        ('GateR latent.2 512->1024', t // 8, 512, 1024, 'linear'),
        ('GateR dec0.2 256->512', t // 4, 256, 512, 'linear'),
        ('GateR dec1.2 128->256', t // 2, 128, 256, 'linear'),
        ('GateR dim_to_ch.0 128->64', t, 128, 64, 'linear'),
        ('GateR dim_to_ch.1 64->3', t, 64, 3, 'linear'),
        ('MoESR fc1 64->320', t, 64, 320, 'linear'),
        ('MoESR fc2 160->64 mish', t, 160, 64, 'mish'),
        ('MoESR MSG down.0 64->16', t, 64, 16, 'linear'),
        ('MoESR MSG fc1 64->320', t // 2, 64, 320, 'linear'),
        ('MoESR MSG fc2 160->64 mish', t // 2, 160, 64, 'mish'),
        ('MoESR MSG up.0, RTMoSR fc1 64->256', t // 2, 64, 256, 'linear'),
        ('GateRv2/GateRV3 stem 3->32', t, 3, 32, 'linear'),
        ('GateRV3 SPAB c1 c2 32->32 silu', t, 32, 32, 'silu'),
        ('GateRV3 SPAB c3, sisr_end_conv 32->32', t, 32, 32, 'linear'),
        ('GateRv2/GateRV3 encode.0 32->16', t, 32, 16, 'linear'),
        ('GateRv2/GateRV3 encode.1 64->32', t // 2, 64, 32, 'linear'),
        ('GateRv2/GateRV3 encode.2 128->64', t // 4, 128, 64, 'linear'),
        ('GateRv2/GateRV3 decode.0 256->512', t // 8, 256, 512, 'linear'),
        ('GateRv2/GateRV3 decode.1 128->256', t // 4, 128, 256, 'linear'),
        ('GateRv2/GateRV3 decode.2 64->128', t // 2, 64, 128, 'linear'),
        ('GateRv2/GateRV3 dim_to_in 32->3', t, 32, 3, 'linear'),
        ('RTMoSR unshuffle stem 12->64', t // 2, 12, 64, 'linear'),
        ('RTMoSR poll.1 64->256', t // 4, 64, 256, 'linear'),
        ('RTMoSR fc2 128->64 mish', t // 2, 128, 64, 'mish'),
        ('RTMoSR head 64->48', t // 2, 64, 48, 'linear'),
        ('SMoSR SMB body.0 3->64 silu', t + 4, 3, 64, 'silu'),
        ('SMoSR SMB body.0 / body.2 64->64 silu', t + 4, 64, 64, 'silu'),
        ('SMoSR end_block.1 64->64', t + 4, 64, 64, 'linear'),
        ('SMoSR head 112->48', t + 4, 112, 48, 'linear'),
        ('FlexNet head 128->48', t, 128, 48, 'linear'),
        ('GFISRV2 fc2 96->64 silu', t, 96, 64, 'silu'),
        ('GFISRV2 tail 64->64 silu', t, 64, 64, 'silu'),
        ('FIGSR stem 3->64', t + 8, 3, 64, 'linear'),
        ('FIGSR fc1 64->256', t + 8, 64, 256, 'linear'),
        ('FIGSR convhw 8->8', t + 8, 8, 8, 'linear'),
        ('FIGSR fc2 128->64', t + 8, 128, 64, 'linear'),
        ('FIGSR tail 64->64', t + 8, 64, 64, 'linear'),
        ('FIGSR head 64->48', t + 8, 64, 48, 'linear'),
    ]
    return [{'name': name, 'entry': 'act', 'n': n, 'h': h, 'w': h, 'cin': cin, 'cout': cout, 'act': act}
            for name, h, cin, cout, act in rows]

WINDOW_MS = 20.0  # the least time a timing's pair of CUDA events encloses
EAGER_TIMINGS = []  # the timings whose calls could not be captured into a CUDA graph


def _ms(fn, reps: int, graph: bool = True) -> float:
    """Mean device time of one call of ``fn``, from CUDA events, after one
    warm-up call.  ``reps`` calls are captured into one CUDA graph, and the
    graph is replayed until the events enclose at least WINDOW_MS: a kernel
    of tens of microseconds is timed, not the host's rate of issuing
    launches.  Where the calls cannot be captured (or ``graph`` is False),
    they run eagerly, as many as fill the window."""
    import torch

    fn()
    torch.cuda.synchronize()
    step, per = fn, 1
    if graph:
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn()
            step, per = g.replay, reps
        except RuntimeError:
            torch.cuda.synchronize()
            EAGER_TIMINGS.append(getattr(fn, '__qualname__', repr(fn)))

    def timed(k: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    step()
    k = max(1 if per > 1 else reps, math.ceil(WINDOW_MS / max(timed(1), 1e-3)))
    return timed(k) / (k * per)


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


def vs_parent(parent, call, reps: int, source: str = 'conv3x3') -> dict:
    """The bf16 launch ``call(lib)`` (a C entry of the library of
    ``csrc/<source>.cu``, ``tools/time_kernel_variants.py``'s launchers)
    timed on this build and on the ``parent`` copy's, in the order parent,
    change, change, parent: the means, and the change's time over the
    parent's."""
    from resselt_tpu_torch.ops import _build

    mine = _build.load(source)
    times = {'parent_ms': [], 'ms': []}
    for key, lib in (('parent_ms', parent), ('ms', mine), ('ms', mine), ('parent_ms', parent)):
        times[key].append(_ms(lambda: call(lib), reps))
    out = {k: sum(v) / len(v) for k, v in times.items()}
    out['ratio'] = out['ms'] / out['parent_ms']
    return out


def same_as_parent(parent, call, got) -> bool:
    """Whether the ``parent`` library's output of ``call`` is ``got`` (one
    tensor or a tuple) bit for bit."""
    import torch

    want = call(parent)
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def phase_kernels(device, shapes: list[dict], reps: int, parent=None) -> list[dict]:
    """Each shape: kernel against its plain version in f32 (TF32 off), in
    bf16 and in fp16 (plain version in f32 from the same 16-bit inputs),
    then kernel / plain / library / bound times in bf16.  With ``parent``
    (the library of an earlier conv3x3.cu): its bf16 and fp16 outputs
    against the kernel's, which must be equal bit for bit, and
    :func:`vs_parent`'s times in bf16 (``vs_parent``)."""
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
        xh = x.to(torch.float16)
        tapsh = fc.pack_conv3x3_weight(w, torch.float16)
        goth = entry(xh, tapsh, b, act=s['act'])
        wanth = ref(xh.float(), tapsh.float(), b, act=s['act'])
        errh = (goth.float() - wanth).abs().max().item()
        torch.testing.assert_close(goth.float(), wanth, rtol=BF16_RTOL, atol=BF16_ATOL)
        row = {'name': s['name'], 'entry': s['entry'], 'shape': [s['n'], s['h'], s['w'], s['cin'], s['cout']],
               'act': s['act'], 'max_abs_err_f32': err32, 'max_abs_err_bf16': errb, 'max_abs_err_f16': errh}
        if parent is not None:
            from tools.time_kernel_variants import conv3x3_launch

            for xd, tapsd, gotd in ((xb, tapsb, gotb), (xh, tapsh, goth)):
                if not same_as_parent(parent, lambda lib: conv3x3_launch(lib, xd, tapsd, b, s['act']), gotd):
                    raise AssertionError(f"{s['name']} {xd.dtype}: not the parent's bits")
            row['vs_parent'] = vs_parent(parent, lambda lib: conv3x3_launch(lib, xb, tapsb, b, s['act']), reps)
        del got, want, gotb, wantb, goth, wanth, xh

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

# ESRGAN's RDB producer steps at nf 64, gc 32: (name, cin, cout, addend, split, residuals); stage 4's second
# row is the last RDB of an RRDB, which also adds the RRDB's input
STEP_STAGES = (('stage0', 64, 192, False, 32, 0), ('stage1', 32, 160, True, 32, 0), ('stage2', 32, 128, True, 32, 0),
               ('stage3', 32, 96, True, 32, 0), ('stage4', 32, 64, True, None, 1), ('stage4 rrdb', 32, 64, True, None, 2))
SERVED_FRAME = (8, 264)  # the batch h100_bench's ESRGAN cells serve: 8 tiles of 264^2 a forward


def step_shapes(n: int, tile: int) -> list[dict]:
    """The six producer steps at a batch of ``n`` ``tile``-square inputs
    (the rows' batch), and at the benchmark's served shape."""
    out = []
    for bn, t in ((n, tile), SERVED_FRAME):
        for name, cin, cout, addend, split, n_res in STEP_STAGES:
            kind = ('carry_' if addend else '') + ('split' if split else f'residual{n_res}')
            out.append({'name': f'{name} {cin}->{cout}', 'n': bn, 'h': t, 'w': t, 'cin': cin, 'cout': cout,
                        'act': 'linear', 'addend': addend, 'split': split, 'residuals': n_res, 'kind': kind})
    return out


def step_bound_ms(s: dict) -> tuple[float, str]:
    """Least time for one 16-bit producer step on an H100: :func:`bound_ms`
    with the addend and residuals read besides."""
    px = s['n'] * s['h'] * s['w']
    nbytes = (px * (s['cin'] + s['cout'] * (1 + s['addend'] + s['residuals'])) * 2 + 9 * s['cin'] * s['cout'] * 2
              + 4 * s['cout'])
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = 2 * px * 9 * s['cin'] * s['cout'] / PEAK_FLOPS['bfloat16'] * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def phase_step_kernels(device, shapes: list[dict], reps: int, parent=None) -> list[dict]:
    """Each producer step in bf16 and fp16: ``fused_conv3x3_step`` equal bit
    for bit to the chain the parent ran (a ``fused_conv3x3_act`` launch,
    then the glue as PyTorch ops), one launch counted at the conv's key and
    one by its epilogue kind; then step / chain / plain conv / bound times
    in bf16.  With ``parent`` (the library of an earlier conv3x3.cu): its
    step's outputs equal to these bit for bit, in bf16 and fp16, and the
    step's time against the parent's (:func:`vs_parent`, ``vs_parent``)
    beside the bound."""
    import torch

    from resselt_tpu_torch.ops import fused_conv as fc

    e = fc.fused_conv3x3_act
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for s in shapes:
        n, h, w, cin, cout = s['n'], s['h'], s['w'], s['cin'], s['cout']
        x = torch.randn((n, h, w, cin), generator=gen, device=device)
        wt = torch.randn((cout, cin, 3, 3), generator=gen, device=device) / (3 * cin ** 0.5)
        b = torch.randn((cout,), generator=gen, device=device) * 0.1
        extra = [torch.randn((n, h, w, cout), generator=gen, device=device)
                 for _ in range(s['addend'] + s['residuals'])]
        row = {'name': s['name'], 'shape': [n, h, w, cin, cout], 'kind': s['kind']}
        for dt in (torch.bfloat16, torch.float16):
            xd, taps = x.to(dt), fc.pack_conv3x3_weight(wt, dt)
            addend = extra[0].to(dt) if s['addend'] else None
            residuals = tuple(r.to(dt) for r in extra[s['addend']:])
            key = (n, h, w, cin, cout, 'linear')
            before = e.launches, e.by_shape[key], e.by_epilogue[s['kind']]
            got = fc.fused_conv3x3_step(xd, taps, b, addend=addend, split=s['split'], residuals=residuals)
            torch.cuda.synchronize()
            if (e.launches, e.by_shape[key], e.by_epilogue[s['kind']]) != tuple(c + 1 for c in before):
                raise AssertionError(f"step {s['name']} {dt}: counted {before} -> "
                                     f"{(e.launches, e.by_shape[key], e.by_epilogue[s['kind']])}")
            want = fc._step_glue(fc.fused_conv3x3_act(xd, taps, b), addend, s['split'], residuals)
            got, want = (got, want) if s['split'] else ((got,), (want,))
            diff = max((g.float() - v.float()).abs().max().item() for g, v in zip(got, want))
            if not all(torch.equal(g, v) for g, v in zip(got, want)):
                raise AssertionError(f"step {s['name']} {tuple(xd.shape)} {dt}: not the chain's bits, "
                                     f'max |diff| {diff}')
            row['max_abs_diff_' + ('bf16' if dt == torch.bfloat16 else 'f16')] = diff
            if parent is not None:
                from tools.time_kernel_variants import conv3x3_step_launch

                step = (xd, taps, b, addend, s['split'], residuals)
                if not same_as_parent(parent, lambda lib: conv3x3_step_launch(lib, *step), got):
                    raise AssertionError(f"step {s['name']} {tuple(xd.shape)} {dt}: not the parent's bits")
            if dt == torch.bfloat16:
                args = (xd, taps, b, addend, s['split'], residuals)
        xd, taps, b_, addend, split, residuals = args
        row['ms'] = _ms(lambda: fc.fused_conv3x3_step(xd, taps, b_, addend=addend, split=split,
                                                      residuals=residuals), reps)
        row['chain_ms'] = _ms(lambda: fc._step_glue(fc.fused_conv3x3_act(xd, taps, b_), addend, split, residuals),
                              reps)
        row['conv_ms'] = _ms(lambda: fc.fused_conv3x3_act(xd, taps, b_), reps)
        row['bound_ms'], row['bound_by'] = step_bound_ms(s)
        if parent is not None:
            from tools.time_kernel_variants import conv3x3_step_launch

            row['vs_parent'] = vs_parent(parent, lambda lib: conv3x3_step_launch(lib, *args), reps)
            row['vs_parent']['share_of_bound'] = row['bound_ms'] / row['vs_parent']['ms']
            row['vs_parent']['parent_share_of_bound'] = row['bound_ms'] / row['vs_parent']['parent_ms']
        del x, extra, args, xd, taps, addend, residuals, got, want
        torch.cuda.empty_cache()
        out.append(row)
    return out

def lk_shapes(n: int, tile: int, pdim: int, k: int) -> list[dict]:
    """Every large-kernel conv shape of the PLKSR path (the bench forwards,
    the tiled 720p windows, a 48x64 and a 64x64 whole image),
    plus the kernel's other shape classes: Cin 8 / 16 / 32 / 64, Cout 8 /
    16 / 32 / 64, k 3 / 13 / 17 / 31, ragged sizes, both activations, one
    row without bias; and past the old limit of 31, k 33 and 51 at the
    bench image and at edges.  ``pitch`` and ``offset`` are the input's
    pixel pitch and first channel: the path hands the kernel a channel
    slice of the 64-wide features.  ``path`` is the 16-bit path
    csrc/conv_lk.cu's plan gives the shape (stacked, tiles, mma)."""
    window = tile + 2 * 4  # the loader's serving halo
    rows = [
        ('bench 16->16', n, tile, tile, pdim, pdim, k, 'linear', 4 * pdim, 0, True, 'stacked'),
        ('tiled window 16->16', 8, window, window, pdim, pdim, k, 'linear', 4 * pdim, 0, True, 'stacked'),
        ('cli 16->16 narrow', 1, 48, 64, pdim, pdim, k, 'linear', 4 * pdim, 0, True, 'stacked'),
        ('model 16->16 narrow', 1, 64, 64, pdim, pdim, k, 'linear', 4 * pdim, 0, True, 'stacked'),
        ('k13 16->16', n, tile, tile, 16, 16, 13, 'linear', 16, 0, True, 'stacked'),
        ('k17 32->32', n, tile, tile, 32, 32, 17, 'linear', 32, 0, True, 'mma'),
        ('k17 64->64', n, tile, tile, 64, 64, 17, 'linear', 64, 0, True, 'tiles'),
        ('k17 16->8 lrelu', n, tile, tile, 16, 8, 17, 'lrelu', 16, 0, True, 'stacked'),
        ('unaligned 1x19x200', 1, 19, 200, 16, 16, 17, 'linear', 16, 0, True, 'stacked'),
        # the edges of the three paths: ragged H and W (1, 15, 17, 257), Cout below a tile's
        # width, a slice at a channel offset (16-byte aligned: the wgmma paths; not: mma)
        ('edge k3 8->8 lrelu', 3, 15, 17, 8, 8, 3, 'lrelu', 8, 0, True, 'mma'),
        ('edge k17 16->16 slice at 16', 1, 17, 257, 16, 16, 17, 'lrelu', 64, 16, True, 'stacked'),
        ('edge k17 16->16 slice at 3', 2, 33, 17, 16, 16, 17, 'linear', 24, 3, True, 'mma'),
        ('edge k13 16->5 no bias', 1, 1, 300, 16, 5, 13, 'linear', 16, 0, False, 'stacked'),
        ('edge k31 16->16', 1, 40, 70, 16, 16, 31, 'lrelu', 16, 0, True, 'tiles'),
        ('edge k13 32->24 lrelu', 2, 37, 45, 32, 24, 13, 'lrelu', 48, 16, True, 'mma'),
        ('edge k3 64->64', 1, 300, 15, 64, 64, 3, 'linear', 64, 0, True, 'tiles'),
        ('edge k31 64->40', 1, 21, 23, 64, 40, 31, 'linear', 64, 0, True, 'mma'),
        # past k 31: k 33 still fits the tiles path at Cout 16; k 51 runs mma in square blocks of taps
        ('k33 16->16', n, tile, tile, 16, 16, 33, 'linear', 16, 0, True, 'tiles'),
        ('k51 16->16 lrelu', n, tile, tile, 16, 16, 51, 'lrelu', 16, 0, True, 'mma'),
        ('edge k33 8->4 no bias', 2, 21, 23, 8, 4, 33, 'linear', 8, 0, False, 'mma'),
        ('edge k51 64->64', 1, 19, 37, 64, 64, 51, 'linear', 64, 0, True, 'mma'),
    ]
    keys = ('name', 'n', 'h', 'w', 'cin', 'cout', 'k', 'act', 'pitch', 'offset', 'bias', 'path')
    return [dict(zip(keys, r)) for r in rows]


def lk_shape_key(s: dict) -> tuple:
    """The key under which ``fused_conv_lk.by_shape`` counts ``s``."""
    return (s['n'], s['h'], s['w'], s['cin'], s['cout'], s['k'], s['act'])


def lk_bound_ms(s: dict, dtype_name: str) -> tuple[float, str]:
    """Least time for one k x k conv on an H100: the larger of its bytes (x's
    cin channels read once, weights and bias read once, y written once) over
    the memory rate and its FLOPs over the dense peak for the dtype."""
    size = 2 if dtype_name == 'bfloat16' else 4
    px = s['n'] * s['h'] * s['w']
    taps = s['k'] * s['k']
    nbytes = px * (s['cin'] + s['cout']) * size + taps * s['cin'] * s['cout'] * size + 4 * s['cout']
    flops = 2 * px * taps * s['cin'] * s['cout']
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def phase_lk_kernels(device, shapes: list[dict], reps: int) -> list[dict]:
    """Each shape: the lk kernel against its plain version in f32 (TF32 off),
    in bf16 and in fp16 (plain version in f32 from the same 16-bit inputs),
    the bf16 launch counted on the shape's ``path``; then
    kernel / plain / library / bound times in bf16; f32 times too at the
    bench shape."""
    import torch
    import torch.nn.functional as TF

    from resselt_tpu_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for s in shapes:
        k, act, cin, off = s['k'], s['act'], s['cin'], s['offset']
        wide = torch.randn((s['n'], s['h'], s['w'], s['pitch']), generator=gen, device=device)
        x = wide[..., off:off + cin]
        w = torch.randn((s['cout'], s['cin'], k, k), generator=gen, device=device) / (k * s['cin'] ** 0.5)
        b = torch.randn((s['cout'],), generator=gen, device=device) if s['bias'] else None

        taps32 = fc.pack_conv_lk_weight(w, torch.float32)
        got = fc.fused_conv_lk(x, taps32, b, k=k, act=act)
        want = fc.fused_conv_lk_ref(x, taps32, b, k=k, act=act)
        err32 = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)

        xb = wide.to(torch.bfloat16)[..., off:off + cin]
        tapsb = fc.pack_conv_lk_weight(w, torch.bfloat16)
        path = s['path']
        before = fc.fused_conv_lk.by_path[(lk_shape_key(s), path)]
        gotb = fc.fused_conv_lk(xb, tapsb, b, k=k, act=act)
        if fc.fused_conv_lk.by_path[(lk_shape_key(s), path)] != before + 1:
            raise AssertionError(f"{s['name']}: the bf16 launch did not take the {path} path")
        wantb = fc.fused_conv_lk_ref(xb.float(), tapsb.float(), b, k=k, act=act)
        errb = (gotb.float() - wantb).abs().max().item()
        torch.testing.assert_close(gotb.float(), wantb, rtol=BF16_RTOL, atol=BF16_ATOL)
        xh = wide.to(torch.float16)[..., off:off + cin]
        tapsh = fc.pack_conv_lk_weight(w, torch.float16)
        goth = fc.fused_conv_lk(xh, tapsh, b, k=k, act=act)
        wanth = fc.fused_conv_lk_ref(xh.float(), tapsh.float(), b, k=k, act=act)
        errh = (goth.float() - wanth).abs().max().item()
        torch.testing.assert_close(goth.float(), wanth, rtol=BF16_RTOL, atol=BF16_ATOL)
        del got, want, gotb, wantb, goth, wanth, xh

        row = {'name': s['name'], 'shape': [s['n'], s['h'], s['w'], s['cin'], s['cout']], 'k': k, 'act': act,
               'pitch': s['pitch'], 'offset': off, 'path': path, 'max_abs_err_f32': err32, 'max_abs_err_bf16': errb,
               'max_abs_err_f16': errh}
        wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x_cl = xb.contiguous().permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW view
        bb = None if b is None else b.to(torch.bfloat16)
        row['ms'] = _ms(lambda: fc.fused_conv_lk(xb, tapsb, b, k=k, act=act), reps)
        row['plain_ms'] = _ms(lambda: fc.fused_conv_lk_ref(xb, tapsb, b, k=k, act=act), reps)
        row['library_ms'] = _ms(lambda: TF.conv2d(x_cl, wb, bb, padding=k // 2), reps)
        row['bound_ms'], row['bound_by'] = lk_bound_ms(s, 'bfloat16')
        if s['name'] == 'bench 16->16':
            row['ms_f32'] = _ms(lambda: fc.fused_conv_lk(x, taps32, b, k=k, act=act), reps)
            row['bound_ms_f32'] = lk_bound_ms(s, 'float32')[0]
        del wide, x, xb, x_cl, wb
        torch.cuda.empty_cache()
        out.append(row)
    return out

def window_classes(cfg: dict) -> tuple[int, list[tuple]]:
    """A model's window attentions: the multiple its images are padded to,
    and per class of attention (label, (sp_h, sp_w) window, C, heads,
    masks: 'both' where its shifted blocks are masked and the others not,
    'masked' or 'unmasked' where all of its blocks are one or the other,
    'unmasked_and_shift' for unmasked blocks also checked at the bench
    image with the model's shift mask).
    DAT and RGT: two branches, (sp0, sp1) and (sp1, sp0) windows on half the
    channels with half the heads, padded to max(split).  DRCT: its five
    blocks, swin1 (embed, heads), swin2 and swin4 (embed + gc and + 3 gc,
    heads - width % heads; shifted), swin3 and swin5 (+ 2 gc and + 4 gc:
    at DRCT's width 2 heads of 122 and 4 of 77, unshifted, and their rows
    also with the model's own shift mask: 'unmasked_and_shift').  FDAT: the
    spatial blocks, unshifted.  OmniSR: the block and the grid attention,
    one shape (the grid's windows are strided, not smaller), unmasked.
    FlexNet: one head over the full width, unmasked, with a zero bias."""
    if 'split_size' in cfg:
        sp0, sp1 = cfg['split_size']
        c, h = cfg['embed_dim'] // 2, cfg['num_heads'][0] // 2
        return max(sp0, sp1), [(f' ({sp0}, {sp1})', (sp0, sp1), c, h, 'both'),
                               (f' ({sp1}, {sp0})', (sp1, sp0), c, h, 'both')]
    ws = cfg['window_size']
    if 'hidden_rate' in cfg:  # FlexNet
        return ws, [('', (ws, ws), cfg['dim'], 1, 'unmasked')]
    if 'res_num' in cfg:  # OmniSR
        f = cfg['num_feat']
        return ws, [(' block and grid', (ws, ws), f, f // (f // 4), 'unmasked')]
    if 'aim_reduction_ratio' in cfg:  # FDAT
        return ws, [('', (ws, ws), cfg['embed_dim'], cfg['num_heads'], 'unmasked')]
    c, h = cfg['embed_dim'], cfg['num_heads'][0]
    if 'gc' in cfg:
        out = [(' swin1', (ws, ws), c, h, 'unmasked')]
        for k in (2, 3, 4, 5):
            width = c + (k - 1) * cfg['gc']
            masks = 'masked' if k in (2, 4) else 'unmasked_and_shift'
            out.append((f' swin{k}', (ws, ws), width, h - width % h, masks))
        return ws, out
    return ws, [('', (ws, ws), c, h, 'both')]


def wattn_shapes(n_img: int, tile: int, cfg: dict, others: tuple[dict, ...]) -> list[dict]:
    """Every window-attention shape of the SwinIR-M path (the bench
    forwards, the tiled 720p windows at the loader's hints, the CLI's
    48x64 and a 64x64 image; each with the shift mask and
    without), the kernel's other shape classes (head_dim 53 and 46 among
    them, q, k and v slices of one qkv tensor; the wrapper pads heads of
    53, whose rows are only 2-byte aligned; and for the "any" kernels a
    FlexNet-style one head of 128 at the bench image and windows of 320
    tokens), and the same four images' shapes for each class of window
    attention (:func:`window_classes`) of each of ``others`` (their tiled windows come ``tile_batch`` a batch).  ``windows`` counts the window
    batch, ``nw`` the mask's windows (None: unmasked), ``split`` the window,
    ``image`` the padded image the windows tile; ``mask`` is the kind:
    'random' (30% of the entries -100, so no window's tile is all zero: the
    correctness rows), 'shift' (the model's own shift mask of the bench
    image, ``rect_attn_mask``: the bench forwards' masked launches are timed
    by these rows), 'zero' (every tile all zero).  ``zero_bias``: FlexNet's
    rows, whose attention adds a zero bias (the others a random one)."""
    ws, c, h = cfg['window_size'], cfg['embed_dim'], cfg['num_heads'][0]
    n = ws * ws
    nw_bench = (tile // ws) ** 2
    nw_tiled = ((cfg['tile'] + 2 * cfg['halo']) // ws) ** 2
    nw_cli = (48 // ws) * (64 // ws)
    nw_model = (64 // ws) ** 2
    sq, bench = (ws, ws), (tile, tile)
    rows = [
        ('bench masked', n_img * nw_bench, n, c, h, nw_bench, 'random', sq, bench),
        ('bench shift mask', n_img * nw_bench, n, c, h, nw_bench, 'shift', sq, bench),
        ('bench zero mask', n_img * nw_bench, n, c, h, nw_bench, 'zero', sq, bench),
        ('bench', n_img * nw_bench, n, c, h, None, None, sq, bench),
        ('tiled window masked', nw_tiled, n, c, h, nw_tiled, 'random', sq, None),
        ('tiled window', nw_tiled, n, c, h, None, None, sq, None),
        ('cli masked', nw_cli, n, c, h, nw_cli, 'random', sq, None),
        ('cli', nw_cli, n, c, h, None, None, sq, None),
        ('model masked', nw_model, n, c, h, nw_model, 'random', sq, None),
        ('model', nw_model, n, c, h, None, None, sq, None),
        ('window 7 n49', n_img * 1024, 49, 180, 6, 1024, 'random', (7, 7), None),
        ('SwinIR-light C60', n_img * nw_bench, 64, 60, 6, nw_bench, 'random', sq, None),
        ('edge head_dim 53 in place', 7, 256, 212, 4, 7, 'random', (16, 16), None),
        ('edge head_dim 53 n 100', 6, 100, 106, 2, None, None, (10, 10), None),
        ('edge head_dim 46 in place', 5, 200, 276, 6, 5, 'random', (10, 20), None),
        # the "any" kernels: FlexNet's meta level of 128 at the bench image (one head, zero bias, n 64), and
        # windows of more than 256 tokens: (16, 20) windows, 320 tokens, at SwinIR-M's width
        ('FlexNet-style one head of 128', n_img * (tile // 16) ** 2, 64, 128, 1, None, None, sq, None),
        ('window (16, 20) n320 masked', n_img * 64, 320, c, h, 64, 'random', (16, 20), None),
        ('edge n320 head_dim 160 unmasked', 6, 320, 160, 1, None, None, (16, 20), None),
    ]
    # DRCT-L's pair launches as drct_l_x4.frames720 serves them: one 144^2 window (tile 128, halo 8) of 81
    # windows of 256 tokens, swin1 / swin2 / swin4 at C 180 / 212 / 276, with the model's shift mask and without
    for label, dc, dh in (('swin1', 180, 6), ('swin2', 212, 4), ('swin4', 276, 6)):
        rows += [(f'DRCT-L served {label} shift mask', 81, 256, dc, dh, 81, 'shift', (16, 16), (144, 144)),
                 (f'DRCT-L served {label}', 81, 256, dc, dh, None, None, (16, 16), None)]
    for o in others:
        pad, classes = window_classes(o)
        window = o['tile'] + 2 * o['halo']
        for label, (sh, sw), oc, oh, masks in classes:
            nm = o['name'] + label
            for name, imgs, ih, iw in (('bench', n_img, tile, tile), ('tiled window', o['tile_batch'], window, window),
                                       ('cli', 1, 48, 64), ('model', 1, 64, 64)):
                hp, wp = -(-ih // pad) * pad, -(-iw // pad) * pad
                onw, on = (hp // sh) * (wp // sw), sh * sw
                if masks == 'unmasked_and_shift' and name == 'bench':
                    rows.append((f'{nm} bench shift mask', imgs * onw, on, oc, oh, onw, 'shift', (sh, sw), (hp, wp)))
                if masks in ('both', 'masked'):
                    rows.append((f'{nm} {name} masked', imgs * onw, on, oc, oh, onw, 'random', (sh, sw), None))
                    if name == 'bench':
                        for kind in ('shift', 'zero'):
                            rows.append((f'{nm} bench {kind} mask', imgs * onw, on, oc, oh, onw, kind, (sh, sw),
                                         (hp, wp)))
                if masks != 'masked':
                    rows.append((f'{nm} {name}', imgs * onw, on, oc, oh, None, None, (sh, sw), None))
    keys = ('name', 'windows', 'n', 'c', 'heads', 'nw', 'mask', 'split', 'image')
    return [dict(zip(keys, r), zero_bias=r[0].startswith('FlexNet')) for r in rows]

def wattn_bound_ms(s: dict, dtype_name: str) -> tuple[float, str]:
    """Least time for one window attention on an H100: the larger of its
    bytes (q, k, v read once, the f32 bias and the mask's non-zero tiles
    read once, O written once) over the memory rate and its FLOPs (Q K^T and P V) over the dense
    peak for the dtype."""
    size = 2 if dtype_name == 'bfloat16' else 4
    n, c, w = s['n'], s['c'], s['windows']
    nbytes = 4 * w * n * c * size + 4 * s['heads'] * n * n + 4 * s.get('nonzero_mask_windows', s['nw'] or 0) * n * n
    flops = 4 * w * n * n * c
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')

def _device_kernels(fn) -> str:
    """The device kernels one call of ``fn`` runs, by time, from
    torch.profiler: names PyTorch's choice of backend."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return '; '.join(k[:60] for k, _ in sorted(by_name.items(), key=lambda kv: -kv[1])[:2])


def phase_wattn_kernels(device, shapes: list[dict], reps: int, parent=None) -> list[dict]:
    """Each shape: the window-attention kernel against its plain version in
    f32 (TF32 off), in bf16 and in fp16 (plain version in f32 from the same
    16-bit inputs), with q, k, v handed over as slices of one qkv tensor as
    the model does and a random f32 bias; then kernel / plain / library / bound times in bf16 (f32
    times too at the bench shape), and the bound's share of the kernel's
    time (``bound_pct``).  The library call is
    ``scaled_dot_product_attention`` with bias + mask summed into one bf16
    additive mask (materialised per window where masked).  With ``parent``
    (an earlier window_attn.cu's library), each row times its bf16 launch and
    this build's in turns (``vs_parent``), both through the C entry on the
    heads as the wrapper hands them over, and says whether the two outputs
    are equal bit for bit (``equal_to_parent``)."""
    import torch
    import torch.nn.functional as TF

    from resselt_tpu_torch.nn.window import rect_attn_mask
    from resselt_tpu_torch.ops import window_attention as wa

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for s in shapes:
        w, n, c, h, nw = s['windows'], s['n'], s['c'], s['heads'], s['nw']
        hd = c // h
        scale = hd ** -0.5
        qkv = torch.randn((w, n, 3 * c), generator=gen, device=device)
        bias = torch.randn((h, n, n), generator=gen, device=device) * 0.5
        if s['zero_bias']:
            bias.zero_()
        mask = None
        if s['mask'] == 'random':
            mask = torch.where(torch.rand((nw, n, n), generator=gen, device=device) < 0.3, -100.0, 0.0)
        elif s['mask'] == 'shift':
            (hp, wp), (sh, sw) = s['image'], s['split']
            mask = torch.from_numpy(rect_attn_mask(hp, wp, sh, sw, sh // 2, sw // 2)).to(device)
            if mask.shape != (nw, n, n):
                raise AssertionError(f"shift mask {tuple(mask.shape)} at {s['name']}")
        elif s['mask'] == 'zero':
            mask = torch.zeros((nw, n, n), device=device)
        nonzero_windows = None if mask is None else int(wa.mask_window_flags(mask).sum())

        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        got = wa.window_mha(q, k, v, bias, mask, num_heads=h, scale=scale)
        want = wa.window_mha_ref(q, k, v, bias, mask, num_heads=h, scale=scale)
        err32 = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        del got, want

        qkvb = qkv.to(torch.bfloat16)
        del qkv
        qb, kb, vb = qkvb[..., :c], qkvb[..., c:2 * c], qkvb[..., 2 * c:]
        gotb = wa.window_mha(qb, kb, vb, bias, mask, num_heads=h, scale=scale)
        wantb = wa.window_mha_ref(qb.float(), kb.float(), vb.float(), bias, mask, num_heads=h, scale=scale)
        errb = (gotb.float() - wantb).abs().max().item()
        torch.testing.assert_close(gotb.float(), wantb, rtol=BF16_RTOL, atol=WATTN_BF16_ATOL)
        qkvh = qkvb.to(torch.float16)  # the bf16 values, exact in fp16 unless tiny
        qh, kh, vh = qkvh[..., :c], qkvh[..., c:2 * c], qkvh[..., 2 * c:]
        goth = wa.window_mha(qh, kh, vh, bias, mask, num_heads=h, scale=scale)
        wanth = wa.window_mha_ref(qh.float(), kh.float(), vh.float(), bias, mask, num_heads=h, scale=scale)
        errh = (goth.float() - wanth).abs().max().item()
        torch.testing.assert_close(goth.float(), wanth, rtol=BF16_RTOL, atol=WATTN_BF16_ATOL)
        del gotb, wantb, goth, wanth, qkvh, qh, kh, vh

        row = {'name': s['name'], 'windows': w, 'n': n, 'c': c, 'heads': h, 'mask_windows': nw,
               'mask': s['mask'], 'zero_bias': s['zero_bias'], 'nonzero_mask_windows': nonzero_windows,
               'max_abs_err_f32': err32, 'max_abs_err_bf16': errb, 'max_abs_err_f16': errh}
        row['ms'] = _ms(lambda: wa.window_mha(qb, kb, vb, bias, mask, num_heads=h, scale=scale), reps)
        row['plain_ms'] = _ms(lambda: wa.window_mha_ref(qb, kb, vb, bias, mask, num_heads=h, scale=scale), reps)
        q4, k4, v4 = (t.unflatten(-1, (h, hd)).transpose(1, 2) for t in (qb, kb, vb))
        if mask is None:
            am = bias.to(torch.bfloat16)[None]
        else:
            am = (bias[None, None] + mask[:, None][None]).to(torch.bfloat16)
            am = am.expand(w // nw, nw, h, n, n).reshape(w, h, n, n)

        def library():
            return TF.scaled_dot_product_attention(q4, k4, v4, attn_mask=am, scale=scale)

        row['library_ms'] = _ms(library, reps)
        row['library_kernels'] = _device_kernels(library)
        counted = {**s, 'nonzero_mask_windows': nonzero_windows or 0}  # what this run's mask needs read
        row['bound_ms'], row['bound_by'] = wattn_bound_ms(counted, 'bfloat16')
        row['bound_pct'] = 100.0 * row['bound_ms'] / row['ms']
        if parent is not None:
            from resselt_tpu_torch.ops import _build
            from tools.time_kernel_variants import window_attn_launch

            ql, kl, vl = wa.padded_heads(qb, kb, vb, h)

            def call(lib):
                return window_attn_launch(lib, ql, kl, vl, bias, mask, h, scale)

            row['equal_to_parent'] = same_as_parent(parent, call, call(_build.load('window_attn')))
            row['vs_parent'] = vs_parent(parent, call, reps, 'window_attn')
            del ql, kl, vl
        if s['name'] == 'bench masked':
            q32, k32, v32 = (t.float() for t in (qb, kb, vb))
            row['ms_f32'] = _ms(lambda: wa.window_mha(q32, k32, v32, bias, mask, num_heads=h, scale=scale), reps)
            row['bound_ms_f32'] = wattn_bound_ms(counted, 'float32')[0]
            del q32, k32, v32
        del qkvb, qb, kb, vb, q4, k4, v4, am, bias, mask
        torch.cuda.empty_cache()
        out.append(row)
    return out

# HAT's OCAB as the loader's hints serve it: two 224^2 windows a batch (tile 192, halo 16), 14 x 14 windows of 16^2
# queries each against the 24^2 keys of the overlapping window around it
HAT_L = {'name': 'HAT-L', 'embed_dim': 180, 'num_heads': 6}
WCROSS_SHAPES = [
    ('HAT-L served', 2 * 14 * 14, 256, 576, HAT_L['embed_dim'], HAT_L['num_heads']),
    ('HAT-S served', 2 * 14 * 14, 256, 576, HAT['embed_dim'], HAT['num_heads'][0]),
    ('HAT-L model', 16, 256, 576, HAT_L['embed_dim'], HAT_L['num_heads']),
]


def wcross_bound_ms(windows: int, n: int, m: int, c: int, heads: int) -> tuple[float, str]:
    """Least time for one cross attention in bf16 on an H100: the larger of
    its bytes (q and O over n rows, k and v over m rows, the f32 bias) over
    the memory rate and its FLOPs (Q K^T and P V) over the dense peak."""
    t_bytes = (2 * windows * (2 * n * c + 2 * m * c) + 4 * heads * n * m) / PEAK_BYTES * 1e3
    t_ops = 4 * windows * n * m * c / PEAK_FLOPS['bfloat16'] * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def phase_wcross_kernels(device, reps: int) -> list[dict]:
    """Each shape of :data:`WCROSS_SHAPES`: the cross-attention kernel
    against its plain version in bf16 and fp16 (in f32 from the same 16-bit
    inputs), q read in place from a window-partitioned (B, N, C) projection
    and k, v as the channel halves of a (B, M, 2C) tensor of overlapping
    windows, as HAT hands them over; then kernel / plain / library / bound
    ms in bf16 and ``bound_pct``.  Plain is the path OCAB took before the
    kernel (``nn.window._mha_plain``: scores, bias and softmax in bf16
    tensors); the library call is ``scaled_dot_product_attention`` with the
    bias as a bf16 additive mask."""
    import torch
    import torch.nn.functional as TF

    from resselt_tpu_torch.nn.window import _mha_plain
    from resselt_tpu_torch.ops import window_cross_attention as wca

    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for name, w, n, m, c, h in WCROSS_SHAPES:
        hd = c // h
        scale = hd ** -0.5
        qf = torch.randn((w, n, c), generator=gen, device=device)
        kvf = torch.randn((w, m, 2 * c), generator=gen, device=device)
        bias = torch.randn((h, n, m), generator=gen, device=device) * 0.5
        errs = {}
        for dtype in (torch.bfloat16, torch.float16):
            q, kv = qf.to(dtype), kvf.to(torch.bfloat16).to(dtype)
            got = wca.window_cross_mha(q, kv[..., :c], kv[..., c:], bias, num_heads=h, scale=scale)
            want = wca.window_cross_mha_ref(q.float(), kv[..., :c].float(), kv[..., c:].float(), bias, num_heads=h,
                                            scale=scale)
            errs[dtype] = (got.float() - want).abs().max().item()
            torch.testing.assert_close(got.float(), want, rtol=BF16_RTOL, atol=WATTN_BF16_ATOL)
            del got, want
        q, kv = qf.to(torch.bfloat16), kvf.to(torch.bfloat16)
        del qf, kvf
        k, v = kv[..., :c], kv[..., c:]
        row = {'name': name, 'windows': w, 'n': n, 'm': m, 'c': c, 'heads': h,
               'max_abs_err_bf16': errs[torch.bfloat16], 'max_abs_err_f16': errs[torch.float16]}
        row['ms'] = _ms(lambda: wca.window_cross_mha(q, k, v, bias, num_heads=h, scale=scale), reps)
        row['plain_ms'] = _ms(lambda: _mha_plain(q, k, v, h, scale, bias, None), reps)
        q4, k4, v4 = (t.unflatten(-1, (h, hd)).transpose(1, 2) for t in (q, k, v))
        am = bias.to(torch.bfloat16)[None]

        def library():
            return TF.scaled_dot_product_attention(q4, k4, v4, attn_mask=am, scale=scale)

        row['library_ms'] = _ms(library, reps)
        row['library_kernels'] = _device_kernels(library)
        row['bound_ms'], row['bound_by'] = wcross_bound_ms(w, n, m, c, h)
        row['bound_pct'] = 100.0 * row['bound_ms'] / row['ms']
        del q, kv, k, v, q4, k4, v4, am, bias
        torch.cuda.empty_cache()
        out.append(row)
    return out


def molrcm_shapes(n_img: int, tile: int, cfg: dict) -> list[dict]:
    """Every MOLRCM shape of the EIMN path (the bench forwards, the tiled
    720p windows at the default tile and halo, a 48x64 and a 64x64
    image), and the edges of the 16-bit kernel's
    16-column strips and runs of rows: h and w of 1, 15, 16, 17 and 300, n
    of 1 and 3, one shape without biases."""
    window = cfg['tile'] + 2 * cfg['halo']
    rows = [
        ('bench', n_img, tile, tile, True),
        ('tiled window', 8, window, window, True),
        ('cli', 1, 48, 64, True),
        ('model', 1, 64, 64, True),
        ('edge', 2, 37, 45, True),
        ('edge 1x1', 1, 1, 1, True),
        ('edge 15x17', 3, 15, 17, True),
        ('edge 16x16', 1, 16, 16, True),
        ('edge 17x15', 3, 17, 15, True),
        ('edge 300x16', 1, 300, 16, True),
        ('edge 16x300 no bias', 3, 16, 300, False),
    ]
    return [dict(zip(('name', 'n', 'h', 'w', 'bias'), r), dim=cfg['embed_dims']) for r in rows]

def molrcm_bound_ms(s: dict, dtype_name: str, weight_bytes: int) -> tuple[float, str]:
    """Least time for one MOLRCM on an H100: the larger of its bytes (x read
    once, the packed f32 weights read once, out written once) over the
    memory rate and its FLOPs (20,152 MAC a pixel at dim 64: four 64 x 64
    products, the 5x5 region conv on 64 channels, the dilated 5x5 on 24 and
    7x7 on 32) over the dense peak for the dtype."""
    size = 2 if dtype_name == 'bfloat16' else 4
    dim = s['dim']
    c1, c2 = dim * 3 // 8, dim // 8
    px = s['n'] * s['h'] * s['w']
    mac = 4 * dim * dim + 25 * dim + 25 * c1 + 49 * (dim - c1 - c2)
    t_bytes = (2 * px * dim * size + weight_bytes) / PEAK_BYTES * 1e3
    t_ops = 2 * px * mac / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def phase_molrcm_kernels(device, shapes: list[dict], reps: int) -> list[dict]:
    """Each shape: the MOLRCM kernel against its plain version in f32 (TF32
    off; within MOLRCM_TOL x max|plain|), in bf16 and in fp16 (plain version
    in f32 from the same 16-bit inputs and rounded weights), then kernel / plain
    / eager-chain / bound times in bf16 (f32 times too at the bench shape).
    No single PyTorch call computes MOLRCM: the yardstick is the eager bf16
    chain the port runs outside the kernel's gate (seven cuDNN convs, three
    of them depthwise and two dilated, gelu, cat, silu, mul)."""
    import torch

    from resselt_tpu_torch.archs import eimn
    from resselt_tpu_torch.nn.params import PTree
    from resselt_tpu_torch.ops import molrcm as mo

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for s in shapes:
        dim = s['dim']
        c1, c2 = dim * 3 // 8, dim // 8
        params = {}
        for name, (o, i, k) in {'proj_value.0': (dim, dim, 1), 'proj_query.0': (dim, dim, 1), 'region': (dim, 1, 5),
                                'spatial_1': (c1, 1, 5), 'spatial_2': (dim - c1 - c2, 1, 7), 'fusion': (dim, dim, 1),
                                'out': (dim, dim, 1)}.items():
            params[f'{name}.weight'] = torch.randn((o, i, k, k), generator=gen, device=device) / (k * i ** 0.5)
            if s['bias']:
                params[f'{name}.bias'] = torch.randn((o,), generator=gen, device=device) * 0.1
        x = torch.randn((s['n'], s['h'], s['w'], dim), generator=gen, device=device)

        packed32 = mo.pack_molrcm_weights(PTree(params), torch.float32)
        got = mo.fused_molrcm(x, packed32)
        want = mo.fused_molrcm_ref(x, packed32)
        err32 = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=MOLRCM_TOL * want.abs().max().item())
        del got, want

        xb = x.to(torch.bfloat16)
        packedb = mo.pack_molrcm_weights(PTree(params), torch.bfloat16)
        gotb = mo.fused_molrcm(xb, packedb)
        wantb = mo.fused_molrcm_ref(xb.float(), packedb)
        errb = (gotb.float() - wantb).abs().max().item()
        torch.testing.assert_close(gotb.float(), wantb, rtol=BF16_RTOL, atol=BF16_ATOL)
        xh = x.to(torch.float16)
        packedh = mo.pack_molrcm_weights(PTree(params), torch.float16)
        goth = mo.fused_molrcm(xh, packedh)
        wanth = mo.fused_molrcm_ref(xh.float(), packedh)
        errh = (goth.float() - wanth).abs().max().item()
        torch.testing.assert_close(goth.float(), wanth, rtol=BF16_RTOL, atol=BF16_ATOL)
        del gotb, wantb, goth, wanth, xh

        row = {'name': s['name'], 'shape': [s['n'], s['h'], s['w'], dim], 'max_abs_err_f32': err32,
               'max_abs_err_bf16': errb, 'max_abs_err_f16': errh}
        pb = PTree({k: v.to(torch.bfloat16) for k, v in params.items()})
        row['ms'] = _ms(lambda: mo.fused_molrcm(xb, packedb), reps)
        row['plain_ms'] = _ms(lambda: mo.fused_molrcm_ref(xb, packedb), reps)
        row['library_ms'] = None
        row['eager_chain_ms'] = _ms(lambda: eimn._molrcm(pb, xb, dim), reps)
        wbytes = packedb.numel() * 4
        row['bound_ms'], row['bound_by'] = molrcm_bound_ms(s, 'bfloat16', wbytes)
        if s['name'] == 'bench':
            row['ms_f32'] = _ms(lambda: mo.fused_molrcm(x, packed32), reps)
            row['bound_ms_f32'] = molrcm_bound_ms(s, 'float32', wbytes)[0]
        del x, xb
        torch.cuda.empty_cache()
        out.append(row)
    return out

def gather_shapes(n_img: int, tile: int, cfg: dict) -> list[dict]:
    """Every row-gather shape of the ATD path: per image of h x w tokens
    AC_MSA gathers the 3C-wide qkv rows into sorted order and the C-wide
    attention output back (the bench forwards, the tiled 720p windows, the
    CLI's 48x64 image in bf16; a 64x64 image in f32 too),
    plus edge shapes.  ``pitch``, ``offset``: the source rows' pitch and
    first column where they are a column slice of a wider matrix."""
    c = cfg['embed_dim']
    window = cfg['tile'] + 2 * cfg['halo']
    rows = []
    for name, imgs, h, w, dtypes in (('bench', n_img, tile, tile, ('bfloat16',)),
                                     ('tiled window', cfg['tile_batch'], window, window, ('bfloat16',)),
                                     ('cli', 1, 48, 64, ('bfloat16',)),
                                     ('model', 1, 64, 64, ('float32', 'bfloat16'))):
        n = imgs * h * w
        for dtype in dtypes:
            rows.append((f'{name} gather {dtype}', n, n, 3 * c, dtype, 'int64', None, 0))
            rows.append((f'{name} unsort {dtype}', n, n, c, dtype, 'int64', None, 0))
    rows += [
        ('one row', 1, 1, c, 'bfloat16', 'int64', None, 0),
        ('width 1', 1000, 1000, 1, 'bfloat16', 'int32', None, 0),
        ('ATD C210 unsort, 4-byte vectors', 65536, 65536, 210, 'bfloat16', 'int64', None, 0),
        ('ATD C210 gather, 4-byte vectors', 65536, 65536, 630, 'bfloat16', 'int32', None, 0),
        ('odd width f32', 4097, 4097, 45, 'float32', 'int64', None, 0),
        ('gather adding a pad tail', 2 * 640, 2 * 576, 3 * c, 'float32', 'int64', None, 0),
        ('unsort skipping a pad tail', 2 * 576, 2 * 640, c, 'bfloat16', 'int32', None, 0),
        ('column slice in place', 5000, 5000, c, 'bfloat16', 'int64', 3 * c, c),
        ('column slice in place, 2-byte vectors', 5000, 5000, 47, 'bfloat16', 'int64', 3 * c, 1),
    ]
    keys = ('name', 'rows_out', 'rows_src', 'width', 'dtype', 'idx', 'pitch', 'offset')
    return [dict(zip(keys, r)) for r in rows]

def gather_bound_ms(s: dict) -> tuple[float, str]:
    """Least time for one row gather on an H100: its bytes (every gathered
    row read once and written once, every index read once) over the memory
    rate.  It does no arithmetic."""
    size = 2 if s['dtype'] == 'bfloat16' else 4
    nbytes = s['rows_out'] * (2 * s['width'] * size + (8 if s['idx'] == 'int64' else 4))
    return nbytes / PEAK_BYTES * 1e3, 'bytes'


def phase_gather_kernels(device, shapes: list[dict], reps: int) -> list[dict]:
    """Each shape: the row-gather kernel against its plain version, exact
    equality in f32, bf16 and fp16 with int64 and int32 indices (a random
    permutation cut or repeated to ``rows_out``, with one index repeated),
    then kernel / plain / library / bound times in the shape's own types.
    The plain version is the library call, ``index_select``."""
    import torch

    from resselt_tpu_torch.ops import row_gather, row_gather_ref

    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for s in shapes:
        wide32 = torch.randn((s['rows_src'], s['pitch'] or s['width']), generator=gen, device=device)
        perm = torch.randperm(s['rows_src'], generator=gen, device=device)
        idx64 = perm.repeat(-(-s['rows_out'] // s['rows_src']))[:s['rows_out']].clone()
        idx64[-1] = idx64[0]
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            src = wide32.to(dtype)[:, s['offset']:s['offset'] + s['width']]
            for idx in (idx64, idx64.to(torch.int32)):
                got = row_gather(src, idx)
                want = row_gather_ref(src, idx)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"row_gather differs from its plain version at {s['name']}, "
                                         f'{dtype}, {idx.dtype}')
                del got, want
        wide = wide32.to(getattr(torch, s['dtype']))
        src = wide[:, s['offset']:s['offset'] + s['width']]
        idx = idx64.to(getattr(torch, s['idx']))
        del wide32, idx64
        row = {**s, 'max_abs_err': 0.0}
        row['ms'] = _ms(lambda: row_gather(src, idx), reps)
        row['plain_ms'] = _ms(lambda: row_gather_ref(src, idx), reps)
        row['library_ms'] = _ms(lambda: torch.index_select(src, 0, idx), reps)
        row['bound_ms'], row['bound_by'] = gather_bound_ms(s)
        del wide, src, perm, idx
        torch.cuda.empty_cache()
        out.append(row)
    return out


def _entries() -> dict:
    """Every kernel wrapper, by the name its counts are reported under."""
    from resselt_tpu_torch.ops import fused_conv as fc
    from resselt_tpu_torch.ops import molrcm as mo
    from resselt_tpu_torch.ops import row_gather
    from resselt_tpu_torch.ops import window_attention as wa

    from resselt_tpu_torch.ops import window_cross_attention as wca

    return {'act': fc.fused_conv3x3_act, 'pack2': fc.fused_conv3x3_pack2, 'lk': fc.fused_conv_lk,
            'wattn': wa.window_mha, 'wcross': wca.window_cross_mha, 'molrcm': mo.fused_molrcm, 'gather': row_gather}

# -- the served path: launches a forward at the cells' shapes ----------------------------------------------

# BENCHMARK.json's configurations at their published widths (the port's zoo, seeded), each served a 720p frame
SERVED = {
    'esrgan_x4': ('make_esrgan', (64, 23, 4), {}),
    'swinir_m_x4': ('make_swinir', (180, (6,) * 6, (6,) * 6, 8), {'upscale': 4, 'img_size': 64}),
    'drct_l_x4': ('make_drct', (180, 12, 6, 16, 32, 2.0, 4), {'img_size': 64}),
    'hat_l_x4': ('make_hat', (180, (6,) * 12, (6,) * 12, 16, 0.5, 3, 30, 2.0, 4, 64), {}),
}
FRAME = (720, 1280)


def launch_counts() -> dict:
    """Every kernel wrapper's launches so far, the window attentions left to
    the plain path, and conv3x3's launches by epilogue kind and by schedule,
    conv_lk's by path and window_mha's by kernel."""
    from collections import Counter

    from resselt_tpu_torch.nn.window import multi_head_attention

    def by(counter, part):
        out = Counter()
        for key, n in counter.items():
            out[part(key)] += n
        return out

    e = _entries()
    out = {k: entry.launches for k, entry in e.items()}
    out.update(plain_attention=multi_head_attention.plain_calls, epilogue=Counter(e['act'].by_epilogue),
               schedule=by(e['act'].by_schedule, lambda key: f'{key[0]} {key[1]}'),
               lk_path=by(e['lk'].by_path, lambda key: key[1]),
               wattn_kernel=by(e['wattn'].by_kernel, lambda key: key[0]))
    return out


def served_launches() -> dict:
    """Each configuration of :data:`SERVED` loaded on the card
    (``load_from_state_dict``) and a uint8 :data:`FRAME` served through
    ``upscale_tiled`` in bf16 at the loader's tile, halo and batch on the
    host loop: the launches a tile-batch forward, by wrapper and by route,
    counted from just before the frame."""
    import torch

    import resselt_tpu_torch
    from resselt_tpu_torch import zoo
    from resselt_tpu_torch.parallel import tiling as tt

    out = {}
    for name, (maker, args, kwargs) in SERVED.items():
        model = resselt_tpu_torch.load_from_state_dict(getattr(zoo, maker)(*args, seed=0, **kwargs), device='cuda')
        model.weights(torch.bfloat16)
        tile, halo, _ = tt._resolve_window(model, None, None, torch.bfloat16, None, 1)
        grid, batch = tt._plan_tiled(model, *FRAME, tile, halo, None, torch.bfloat16)
        forwards = -(-len(grid.ys) * len(grid.xs) // batch)
        frame = torch.randint(0, 256, (*FRAME, 3), dtype=torch.uint8, device='cuda')
        torch.cuda.synchronize()
        before = launch_counts()
        with torch.no_grad():
            tt.upscale_tiled(model, frame, dtype=torch.bfloat16, on_device=False)
        torch.cuda.synchronize()
        per = {}
        for k, v in launch_counts().items():
            got = v - before[k]
            if isinstance(got, int):
                got = {'': got} if got else {}
            for route, n in got.items():
                if n % forwards:
                    raise RuntimeError(f'{name}: {n} {k} {route} launches over {forwards} forwards')
                per[f'{k} {route}'.strip()] = n // forwards
        out[name] = {'tile': tile, 'halo': halo, 'batch': batch, 'forwards': forwards, 'launches_a_forward': per}
        del model
    return out


# -- training: each kernel's gradient and its backward's time ----------------------------------------------

# tools/bench_train.py:83-92's configurations at full width (the port's zoo, seeded): LR crop and batch
TRAIN_MODELS = {
    'ESRGAN-23': {'crop': 48, 'batch': 8},
    'SwinIR-M': {'crop': 64, 'batch': 2},
    'Compact': {'crop': 64, 'batch': 16},
    'SPAN': {'crop': 64, 'batch': 16},
}
# the families whose kernels no training configuration runs, at their widths and a small depth
TRAIN_FAMILIES = {'PLKSR': {'crop': 48, 'batch': 4}, 'EIMN_L': {'crop': 48, 'batch': 4},
                  'ATD-light': {'crop': 48, 'batch': 2}}


def train_makers() -> dict:
    """The state dict of each training configuration and family, seeded."""
    from resselt_tpu_torch.zoo import make_atd, make_compact, make_eimn, make_esrgan, make_plksr, make_span, make_swinir

    sw, at = SWINIR, ATD
    return {
        'ESRGAN-23': lambda: make_esrgan(64, 23, 4, seed=0),
        'SwinIR-M': lambda: make_swinir(sw['embed_dim'], sw['depths'], sw['num_heads'], sw['window_size'],
                                        upscale=4, img_size=sw['img_size'], seed=0),
        'Compact': lambda: make_compact(64, 32, 4, seed=0),
        'SPAN': lambda: make_span(48, 4, seed=0),
        'PLKSR': lambda: make_plksr(PLKSR['dim'], 4, 4, PLKSR['kernel_size'], seed=0),
        'EIMN_L': lambda: make_eimn(EIMN['embed_dims'], 2, EIMN['depths'], EIMN['mlp_ratio'], 4, seed=0),
        'ATD-light': lambda: make_atd(at['embed_dim'], (2,), (4,), at['window_size'], at['num_tokens'],
                                      at['reducted_dim'], at['convffn_kernel_size'], at['mlp_ratio'], 4, seed=0),
    }


def _grad_entries() -> dict:
    """The wrappers whose Functions carry a gradient, by the names their
    counts are reported under (not the cross attention's: training keeps
    its plain path)."""
    return {k: v for k, v in _entries().items() if k not in ('pack2', 'wcross')}


def forward_shapes(model, cfg: dict) -> dict:
    """The kernel shapes (each wrapper's ``by_shape`` keys) of one f32
    forward at the configuration's training batch."""
    import torch

    from collections import Counter

    before = {k: Counter(e.by_shape) for k, e in _grad_entries().items()}
    x = torch.rand((cfg['batch'], cfg['crop'], cfg['crop'], 3), device='cuda')
    with torch.no_grad():
        model.raw_apply_fn(model.config, model.params, x)
    torch.cuda.synchronize()
    return {k: sorted(set(e.by_shape - before[k])) for k, e in _grad_entries().items() if e.by_shape - before[k]}


def _grad_pair(fn, plain, inputs, reps: int = 0):
    """Gradients of ``sum(out * g)`` for a fixed random ``g`` through the
    Function and through the plain version; with ``reps``, also the ms of
    each backward alone (the graph kept, the backward run again)."""
    import torch

    res = []
    for f in (fn, plain):
        out = f(*inputs)
        g = torch.randn(out.shape, generator=torch.Generator(device='cuda').manual_seed(0), device='cuda')
        need = [t for t in inputs if isinstance(t, torch.Tensor) and t.requires_grad]
        grads = torch.autograd.grad(out, need, g, retain_graph=bool(reps))
        ms = _ms(lambda: torch.autograd.grad(out, need, g, retain_graph=True), reps, graph=False) if reps else None
        res.append((grads, ms))
    return res


def phase_train_grads(shapes: dict, main: dict, reps: int) -> tuple[list[dict], dict]:
    """Each Function's gradients against autograd through its plain version
    on the card, f32 with TF32 off, at every shape the training models give
    it (``shapes``: by kind, each key to the batch of images it came
    from): within the kernel's forward f32 tolerance x max|plain gradient|.
    The backward launches per shape, and those sent to conv2d_input; at the
    ``main`` shape of each kernel also the ms of the backward, Function
    against plain."""
    import importlib

    import torch

    from resselt_tpu_torch.ops import fused_conv as fc
    from resselt_tpu_torch.ops import molrcm as mo
    from resselt_tpu_torch.ops import window_attention as wa

    rg = importlib.import_module('resselt_tpu_torch.ops.row_gather')
    gen = torch.Generator(device='cuda').manual_seed(0)

    def leaf(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device='cuda')).requires_grad_(True)

    rows, figs = [], {}
    for kind, keys in shapes.items():
        for key, images in keys.items():
            tol = MOLRCM_TOL if kind == 'molrcm' else F32_TOL
            if kind in ('act', 'lk'):
                n, h, w, cin, cout = key[:5]
                k = 3 if kind == 'act' else key[5]
                act = key[-1]
                # the lk wrapper reads PLKSR's 16-of-dim slice at the model's pixel pitch
                x = leaf(n, h, w, PLKSR['dim'] if kind == 'lk' else cin)
                inputs = (x, leaf(cout, cin, k, k, scale=1 / (k * cin ** 0.5)), leaf(cout, scale=0.1))
                if kind == 'act':
                    fn = lambda x, w, b, act=act: fc.fused_conv3x3_act(x, w, b, act)  # noqa: E731
                    plain = lambda x, w, b, act=act: fc.fused_conv3x3_act_ref(x, w, b, act)  # noqa: E731
                else:
                    fn = lambda x, w, b, k=k, c=cin, act=act: fc.fused_conv_lk(x[..., :c], w, b, k, act)  # noqa: E731
                    plain = lambda x, w, b, k=k, c=cin, act=act: fc.fused_conv_lk_ref(x[..., :c], w, b, k, act)  # noqa: E731
                entry = fc.fused_conv3x3_act if kind == 'act' else fc.fused_conv_lk
                bkey = (n, h, w, cout, cin) + ((k,) if kind == 'lk' else ()) + ('linear',)  # dx's launches
                row = {'kind': kind, 'shape': list(key), 'grads': 'dx, dW, db'}
            elif kind == 'wattn':
                b, n, c, heads, masked = key
                nw = b // images if masked else 0  # a shift mask per window of one image
                mask = None
                if nw:
                    mask = torch.where(torch.rand((nw, n, n), generator=gen, device='cuda') > 0.7, -100.0, 0.0)
                hd = c // heads
                inputs = (leaf(b, n, 3 * c), leaf(heads, n, n))

                def run(f, c=c, heads=heads, mask=mask, hd=hd):
                    return lambda qkv, bias: f(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias, mask,
                                               num_heads=heads, scale=hd ** -0.5)

                fn, plain = run(wa.window_mha), run(wa.window_mha_ref)
                entry, bkey = None, None
                row = {'kind': kind, 'shape': [b, n, c, heads, nw], 'grads': 'dq, dk, dv (one qkv), dbias'}
            elif kind == 'molrcm':
                n, h, w, dim = key[:4]
                inputs = (leaf(n, h, w, dim), leaf(mo.packed_size(dim), scale=0.1))
                fn, plain = mo.fused_molrcm, mo.fused_molrcm_ref
                entry, bkey = None, None
                row = {'kind': kind, 'shape': [n, h, w, dim], 'grads': 'dx, dpacked'}
            else:
                rows_out, rows_src, width = key[:3]
                idx = torch.randint(0, rows_src, (rows_out,), generator=gen, device='cuda')
                inputs = (leaf(rows_src, width), idx)
                fn, plain = rg.row_gather, rg.row_gather_ref
                entry, bkey = None, None
                row = {'kind': kind, 'shape': [rows_out, rows_src, width], 'grads': 'dsrc'}
            is_main = main.get(kind) == key
            before = (entry.backward_by_shape[bkey], entry.backward_conv2d_input[bkey]) if entry else (0, 0)
            (got, ms), (want, plain_ms) = _grad_pair(fn, plain, inputs, reps if is_main else 0)
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            scale = [float(b.abs().max()) for b in want]
            row['max_abs_err'] = max(errs)
            row['max_err_over_max_plain'] = max(e / max(s, 1e-30) for e, s in zip(errs, scale))
            row['tol'] = tol
            if entry is not None:
                row['backward_launches'] = entry.backward_by_shape[bkey] - before[0]
                row['conv2d_input'] = entry.backward_conv2d_input[bkey] - before[1]
            if is_main:
                row['backward_ms'], row['plain_backward_ms'] = ms, plain_ms
                figs[kind] = row
            if any(e > tol * s + 1e-7 for e, s in zip(errs, scale)):
                raise AssertionError(f'{kind} {key}: gradient errors {errs} against max|plain| {scale}, tol {tol}')
            rows.append(row)
            del inputs, got, want
    return rows, figs

def train_grads() -> dict:
    """phase_train_grads at the kernel shapes of every training batch, f32
    with TF32 off, logged; returns the kernels line's training figures."""
    import torch

    import resselt_tpu_torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        shapes: dict[str, dict] = {}
        for name, make in train_makers().items():
            cfg = {**TRAIN_MODELS, **TRAIN_FAMILIES}[name]
            model = resselt_tpu_torch.load_from_state_dict(make(), device='cuda')
            for kind, keys in forward_shapes(model, cfg).items():
                shapes.setdefault(kind, {}).update({key: cfg['batch'] for key in keys})
            del model
        # and the "any" kernel's: DRCT's swin3 (2 heads of 122, window 16) at a batch of 2 x 64² images,
        # 16 windows an image, and its swin5 (4 of 77) with a mask of 16 windows
        shapes['wattn'].update({(32, 256, 244, 2, False): 2, (32, 256, 308, 4, True): 2})
        shapes = {k: dict(sorted(v.items())) for k, v in shapes.items()}
        e = TRAIN_MODELS['ESRGAN-23']
        main = {'act': next(k for k in shapes['act'] if k[:5] == (e['batch'], e['crop'], e['crop'], 64, 192)),
                'lk': next(iter(shapes['lk'])),
                'wattn': next(k for k in shapes['wattn'] if k[1:] == (64, 180, 6, True)),
                'molrcm': next(iter(shapes['molrcm'])), 'gather': next(iter(shapes['gather']))}
        rows, figs = phase_train_grads(shapes, main, reps=10)
        log('train_grads', tol_f32=F32_TOL, tol_molrcm=MOLRCM_TOL, shapes=sum(len(v) for v in shapes.values()),
            conv2d_input_shapes=sum(1 for r in rows if r.get('conv2d_input')), rows=json.dumps(rows))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    by_kind: dict[str, float] = {}
    for r in rows:
        by_kind[r['kind']] = max(by_kind.get(r['kind'], 0.0), r['max_abs_err'])
    return {'grad_max_err': by_kind, 'main': figs}


def ptxas_report(build_log: str) -> dict:
    """What ``nvcc -Xptxas -v`` said of each kernel of one source: registers,
    static shared memory and spills, under the kernel's name with its
    template arguments as the mangled name spells them."""
    import re

    out, name = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = re.sub(r'^_ZN?\d*_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+', '', m.group(1))
            name = re.sub(r'EEvP.*$|EvP.*$|PK.*$', '', name).replace('13__nv_bfloat16', 'bf16,').replace('6__half', 'f16,')
            continue
        if name is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', ln)
        if m:
            out.setdefault(name, {})['spill_bytes'] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r'Used (\d+) registers(?:.*?(\d+) bytes smem)?', ln)
        if m:
            out.setdefault(name, {}).update(registers=int(m.group(1)), static_smem=int(m.group(2) or 0))
    return out


PARENT_SLACK = 1.02  # a conv3x3 or window-attention shape slower than the parent's build by more than this is listed


def slower_than_parent(rows: list[dict]) -> dict:
    """The rows that :func:`vs_parent` timed more than :data:`PARENT_SLACK`
    times the parent's, by name and shape (nothing where no parent was
    given)."""
    timed = [r for r in rows if 'vs_parent' in r]
    if not timed:
        return {}
    slow = [f"{r['name']} {r.get('shape', '')}".strip() for r in timed if r['vs_parent']['ratio'] > PARENT_SLACK]
    return {'slower_than_parent': json.dumps(slow)}


def _figures(head: dict, rows: list[dict], timed_shape: str, err_key: str = 'max_abs_err_bf16', **extra) -> dict:
    """One kernel's entry of the kernels line: its main row's times a launch
    (``head``), its largest 16-bit error over ``rows``, and ``extra``."""
    return {'max_abs_err': max(r[err_key] for r in rows), 'ms': head['ms'], 'plain_ms': head['plain_ms'],
            'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'], 'library_ms': head['library_ms'],
            'timed_shape': timed_shape, **extra}


def _backward(train: dict, kind: str, how: str, label: str = '') -> dict:
    """A kernel's gradient figures from :func:`train_grads`: how it is
    computed, its largest error, and where timed, the backward's ms."""
    out = {'backward': how, 'grad_max_err': train['grad_max_err'][kind]}
    main = train['main'][kind]
    if 'backward_ms' in main:
        out.update(backward_ms=main['backward_ms'], plain_backward_ms=main['plain_backward_ms'],
                   backward_shape=f'f32 {label}' + 'x'.join(map(str, main['shape'])))
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Time the port's hand-written kernels shape by shape on one NVIDIA GPU.")
    ap.add_argument('--parent-conv3x3', metavar='PATH',
                    help="an earlier copy of csrc/conv3x3.cu: the kernels, step_kernels and conv_family_kernels "
                         "phases also hold its outputs equal to the kernel's and time it")
    ap.add_argument('--parent-window-attn', metavar='PATH',
                    help="an earlier copy of csrc/window_attn.cu: the wattn_kernels rows also time its launches in "
                         "turns with this build's and compare their bf16 outputs")
    args = ap.parse_args()

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
    log('build', seconds=round(time.perf_counter() - t0, 2), kernels=took,
        ptxas=json.dumps({name: ptxas_report(_build.build_log(name)) for name in took}))

    from tools.time_kernel_variants import build as build_variants

    parent = build_variants('conv3x3', ['@' + args.parent_conv3x3])[0] if args.parent_conv3x3 else None
    parent_wattn = None
    if args.parent_window_attn:
        parent_wattn = build_variants('window_attn', ['@' + args.parent_window_attn])[0]
    n, tile = BENCH['batch'], BENCH['tile']
    tols = {'f32_tol': F32_TOL, 'bf16_rtol': BF16_RTOL, 'bf16_atol': BF16_ATOL}
    rows = phase_kernels('cuda', conv_shapes(n, tile), reps=10, parent=parent)
    log('kernels', **tols, rows=json.dumps(rows), **slower_than_parent(rows))
    step_rows = phase_step_kernels('cuda', step_shapes(n, tile), reps=10, parent=parent)
    log('step_kernels', equal='bit for bit', rows=json.dumps(step_rows), **slower_than_parent(step_rows))
    lk_rows = phase_lk_kernels('cuda', lk_shapes(n, tile, PLKSR['pdim'], PLKSR['kernel_size']), reps=10)
    log('lk_kernels', **tols, rows=json.dumps(lk_rows))
    others = (ATD, HAT, DAT, RGT, DRCT, FDAT, OMNI, FLEXNET)
    w_rows = phase_wattn_kernels('cuda', wattn_shapes(n, tile, SWINIR, others), reps=10, parent=parent_wattn)
    log('wattn_kernels', **{**tols, 'bf16_atol': WATTN_BF16_ATOL}, rows=json.dumps(w_rows),
        **slower_than_parent(w_rows))
    x_rows = phase_wcross_kernels('cuda', reps=10)
    log('wcross_kernels', bf16_rtol=BF16_RTOL, bf16_atol=WATTN_BF16_ATOL, rows=json.dumps(x_rows))
    m_rows = phase_molrcm_kernels('cuda', molrcm_shapes(n, tile, EIMN), reps=10)
    log('molrcm_kernels', **{**tols, 'f32_tol': f'{MOLRCM_TOL} x max|plain|'}, rows=json.dumps(m_rows))
    g_rows = phase_gather_kernels('cuda', gather_shapes(n, tile, ATD), reps=10)
    log('gather_kernels', tol='exact', rows=json.dumps(g_rows))
    f_rows = phase_kernels('cuda', conv_family_shapes(n, tile), reps=10, parent=parent)
    log('conv_family_kernels', **tols, rows=json.dumps(f_rows), **slower_than_parent(f_rows))
    train = train_grads()
    served = served_launches()

    head = next(r for r in rows if r['name'] == 'rdb stage0 64->192')
    lk_head = next(r for r in lk_rows if r['name'] == 'bench 16->16')
    w_head = next(r for r in w_rows if r['name'] == 'bench masked')
    x_head = next(r for r in x_rows if r['name'] == 'HAT-L served')
    m_head = next(r for r in m_rows if r['name'] == 'bench')
    g_head = next(r for r in g_rows if r['name'] == 'bench gather bfloat16')
    kernels = [{
        'name': 'fused_conv3x3_act', 'source': 'resselt_tpu_torch/csrc/conv3x3.cu',
        'replaces': 'resselt_tpu/ops/fused_conv.py:59',
        **_figures(head, rows + f_rows, head['name'] + ' bf16 ' + 'x'.join(map(str, head['shape']))),
        **_backward(train, 'act', 'dz from the saved output (lrelu) or one linear relaunch of this kernel (silu, mish); '
                    'dx on this kernel with the taps turned 180 degrees and Cin / Cout swapped (conv2d_input where '
                    'its gate refuses the shape); dW by torch.nn.grad.conv2d_weight; db the sum of dz'),
        'shapes': rows, 'step_shapes': step_rows, 'family_shapes': f_rows,
    }, {
        'name': 'fused_conv_lk', 'source': 'resselt_tpu_torch/csrc/conv_lk.cu',
        'replaces': 'resselt_tpu/ops/fused_conv.py:288',
        **_figures(lk_head, lk_rows, f"PLKSR bench bf16 {'x'.join(map(str, lk_head['shape']))} k{lk_head['k']}"),
        **_backward(train, 'lk', 'dx on this kernel with the taps turned 180 degrees and Cin / Cout swapped '
                    '(conv2d_input where its gate refuses the shape), back into the slice it read; dW by '
                    'torch.nn.grad.conv2d_weight'),
        'shapes_past_k31': [r['name'] for r in lk_rows if r['k'] > 31], 'shapes': lk_rows,
    }, {
        'name': 'window_mha', 'source': 'resselt_tpu_torch/csrc/window_attn.cu',
        'replaces': 'resselt_tpu/ops/window_attention.py:32',
        **_figures(w_head, w_rows, f"SwinIR-M bench masked bf16 {w_head['windows']} windows x {w_head['n']} tokens, "
                   f"C {w_head['c']}, {w_head['heads']} heads, nW {w_head['mask_windows']}",
                   library_kernels=w_head['library_kernels']),
        **_backward(train, 'wattn', 'plain torch in f32: P recomputed, dV = P^T dO, dS = P (dO V^T - rowsum(dO V^T '
                    'P)), dq = scale dS k, dk = scale dS^T q, dbias the sum of dS over windows; no mask gradient',
                    'SwinIR-M masked '),
        'shapes_on_any_kernels': [r['name'] for r in w_rows if r['n'] > 256 or r['c'] // r['heads'] > 64],
        'shapes_on_wgmma_kernel': [r['name'] for r in w_rows if 64 < r['n'] <= 256 and r['c'] // r['heads'] <= 64],
        'shapes': w_rows,
    }, {
        'name': 'window_cross_mha', 'source': 'resselt_tpu_torch/csrc/window_cross_attn.cu',
        'replaces': 'none: the JAX package runs OCAB in XLA (resselt_tpu/archs/hat.py::_ocab)',
        **_figures(x_head, x_rows, f"HAT-L served bf16 {x_head['windows']} windows x {x_head['n']} queries x "
                   f"{x_head['m']} keys, C {x_head['c']}, {x_head['heads']} heads",
                   library_kernels=x_head['library_kernels']),
        'backward': 'none: training keeps the plain path', 'shapes': x_rows,
    }, {
        'name': 'fused_molrcm', 'source': 'resselt_tpu_torch/csrc/molrcm.cu', 'replaces': 'resselt_tpu/ops/molrcm.py:80',
        **_figures(m_head, m_rows, f"EIMN_L bench bf16 {'x'.join(map(str, m_head['shape']))}",
                   library_note='no single PyTorch call computes MOLRCM; eager_chain_ms is the eager bf16 chain',
                   eager_chain_ms=m_head['eager_chain_ms']),
        **_backward(train, 'molrcm', 'autograd through the plain MOLRCM chain, recomputed, into x and the packed '
                    'weights'),
        'shapes': m_rows,
    }, {
        'name': 'row_gather', 'source': 'resselt_tpu_torch/csrc/row_gather.cu',
        'replaces': 'tools/probe_acmsa_gather.py:39',
        **_figures(g_head, g_rows, f"ATD-light bench qkv gather bf16 {g_head['rows_out']} rows x {g_head['width']}, "
                   f"{g_head['idx']} indices", err_key='max_abs_err'),
        **_backward(train, 'gather', 'zeros.index_add_(0, idx, dout): the rows of a repeated index summed'),
        'shapes': g_rows,
    }]
    print(smi)
    print(json.dumps({'kernels': kernels, 'served_launches': served, 'eager_timings': EAGER_TIMINGS}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
