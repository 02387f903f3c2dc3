#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (resselt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each: device, build (one nvcc per resselt_tpu_torch/csrc/*.cu,
all started together; ptxas's registers, shared memory and spills per
kernel).  Every kernels phase holds its kernel against the plain version in
f32, bf16 and fp16; every model phase holds bf16, fp16 and
precision='bfloat16' against f32.  Then ESRGAN: kernels (every ESRGAN 3x3
conv shape and the kernel's other shape classes: every N tile of the wgmma
path, Cout 3 / 7 / 8, Cin 3 / 12 / 48, ragged H and W, the four
activations; then kernel / plain / library / bound times), load (a seeded ESRGAN
RRDBNet-23 4x checkpoint written as .safetensors and .pth and loaded
through the public entry points), model (f32 on the card against the CPU,
351 kernel launches per forward, bf16 against f32), serve (the main path:
the bench config, batch 16 of 256x256 tiles in bf16, then a tiled 1280x720
image, then the upscale CLI on a PNG; the launch counts start from 0 just
before it, the bench forwards must launch 351 convs each, all at shapes the
kernels phase checked, and each shape's launches per forward are read from
those forwards' counts).  Then PLKSR the same way: lk_kernels (every
large-kernel conv shape of the PLKSR path and the edges of the kernel's
three 16-bit paths, stacked, tiles and mma, each bf16 launch counted on
the path the wrapper plans for it; against the plain version in f32, bf16
and fp16, with times), plksr_load (PLKSR dim 64, 28 blocks, k 17, 4x),
plksr_model (28 lk launches per forward, card against CPU, bf16 against
f32; RealPLKSR with DySample card against CPU), plksr_serve (28 lk launches
per bench forward, every one on the stacked path).  Then
SwinIR-M the same way: wattn_kernels (every window-attention shape of
the SwinIR path and the kernel's other shape classes, against the plain
version, with kernel / plain / library (PyTorch's
scaled_dot_product_attention, with the backend it picked) / bound times;
the masked rows use a random mask without an all-zero window, and the three
bench shapes are also timed with the model's own shift mask, which stands
for the bench forwards' masked launches, and with an all-zero mask),
swinir_load (SwinIR-M x4 classical, embed 180, depths and heads (6,) x 6,
window 8), swinir_model (36 window_mha launches per forward, card against
CPU, bf16 against f32; the real-world nearest+conv variant at 2 x 2
blocks card against CPU), swinir_serve (36 launches per bench forward,
and every shape of the phase checked by wattn_kernels).  Then EIMN_L
the same way: molrcm_kernels (every MOLRCM shape of the EIMN path: the
bench, the tiled window, the CLI's and the model phase's images, and the
edges of the 16-bit kernel's 16-column strips and runs of rows, one
without biases; against the plain version in f32, bf16 and fp16, with
kernel / plain / eager-chain / bound times), eimn_load (the reference's
eimn() defaults: embed 64, 16 stages of one block, mlp ratio 2.66, 4x),
eimn_model (16 fused_molrcm launches per forward, card against CPU, bf16
against f32), eimn_serve (16 launches per bench forward, all of them bf16
launches of the strip kernel, every shape of the phase checked by
molrcm_kernels; tiled at the defaults for a model without hints, tile
256, halo 16).  Then ATD-light and HAT-S, the two transformers with 256-token
windows: gather_kernels (every row-gather shape of the ATD path: the bench
forwards' qkv gather and unsort, the tiled 720p windows', the model
check's and the CLI image's, plus edge shapes (one row, width 1, widths
that are not multiples of 16 bytes, a repeated index, more or fewer output
rows than source rows, a column slice read in place); exact equality with
the plain version in f32 and bf16, int64 and int32 indices; kernel / plain
/ library (index_select) / bound times); wattn_kernels also holds their
window shapes; atd_load / atd_model (30 window_mha + 60 row_gather
launches per forward, card against CPU, bf16 against f32, and the tokens
whose AC_MSA category differs between the two) / atd_serve (30 + 60 per
bench forward; tiled at the loader's bf16 hints: tile 160, halo 8, two
windows a batch), hat_load / hat_model (36 window_mha launches; the six
OCABs take the plain path) / hat_serve (36 per bench forward; tiled at
tile 192, halo 16, two windows a batch).  Then DAT-S, RGT-S and DRCT, the
window transformers with rectangular windows and wide heads (wattn_kernels
holds each class of their window attentions: DAT's (8, 16) and (16, 8)
branches at C 90, RGT's (8, 32) and (32, 8), DRCT's swin1 / swin2 / swin4
at C 180 / 212 / 276, head_dim 30 / 53 / 46, with the models' own
rectangular shift masks): dat_load / dat_model / dat_serve (36 window_mha
launches per forward, 18 masked; tiled at tile 96, halo 8, eight windows a
batch), rgt_* (36; tile 160, halo 8, two a batch), drct_* (18; swin3 at
head_dim 122 and swin5 at 77, 12 attentions a forward, take the plain path,
whose time per bench forward is measured beside the library's; tile 128,
halo 8, one a batch).  Then FDAT-M and OmniSR, whose attentions are
unmasked n 64 windows (wattn_kernels holds FDAT-M's spatial windows at C
120, 4 heads, and OmniSR's block and grid windows at C 64, 4 heads):
fdat_load (the MetaUpsample buffer dropped) / fdat_model (12 window_mha
launches per forward; small lda and dysample 2x models held card against
CPU, so that grid_sample with aligned corners runs on the card) /
fdat_serve (12 per bench forward; tiled at tile 128, halo 8, two windows a
batch), omni_load / omni_model (10; a model without the relative-position
bias, its zero bias through the kernel) / omni_serve (10; tiled at the
defaults, tile 256, halo 16, eight windows a batch).  Every model and
serve phase of a window transformer also asserts the window attentions the
plain path took (0; HAT-S 6, DRCT 12), and each serve phase reports its
peak device memory.  Then the six 3x3-conv families, whose every
same-padded 3x3 conv runs the conv3x3 kernel: conv_family_kernels (every
distinct 3x3 conv of their bench forwards: Cin 3 stems, 48 -> 48 with
SiLU, Mish or none, the 48 -> 12 heads, MoSR's 64 -> 192, 96 -> 64, 64 ->
128 and 128 -> 64, RCAN's 64 -> 256 tail and 64 -> 3 at 1024²; against the
plain version in f32, bf16 and fp16, with kernel / plain / library / bound
times), then for SpanPP 2x, SPAN 4x, RCAN 4x, MoSR 4x, Compact 4x and
SPANPlus 2x at tools/bench_families.py's widths a load phase (the
checkpoint's collapsed params equal the CPU loader's), a model phase (21,
21, 415, 54, 18 and 21 conv3x3 launches per forward; small variants card
against CPU: SPAN without norm, RCAN's unshuffle head, MoSR's dys and gps
tails, SPANPlus's dys and conv tails) and a serve phase (the same launches
per bench forward, only at shapes conv_family_kernels checked; SpanPP
served through with_config(eval_scale=2); tiled at tile 256 and the
loader's halo; peak memory).  Then CUGAN (UpCunet2x at its fixed widths;
plain torch, its convs unpadded, strided or transposed: no kernel launch,
asserted) and five families whose same-padded 3x3 convs run the conv3x3
kernel, at the widths of chip_smoke's configs (the zoo's, since their
reference defaults are not in this repo): GateR 1x (9 launches a forward),
MoSRv2 4x (52), MoESR 4x (122), GateRv2 1x (8) and GateRV3 1x (27), each
with load / model / serve phases as the six conv families'; the model
phase also holds the launches against the convs the CPU's forward routes,
small variants card against CPU (CUGAN 3x, 4x pro and 2x_fast; GateR's
depthwise latent; MoSRv2's dysample unshuffle and pixelshuffle 3x; MoESR
dysample; GateRv2 pixelshuffle 2x; GateRV3 dysample with a 3x3 end conv
and lda), and torch.utils.flop_counter's count of the forward against
bench_families.md's XLA count of the reference default; conv_family_kernels
holds their new 3x3 shapes.  Then the last eight families the same way, at
the zoo's widths: RTMoSR 2x with the unshuffle stem (8 conv3x3 launches a
forward), SMoSR 4x (12), RHA 4x (53), FlexNet 4x (16, and 36 window_mha
launches a forward on its one-head, zero-bias n 64 windows; wattn_kernels
holds their shapes; a small meta U-Net whose 128-wide level takes the plain
path), GFISR 4x (50), GFISRV2 4x (48), FIGSR 4x (57) and LAWFFT 4x (2),
each with load / model / serve phases; their flop counts are taken at the
tile and batch of bench_families.md's row, and for the four spectral
families also with the JAX package's matmul-DFT FLOPs, which its XLA
count includes and torch.fft does not.  Every serve phase runs its tiled
1280x720 bf16 image both ways (``phase_tiled``): the host loop
(``on_device=False``), cold and warm, and the default one-dispatch path, a
CUDA graph per image, at its first call (warm-up run, capture, replay) and
at steady state (median of 3); the wrappers must count the host loop's
launches twice at the graph's first call (warm-up run and capture) and none
at a replay, the graph's kernel nodes (what a replay launches) must equal
the host loop's launches by source, its output the host loop's within
2e-2 x max|host loop|, and each path's peak memory is reported.  Then the
serving side: graph (f32
with TF32 off, the graph within 1e-6 of the host loop for ESRGAN, PLKSR,
SwinIR-M, EIMN_L, ATD-light and LAWFFT, so every CUDA source and cuFFT
under capture; nine image sizes through one model, the LRU keeping eight
graphs, device memory before and after the eviction; ``bucket=True``
sharing one graph across three sizes; RHA through four distinct 720p-class
sizes, the memory its graphs keep held to 1.5x one's), int8 (ESRGAN-23
quantized: its int8
convs; every int8 conv of a card forward run again on the CPU on the same
input within 1e-4 x max|y|; the whole forwards' PSNR card against CPU and
int8 against float above 35 dB; the bench forward's ms int8 against bf16,
recorded; the int8 model's tiled image through the graph, and four sizes as
RHA's; Compact, SPAN and
CUGAN card against CPU), cache_tools (``convert`` to .npz and
.safetensors, the .npz model on the card bit-identical to the
checkpoint's, ``inspect --json``, the CLI on the .npz over a directory of
three PNGs with ``--int8``, ``--tile 64`` and ``--trace``), cli_sizes (ten
images in ten sizes through ATD-light and ESRGAN-23: the library on the
host loop and on the graph path, then the CLI, which picks the path by
whether a size repeats, as they are and with ``--bucket``).  Then the card's
name and power limit, one JSON line of kernel figures, and last
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
# DRCT x4 (DRCT paper, Hsu et al., CVPRW 2024; tools/bench_families.py's
# 'drct-l 4x': six groups); tiled at the loader's bf16 hints, one window a batch
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

# The six 3x3-conv families at tools/bench_families.py's widths (:90-103),
# served at the bench shape; every same-padded 3x3 conv runs conv3x3.cu.
# tiled at tile 256 and each loader's halo (4 for Compact and SPAN, else 16)
SPAN = {'name': 'SPAN', 'feature_channels': 48, 'scale': 4, 'tile': 256}  # 'span 4x': SPAN(3, 3)
SPANPLUS = {'name': 'SPANPlus', 'feature_channels': 48, 'blocks': (4,), 'scale': 2, 'tile': 256}  # 'ps' tail
COMPACT = {'name': 'Compact', 'num_feat': 64, 'num_conv': 16, 'scale': 4, 'tile': 256}
MOSR = {'name': 'MoSR', 'dim': 64, 'n_block': 24, 'scale': 4, 'tile': 256}  # 'ps' tail
# 'rcan 4x': the published RCAN, RCAN()'s defaults with the MeanShifts
RCAN = {'name': 'RCAN', 'n_feats': 64, 'n_resgroups': 10, 'n_resblocks': 20, 'reduction': 16, 'scale': 4,
        'tile': 256}
# 'spanpp 2x': SpanPP() serves at its base scale 2 of the scale list (1, 2, 3, 4);
# the widths are zoo.make_spanpp's choice (48 features, a 3x3 IGConv, implicit
# dim 256, four latent layers)
SPANPP = {'name': 'SpanPP', 'feature_channels': 48, 'scale': 2, 'scale_list': [1, 2, 3, 4], 'ig_kernel': 3,
          'implicit_dim': 256, 'latent_layers': 4, 'tile': 256}

# the restoration U-nets, CUGAN and the MoSR lineage (tools/bench_families.py:95-111): UpCunet2x at its fixed widths;
# the others at the zoo's stated widths, since their reference defaults are not in this repo.  'xla_gflop':
# bench_families.md's XLA count of the reference-default forward at batch 8 of 256^2 (GateRv2's and GateRV3's
# include a dense block-diagonal rewrite of their grouped convs and are not comparable)
CUGAN = {'name': 'CUGAN', 'variant': '2x', 'scale': 2, 'tile': 256, 'xla_gflop': 880.3}
GATER = {'name': 'GateR', 'dim': 64, 'num_blocks': (2, 2, 2, 4, 2, 2, 2), 'latent_att': True, 'scale': 1,
         'tile': 256, 'xla_gflop': 1226.2}
MOSRV2 = {'name': 'MoSRv2', 'dim': 64, 'n_block': 24, 'scale': 4, 'upsampler': 'pixelshuffledirect', 'tile': 256,
          'xla_gflop': 4379.5}
MOESR = {'name': 'MoESR', 'dim': 64, 'n_blocks': 6, 'n_block': 6, 'expansion': 2.5, 'scale': 4, 'tile': 256,
         'xla_gflop': 12740.9}
GATERV2 = {'name': 'GateRv2', 'dim': 32, 'enc_blocks': (2, 2, 4), 'dec_blocks': (4, 2, 2), 'num_latent': 6,
           'scale': 1, 'tile': 256, 'xla_gflop': None}
GATERV3 = {'name': 'GateRV3', 'dim': 32, 'enc_blocks': (2, 2, 4), 'dec_blocks': (4, 2, 2), 'num_latent': 4,
           'span_blocks': 4, 'attention': True, 'scale': 1, 'tile': 256, 'xla_gflop': None}
# the last eight (tools/bench_families.py:99-115) at the zoo's stated widths: their reference defaults are not in
# this repo.  'xla_gflop': bench_families.md's XLA count of the reference default at its tile and batch ('flop_tile',
# 'flop_batch'; 256 and 8 where unstated); 'dft': the count includes the JAX package's matmul DFT, which torch.fft
# replaces (the flop count then adds that DFT's FLOPs, taken at the bench tile: 'flop_size').  FlexNet serves tiled
# at the defaults (tile 256, halo 16, eight windows a batch), as the others
RTMOSR = {'name': 'RTMoSR', 'dim': 64, 'n_blocks': 2, 'scale': 2, 'tile': 256, 'xla_gflop': 142.1}
SMOSR = {'name': 'SMoSR', 'dim': 64, 'n_mb': 2, 'scale': 4, 'tile': 256, 'xla_gflop': 584.3}
RHA = {'name': 'RHA', 'dim': 64, 'down_list': (8, 4, 2, 1), 'res_blocks': 6, 'scale': 4, 'tile': 256,
       'xla_gflop': 1452.5, 'flop_tile': 192, 'flop_batch': 4}
FLEXNET = {'name': 'FlexNet', 'dim': 64, 'num_blocks': (6,) * 6, 'window_size': 8, 'hidden_rate': 4, 'scale': 4,
           'tile': 256, 'halo': 16, 'tile_batch': 8, 'xla_gflop': 957.7, 'flop_tile': 192, 'flop_batch': 4}
GFISR = {'name': 'GFISR', 'dim': 64, 'n_blocks': 24, 'scale': 4, 'tile': 256, 'xla_gflop': 4458.6, 'dft': True,
         'flop_size': 256}
GFISRV2 = {'name': 'GFISRV2', 'dim': 64, 'n_blocks': 22, 'scale': 4, 'tile': 256, 'xla_gflop': 5515.8, 'dft': True,
           'flop_size': 256}
FIGSR = {'name': 'FIGSR', 'dim': 64, 'n_blocks': 18, 'scale': 4, 'tile': 256, 'xla_gflop': 5898.5, 'dft': True,
         'flop_size': 256}
LAWFFT = {'name': 'LAWFFT', 'dim': 64, 'n_rblock': 4, 'n_mblock': 6, 'scale': 4, 'tile': 256, 'xla_gflop': 416.1,
          'dft': True, 'flop_tile': 160, 'flop_batch': 4, 'flop_size': 160}
# H100 SXM dense peaks (NVIDIA data sheet) for bound_ms
PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12

F32_TOL = 1e-4     # rtol = atol: exact f32 FMA against cuDNN f32 with TF32 off
BF16_RTOL = 2e-2   # bf16 output rounding (2^-9 relative) with margin; fp16 is held to the same
BF16_ATOL = 1e-3
MODEL_TOL = 5e-4   # tests/test_conv_archs.py's TOL for ESRGAN
SWINIR_TOL = 2e-3  # tests/test_swinir.py's TOL for transformer stacks
WATTN_BF16_ATOL = 1e-2  # window attention: P is rounded to bf16 (fp16) before P V
BF16_PSNR = 35.0   # tests/test_parallel.py's bf16-vs-f32 floor; fp16 is held to the same
MOLRCM_TOL = 1.5e-3  # x max|plain|: tests/test_pallas_ops.py's tolerance for the JAX MOLRCM kernel
ATD_TOL = HAT_TOL = 2e-3  # tests/test_atd.py's and tests/test_hat.py's TOL
DAT_TOL = RGT_TOL = DRCT_TOL = 2e-3  # tests/test_dat.py's, test_rgt.py's and test_drct.py's TOL
FDAT_TOL = OMNI_TOL = 1e-3  # tests/test_fdat.py's and tests/test_omni.py's TOL
SPANPLUS_TOL = 2e-4  # tests/test_spanplus.py's TOL; the other conv families: MODEL_TOL (test_conv_archs.py,
# test_spanpp.py, test_rcan_eimn.py, test_cugan.py, test_mosr_family.py)
GATER_TOL = 1e-3  # tests/test_gater.py's, test_gaterv2.py's and test_gaterv3.py's TOL
# test_smosr.py's, test_rha.py's, test_flexnet.py's, test_gfisr.py's, test_gfisrv2.py's, test_figsr.py's and
# test_lawfft.py's TOL; RTMoSR: MODEL_TOL (test_mosr_family.py)
LAST_EIGHT_TOL = 1e-3
GRAPH_BF16_TOL = BF16_RTOL  # x max|host loop|: the graph replays the host loop's kernels on the same inputs
GRAPH_F32_TOL = 1e-6  # tests/test_parallel.py:309-319's one-dispatch against host-loop bound
INT8_TOL = 1e-4  # x max|y|: an int8 conv on the card against the CPU on the same input codes


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
    """Each shape: kernel against its plain version in f32 (TF32 off), in
    bf16 and in fp16 (plain version in f32 from the same 16-bit inputs),
    then kernel / plain / library / bound times in bf16."""
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
        del got, want, gotb, wantb, goth, wanth, xh

        row = {'name': s['name'], 'entry': s['entry'], 'shape': [s['n'], s['h'], s['w'], s['cin'], s['cout']],
               'act': s['act'], 'max_abs_err_f32': err32, 'max_abs_err_bf16': errb, 'max_abs_err_f16': errh}
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


def lk_shapes(n: int, tile: int, pdim: int, k: int) -> list[dict]:
    """Every large-kernel conv shape of the PLKSR path (the bench forwards,
    the tiled 720p windows, the CLI's and the model phase's whole images),
    plus the kernel's other shape classes: Cin 8 / 16 / 32 / 64, Cout 8 /
    16 / 32 / 64, k 3 / 13 / 17 / 31, ragged sizes, both activations, one
    row without bias.  ``pitch`` and ``offset`` are the input's pixel pitch
    and first channel: the path hands the kernel a channel slice of the
    64-wide features.  ``path`` is the 16-bit path csrc/conv_lk.cu's plan
    gives the shape (stacked, tiles, mma)."""
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
    'masked' or 'unmasked' where all of its blocks are one or the other).
    DAT and RGT: two branches, (sp0, sp1) and (sp1, sp0) windows on half the
    channels with half the heads, padded to max(split).  DRCT: the blocks the
    kernel takes (head_dim <= 64): swin1 (embed, heads), swin2 and swin4
    (embed + gc and + 3 gc, heads - width % heads; shifted).  FDAT: the
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
        for k in (2, 4):
            width = c + (k - 1) * cfg['gc']
            out.append((f' swin{k}', (ws, ws), width, h - width % h, 'masked'))
        return ws, out
    return ws, [('', (ws, ws), c, h, 'both')]


def wattn_shapes(n_img: int, tile: int, cfg: dict, others: tuple[dict, ...]) -> list[dict]:
    """Every window-attention shape of the SwinIR-M path (the bench
    forwards, the tiled 720p windows at the loader's hints, the CLI's
    48x64 and the model phase's 64x64 images; each with the shift mask and
    without), the kernel's other shape classes (head_dim 53 and 46 among
    them, q, k and v slices of one qkv tensor; the wrapper pads heads of
    53, whose rows are only 2-byte aligned), and the same four images'
    shapes for each class of window attention (:func:`window_classes`) of
    each of ``others`` (their tiled windows come ``tile_batch`` a batch).  ``windows`` counts the window
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
    ]
    for o in others:
        pad, classes = window_classes(o)
        window = o['tile'] + 2 * o['halo']
        for label, (sh, sw), oc, oh, masks in classes:
            nm = o['name'] + label
            for name, imgs, ih, iw in (('bench', n_img, tile, tile), ('tiled window', o['tile_batch'], window, window),
                                       ('cli', 1, 48, 64), ('model', 1, 64, 64)):
                hp, wp = -(-ih // pad) * pad, -(-iw // pad) * pad
                onw, on = (hp // sh) * (wp // sw), sh * sw
                if masks != 'unmasked':
                    rows.append((f'{nm} {name} masked', imgs * onw, on, oc, oh, onw, 'random', (sh, sw), None))
                    if name == 'bench':
                        for kind in ('shift', 'zero'):
                            rows.append((f'{nm} bench {kind} mask', imgs * onw, on, oc, oh, onw, kind, (sh, sw),
                                         (hp, wp)))
                if masks != 'masked':
                    rows.append((f'{nm} {name}', imgs * onw, on, oc, oh, None, None, (sh, sw), None))
    keys = ('name', 'windows', 'n', 'c', 'heads', 'nw', 'mask', 'split', 'image')
    return [dict(zip(keys, r), zero_bias=r[0].startswith('FlexNet')) for r in rows]


def wattn_timed_rows(shapes: list[dict]) -> dict:
    """For each ``window_mha.by_shape`` key, the index of the row whose time
    stands for the main path's launches at that key: the 'shift' row where
    there is one (the path's masks are shift masks), else the first."""
    best: dict = {}
    for i, s in enumerate(shapes):
        key = wattn_shape_key(s)
        if key not in best or (s['mask'] == 'shift' and shapes[best[key]]['mask'] != 'shift'):
            best[key] = i
    return best


def wattn_shape_key(s: dict) -> tuple:
    """The key under which ``window_mha.by_shape`` counts ``s``."""
    return (s['windows'], s['n'], s['c'], s['heads'], s['nw'] is not None)


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


def time_plain_attentions(device, per_forward: dict, reps: int) -> list[dict]:
    """The window attentions the kernel does not take, as the bench forwards
    sent them to the plain path (``per_forward``: launches per forward by
    ``multi_head_attention.plain_by_shape`` key, unmasked, M = N): per shape
    in bf16, q, k, v slices of one qkv tensor and a random bias, the plain
    path's time, the library call's (``scaled_dot_product_attention``,
    bias as its bf16 mask) and the bound."""
    import torch
    import torch.nn.functional as TF

    from resselt_tpu_torch.nn.window import _mha_plain

    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for (w, n, m, c, h, masked), count in sorted(per_forward.items()):
        if masked or m != n:
            raise AssertionError(f'plain-path timing takes unmasked M = N attentions, got {(w, n, m, c, h, masked)}')
        hd = c // h
        qkv = torch.randn((w, n, 3 * c), generator=gen, device=device).to(torch.bfloat16)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        bias = torch.randn((h, n, n), generator=gen, device=device) * 0.5
        q4, k4, v4 = (t.unflatten(-1, (h, hd)).transpose(1, 2) for t in (q, k, v))
        am = bias.to(torch.bfloat16)[None]
        row = {'windows': w, 'n': n, 'c': c, 'heads': h, 'head_dim': hd, 'per_forward': count}
        row['plain_ms'] = _ms(lambda: _mha_plain(q, k, v, h, hd ** -0.5, bias, None), reps)
        row['library_ms'] = _ms(lambda: TF.scaled_dot_product_attention(q4, k4, v4, attn_mask=am, scale=hd ** -0.5),
                                reps)
        row['bound_ms'], row['bound_by'] = wattn_bound_ms({'windows': w, 'n': n, 'c': c, 'heads': h, 'nw': None},
                                                          'bfloat16')
        del qkv, q, k, v, q4, k4, v4, am, bias
        torch.cuda.empty_cache()
        out.append(row)
    return out


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


def phase_wattn_kernels(device, shapes: list[dict], reps: int) -> list[dict]:
    """Each shape: the window-attention kernel against its plain version in
    f32 (TF32 off), in bf16 and in fp16 (plain version in f32 from the same
    16-bit inputs), with q, k, v handed over as slices of one qkv tensor as
    the model does and a random f32 bias; then kernel / plain / library / bound times in bf16 (f32
    times too at the bench shape).  The library call is
    ``scaled_dot_product_attention`` with bias + mask summed into one bf16
    additive mask (materialised per window where masked)."""
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
        if s['name'] == 'bench masked':
            q32, k32, v32 = (t.float() for t in (qb, kb, vb))
            row['ms_f32'] = _ms(lambda: wa.window_mha(q32, k32, v32, bias, mask, num_heads=h, scale=scale), reps)
            row['bound_ms_f32'] = wattn_bound_ms(counted, 'float32')[0]
            del q32, k32, v32
        del qkvb, qb, kb, vb, q4, k4, v4, am, bias, mask
        torch.cuda.empty_cache()
        out.append(row)
    return out


def molrcm_shapes(n_img: int, tile: int, cfg: dict) -> list[dict]:
    """Every MOLRCM shape of the EIMN path (the bench forwards, the tiled
    720p windows at the default tile and halo, the CLI's 48x64 and the
    model phase's 64x64 images), and the edges of the 16-bit kernel's
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


def molrcm_shape_keys(s: dict) -> set:
    """The keys under which ``fused_molrcm.by_shape`` counts ``s``, in both
    dtypes."""
    return {('molrcm', (s['n'], s['h'], s['w'], s['dim'], d)) for d in ('float32', 'bfloat16')}


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
    CLI's 48x64 image in bf16; the model phase's 64x64 image in f32 too),
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


def gather_shape_key(s: dict) -> tuple:
    """The key under which ``row_gather.by_shape`` counts ``s``."""
    return (s['rows_out'], s['rows_src'], s['width'], s['dtype'])


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


def atd_category_flips(model_a, model_b, x, dtype_b=None) -> tuple[int, int]:
    """How many tokens AC_MSA sorts into another category in ``model_b`` (on
    its device, in ``dtype_b``) than in ``model_a`` (f32) at the first ATD
    layer, of how many: the argmax of the port's own ``_atd_ca`` similarity
    on that layer's input."""
    import torch

    from resselt_tpu_torch.archs import atd
    from resselt_tpu_torch.nn.params import PTree

    ids = []
    for model, dtype in ((model_a, torch.float32), (model_b, dtype_b or torch.float32)):
        cfg = model.config
        p = PTree(model.weights(dtype))
        with torch.no_grad():
            xin = torch.as_tensor(x).to(model.device, dtype)
            feat = p.conv('conv_first', xin - torch.tensor(atd._RGB_MEAN, dtype=dtype, device=model.device), padding=1)
            feat = feat.reshape(feat.shape[0], -1, cfg.embed_dim)
            g = p.sub('layers.0.residual_group')
            td = g['td'].to(dtype)[None].expand(feat.shape[0], -1, -1)
            lp = g.sub('layers.0')
            _, sim = atd._atd_ca(lp.sub('attn_atd'), lp.layer_norm('norm1', feat), td, cfg.num_tokens)
        ids.append(torch.argmax(sim, dim=-1).cpu())
    return int((ids[0] != ids[1]).sum()), ids[0].numel()


def phase_load(device, sd: dict, stem: str, arch: str, meta, tmp: str, dropped: frozenset = frozenset(),
               expect: dict | None = None):
    """Write a seeded checkpoint as .safetensors and .pth, load both; the
    params are the checkpoint's arrays less the ``dropped`` keys, or, for a
    loader that transforms them (collapsed reparameterizations), equal to
    ``expect``."""
    import numpy as np
    import torch

    import resselt_tpu_torch
    from resselt_tpu_torch.io import write_safetensors

    st = os.path.join(tmp, f'{stem}.safetensors')
    pth = os.path.join(tmp, f'{stem}.pth')
    write_safetensors(sd, st)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    models = [resselt_tpu_torch.load_from_file(p, device=device) for p in (st, pth)]
    for m in models:
        if m.arch_id != arch or m.metadata != meta:
            raise AssertionError(f'detected {m.arch_id} {m.metadata}')
        if expect is not None:
            if set(m.params) != set(expect) or not all(np.array_equal(m.params[k].cpu().numpy(), expect[k])
                                                       for k in expect):
                raise AssertionError(f'params differ from the expected ones: {sorted(set(m.params) ^ set(expect))}')
            continue
        if set(sd) - set(m.params) != dropped:
            raise AssertionError(f'params lack {sorted(set(sd) - set(m.params))}, expected {sorted(dropped)}')
        for k in m.params:
            if not np.array_equal(m.params[k].cpu().numpy(), sd[k]):
                raise AssertionError(f'{k} differs after load')
    return models[0], st


def phase_model(model, sd, size: int, entry, bf16: bool = True, tol: float = MODEL_TOL):
    """f32 on the card against the CPU, ``entry``'s launches in that
    forward (``entry``: a kernel wrapper, or a tuple of them for a list of
    counts) and the window attentions it sent to the plain path, bf16 and
    fp16 against f32."""
    import numpy as np
    import torch

    import resselt_tpu_torch
    from resselt_tpu_torch.nn.window import multi_head_attention

    x = np.random.default_rng(0).random((1, size, size, 3), dtype=np.float32)
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    want = cpu(x).numpy()
    entries = entry if isinstance(entry, tuple) else (entry,)
    before = [e.launches for e in entries]
    plain_before = multi_head_attention.plain_calls
    got32 = model(x)
    torch.cuda.synchronize()
    launches = [e.launches - b for e, b in zip(entries, before)]
    if not isinstance(entry, tuple):
        launches = launches[0]
    err = float(np.abs(got32.cpu().numpy() - want).max())
    if got32.shape != want.shape or not err < tol:
        raise AssertionError(f'f32 card vs cpu: shape {tuple(got32.shape)} vs {want.shape}, max err {err}')
    res = {'max_abs_err_f32': err, 'launches_per_forward': launches,
           'plain_attentions_per_forward': multi_head_attention.plain_calls - plain_before}
    if bf16:
        gotb = model(x, dtype=torch.bfloat16).float()
        mse = float(((gotb - got32) ** 2).mean())
        psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
        if not psnr > BF16_PSNR:
            raise AssertionError(f'bf16 vs f32 PSNR {psnr:.2f} dB')
        res['bf16_psnr_db'] = round(psnr, 2)
        goth = model(x, dtype=torch.float16).float()
        psnr = 10 * np.log10(1.0 / max(float(((goth - got32) ** 2).mean()), 1e-12))
        if not psnr > BF16_PSNR:
            raise AssertionError(f'fp16 vs f32 PSNR {psnr:.2f} dB')
        res['fp16_psnr_db'] = round(psnr, 2)
        gotp = model(x, precision='bfloat16')  # f32 inputs, bf16 passes allowed in the plain torch ops
        psnr = 10 * np.log10(1.0 / max(float(((gotp - got32) ** 2).mean()), 1e-12))
        if gotp.dtype != torch.float32 or not psnr > BF16_PSNR:
            raise AssertionError(f"precision='bfloat16' vs f32 PSNR {psnr:.2f} dB, dtype {gotp.dtype}")
        res['precision_bfloat16_psnr_db'] = round(psnr, 2)
    return res


def _entries() -> dict:
    """Every kernel wrapper, by the name its counts are reported under."""
    from resselt_tpu_torch.ops import fused_conv as fc
    from resselt_tpu_torch.ops import molrcm as mo
    from resselt_tpu_torch.ops import row_gather
    from resselt_tpu_torch.ops import window_attention as wa

    return {'act': fc.fused_conv3x3_act, 'pack2': fc.fused_conv3x3_pack2, 'lk': fc.fused_conv_lk,
            'wattn': wa.window_mha, 'molrcm': mo.fused_molrcm, 'gather': row_gather}


def _launch_counts() -> dict:
    """Every kernel wrapper's launches and the plain-path window attentions,
    by name."""
    from resselt_tpu_torch.nn.window import multi_head_attention

    return {**{k: e.launches for k, e in _entries().items()}, 'plain_attention': multi_head_attention.plain_calls}


# the source each wrapper launches its kernels from, by the name its counts are reported under
SOURCE_OF = {'act': 'conv3x3', 'pack2': 'conv3x3', 'lk': 'conv_lk', 'wattn': 'window_attn', 'molrcm': 'molrcm',
             'gather': 'row_gather'}


def kernel_symbols() -> dict:
    """Every ``__global__`` function of resselt_tpu_torch/csrc/*.cu, to its
    source's stem."""
    import re

    pattern = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(')
    csrc = os.path.join(HERE, 'resselt_tpu_torch', 'csrc')
    out = {}
    for name in sorted(os.listdir(csrc)):
        if name.endswith('.cu'):
            with open(os.path.join(csrc, name)) as f:
                out.update({sym: name[:-3] for sym in pattern.findall(f.read())})
    return out


def graph_kernel_counts(graph) -> dict:
    """The kernels of csrc/ among a captured CUDA graph's kernel nodes, by
    source stem: a replay launches each node once, so these are what a
    replay launches, which no Python counter sees.  Read from the graph's
    ``cudaGraph_t`` (``TiledProgram`` captures with ``keep_graph=True``)
    through the driver API: ``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams`` and ``cuFuncGetName`` (or
    ``cuKernelGetName`` for a node that names a library kernel).  A kernel is
    known by its symbol, mangled (``<length>name``) or demangled."""
    import ctypes
    import re

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [('func', ctypes.c_void_p), ('grid', ctypes.c_uint * 3), ('block', ctypes.c_uint * 3),
                    ('shared_mem_bytes', ctypes.c_uint), ('kernel_params', ctypes.c_void_p),
                    ('extra', ctypes.c_void_p), ('kern', ctypes.c_void_p), ('ctx', ctypes.c_void_p)]

    cu = ctypes.CDLL('libcuda.so.1')

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f'{what} failed: CUresult {rc}')

    graph_t = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph_t, None, ctypes.byref(n)), 'cuGraphGetNodes')
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph_t, nodes, ctypes.byref(n)), 'cuGraphGetNodes')
    symbols = kernel_symbols()
    patterns = [(re.compile(rf'{len(s)}{s}|(?<![\w]){s}(?=[<(]|$)'), src) for s, src in symbols.items()]
    counts: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), 'cuGraphNodeGetType')
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              'cuGraphKernelNodeGetParams')
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)), 'cuFuncGetName')
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)), 'cuKernelGetName')
        text = name.value.decode()
        for pat, src in patterns:
            if pat.search(text):
                counts[src] = counts.get(src, 0) + 1
                break
    return counts


def by_source(counts: dict) -> dict:
    """Wrapper launch counts (:func:`_launch_counts`) summed by source."""
    out: dict[str, int] = {}
    for k, v in counts.items():
        if k in SOURCE_OF and v:
            out[SOURCE_OF[k]] = out.get(SOURCE_OF[k], 0) + v
    return out


def phase_tiled(model, img, tile: int | None, dtype, tol: float, reps: int = 3, relative: bool = True) -> dict:
    """One image through upscale_tiled both ways: the host loop
    (``on_device=False``), timed cold and warm, and the graph path (the
    default), timed at its first call (warm-up run, capture and one replay)
    and at steady state (median of ``reps`` calls, each one replay).
    Launches: the wrappers count the host loop's (per image), and must
    count twice that at the graph's first call (the warm-up run and the
    capture, whose launch calls record the graph) and nothing at a steady
    call (a replay runs no Python: no host loop behind it).  What a replay
    launches is read from the graph itself: its kernel nodes of each source
    (:func:`graph_kernel_counts`) must equal the host loop's launches of
    that source.  Fails on any of these, if a steady call ran no replay, or if
    the outputs differ by more than ``tol`` x max|host loop|
    (``relative``) or ``tol``.  Memory: the peak allocated by the host loop
    and by the graph's first call (the warm-up run and the capture), and
    what the cached graph keeps reserved (its share of the model's graph
    pool and its static tensors: a replay allocates nothing, so no peak sees
    it).  The programs are released at the end."""
    import numpy as np
    import torch

    from resselt_tpu_torch.parallel import upscale_tiled

    def run(on_device):
        torch.cuda.synchronize()
        c0, t0 = _launch_counts(), time.perf_counter()
        out = upscale_tiled(model, img, tile=tile, dtype=dtype, on_device=on_device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return out, dt, {k: v - c0[k] for k, v in _launch_counts().items() if v != c0[k]}

    torch.cuda.reset_peak_memory_stats()
    _, host_first_s, host_counts = run(False)
    host, host_s, counts = run(False)
    host_peak = torch.cuda.max_memory_allocated()
    if counts != host_counts:
        raise AssertionError(f'host loop launches {counts}, then {host_counts}')
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    first, first_s, first_counts = run(None)
    first_peak = torch.cuda.max_memory_allocated()
    if first_counts != {k: 2 * v for k, v in host_counts.items()}:
        raise AssertionError(f'graph first call (warm-up and capture) launches {first_counts}, '
                             f'host loop {host_counts}')
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_reserved() - reserved
    cache = model.__dict__['_tiled_fn_cache']
    program = next(reversed(cache.values()))
    times = []
    for _ in range(reps):
        out, dt, counts = run(None)
        times.append(dt)
        if counts:
            raise AssertionError(f'a replay moved the wrapper counts: {counts}')
    if program.graph is None or program.replays != reps + 1:
        raise AssertionError(f'the graph path ran {program.replays} replays in {reps + 1} calls')
    replay = graph_kernel_counts(program.graph)
    if replay != by_source(host_counts):
        raise AssertionError(f'kernels per replay (graph nodes) {replay}, host loop launches {host_counts}')
    scale = float(host.float().abs().max()) if relative else 1.0
    err = max(float((o.float() - host.float()).abs().max()) for o in (first, out))
    if out.shape != host.shape or not bool(torch.isfinite(out).all()) or not err <= tol * scale:
        raise AssertionError(f'graph vs host loop: shape {tuple(out.shape)} vs {tuple(host.shape)}, '
                             f'max err {err} (bound {tol} x {scale})')
    for p in cache.values():
        p.release()
    cache.clear()
    return {'tiled_s': float(np.median(times)), 'tiled_host_s': host_s, 'tiled_host_first_s': host_first_s,
            'tiled_graph_first_s': first_s,
            'tiled_graph_vs_host_max_abs': err, 'tiled_launches_per_image': json.dumps(host_counts),
            'tiled_kernels_per_replay': json.dumps(replay), 'tiled_host_peak_gb': round(host_peak / 1e9, 3),
            'tiled_graph_first_peak_gb': round(first_peak / 1e9, 3),
            'tiled_graph_resident_gb': round(resident / 1e9, 3), 'tiled_shape': list(out.shape)}


def phase_serve(model, ckpt: str, tmp: str, batch: int, tile: int, timed_reps: int, img_hw: tuple[int, int],
                tiled_tile: int | None = None):
    """The main path: the bench config through SRModel.__call__, a tiled
    image through upscale_tiled both ways (:func:`phase_tiled`: the host
    loop and the default graph path, at ``tiled_tile``, or the loader's
    hints when None), and a PNG through the CLI.  Every kernel's launch count
    starts from 0 just before the timed bench forwards; their counts are
    read just after them (``bench_counts``, and per kernel path
    ``bench_paths`` for the wrappers that have several; ``bench_plain``: the
    window attentions sent to the plain path, in total and per shape), and
    the whole phase's at its end (``launches``, and per shape ``shapes``).
    ``peak_memory_gb``: the phase's peak device memory."""
    import numpy as np
    import torch

    from resselt_tpu_torch import upscale
    from resselt_tpu_torch.nn.window import multi_head_attention

    entries = _entries()
    res = {}
    torch.cuda.reset_peak_memory_stats()
    x = torch.rand((batch, tile, tile, 3), generator=torch.Generator().manual_seed(1)).to(model.device)
    for _ in range(2):
        y = model(x, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    for e in entries.values():
        e.launches = 0
        e.by_shape.clear()
        if hasattr(e, 'by_path'):
            e.by_path.clear()
    multi_head_attention.plain_calls = 0
    multi_head_attention.plain_by_shape.clear()
    t0 = time.perf_counter()
    for _ in range(timed_reps):
        y = model(x, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed_reps
    res['bench_counts'] = {k: (e.launches, dict(e.by_shape)) for k, e in entries.items()}
    res['bench_paths'] = {k: dict(e.by_path) for k, e in entries.items() if hasattr(e, 'by_path')}
    res['bench_plain'] = (multi_head_attention.plain_calls, dict(multi_head_attention.plain_by_shape))
    s = model.metadata.upscale
    if y.shape != (batch, tile * s, tile * s, 3) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f'bench forward: shape {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}')
    res['bench_ms_per_forward'] = dt * 1e3
    res['bench_mp_per_s'] = batch * (tile * s) ** 2 / 1e6 / dt
    del x, y

    h, w = img_hw
    img = np.random.default_rng(2).random((h, w, 3), dtype=np.float32)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    res.update(phase_tiled(model, img, tiled_tile, torch.bfloat16, GRAPH_BF16_TOL))
    if tuple(res['tiled_shape']) != (h * s, w * s, 3):
        raise AssertionError(f"tiled: shape {res['tiled_shape']}")

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
    res['shapes'] = {k: set(e.by_shape) for k, e in entries.items()}
    peak = max(peak, torch.cuda.max_memory_allocated(), *(res[k] * 1e9 for k in (
        'tiled_host_peak_gb', 'tiled_graph_first_peak_gb')))
    res['peak_memory_gb'] = round(peak / 1e9, 2)
    return res


# distinct 720p-class image sizes for the graph pool check: each its own grid, a few windows apart
POOL_SIZES = ((720, 1280), (768, 1152), (800, 1216), (864, 1088))
POOL_GROWTH = 1.5  # x the first size's: one pool a model holds the largest capture's intermediates once


def graph_pool_sizes(model, sizes, dtype) -> dict:
    """Distinct image sizes through one model's graph path, in order: the
    first call's seconds for each, and the device memory that the cached
    programs keep reserved after each (after ``empty_cache``, above what was
    reserved before).  The programs of a model share one graph pool, so
    serving more sizes adds their static canvases, not a replay's
    intermediates each: fails if the last figure exceeds POOL_GROWTH x the
    first.  The programs are released at the end."""
    import numpy as np
    import torch

    from resselt_tpu_torch.parallel import upscale_tiled

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    first_s, kept_gb = [], []
    for i, (h, w) in enumerate(sizes):
        x = np.random.default_rng(10 + i).random((h, w, 3), dtype=np.float32)
        t0 = time.perf_counter()
        upscale_tiled(model, x, dtype=dtype)
        torch.cuda.synchronize()
        first_s.append(time.perf_counter() - t0)
        torch.cuda.empty_cache()
        kept_gb.append(round((torch.cuda.memory_reserved() - base) / 1e9, 3))
    cache = model.__dict__['_tiled_fn_cache']
    if len(cache) != len(sizes) or not kept_gb[-1] <= POOL_GROWTH * kept_gb[0]:
        raise AssertionError(f'{len(cache)} programs for {len(sizes)} sizes keep {kept_gb} GB')
    for p in cache.values():
        p.release()
    cache.clear()
    torch.cuda.empty_cache()
    return {'sizes': [list(hw) for hw in sizes], 'first_call_s': first_s, 'graphs_keep_gb': kept_gb,
            'all_released_gb': round((torch.cuda.memory_reserved() - base) / 1e9, 3)}


def phase_graph() -> dict:
    """The graph path's own checks.  (1) f32, TF32 off: the graph output
    within 1e-6 of the host loop (tests/test_parallel.py's bound) for
    ESRGAN, PLKSR, SwinIR-M, EIMN_L, ATD-light and LAWFFT at their serve
    configs on a 320 x 480 image at their f32 hints: the five CUDA sources
    and cuFFT under capture.  (2) Nine image sizes through one model (SPAN
    4x, bf16, tile 128): the LRU keeps eight programs and frees the evicted
    one's graph; device memory with eight graphs, after the eviction, and
    after all are released.  (3) ``bucket=True``: three sizes that pad to one
    bucket share one program (three replays of one graph).  (4) RHA, bf16,
    at its hints: four distinct 720p-class sizes, the memory their graphs
    keep (:func:`graph_pool_sizes`)."""
    import numpy as np
    import torch

    import resselt_tpu_torch
    from resselt_tpu_torch.parallel import upscale_tiled
    from resselt_tpu_torch.zoo import (make_atd, make_eimn, make_esrgan, make_lawfft, make_plksr, make_rha, make_span,
                                      make_swinir)

    at, ei, sw, lw = ATD, EIMN, SWINIR, LAWFFT
    builders = {
        'ESRGAN': lambda: make_esrgan(BENCH['num_filters'], BENCH['num_blocks'], BENCH['scale'], seed=0),
        'PLKSR': lambda: make_plksr(PLKSR['dim'], PLKSR['n_blocks'], PLKSR['scale'], PLKSR['kernel_size'], seed=0),
        'SwinIR-M': lambda: make_swinir(sw['embed_dim'], sw['depths'], sw['num_heads'], sw['window_size'],
                                        upscale=sw['scale'], img_size=sw['img_size'], seed=0),
        'EIMN_L': lambda: make_eimn(ei['embed_dims'], ei['num_stages'], ei['depths'], ei['mlp_ratio'], ei['scale'],
                                    seed=0),
        'ATD-light': lambda: make_atd(at['embed_dim'], at['depths'], at['num_heads'], at['window_size'],
                                      at['num_tokens'], at['reducted_dim'], at['convffn_kernel_size'], at['mlp_ratio'],
                                      at['scale'], seed=0),
        'LAWFFT': lambda: make_lawfft(lw['dim'], lw['n_rblock'], lw['n_mblock'], lw['scale'], seed=0),
    }
    img = np.random.default_rng(4).random((320, 480, 3), dtype=np.float32)
    res = {}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, build in builders.items():
            model = resselt_tpu_torch.load_from_state_dict(build(), device='cuda')
            r = phase_tiled(model, img, None, torch.float32, GRAPH_F32_TOL, reps=1, relative=False)
            res[name] = {k: r[k] for k in ('tiled_graph_vs_host_max_abs', 'tiled_kernels_per_replay', 'tiled_s',
                                           'tiled_host_s', 'tiled_graph_first_s')}
            del model
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    out = {'f32_graph_vs_host': json.dumps(res)}

    model = resselt_tpu_torch.load_from_state_dict(make_span(SPAN['feature_channels'], SPAN['scale'], seed=0),
                                                   device='cuda')
    sizes = [(300 + 8 * i, 400) for i in range(9)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    programs, mem = [], {'before_graphs': (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())}
    for i, (h, w) in enumerate(sizes):
        x = np.random.default_rng(i).random((h, w, 3), dtype=np.float32)
        upscale_tiled(model, x, tile=128, dtype=torch.bfloat16)
        programs.append(next(reversed(model.__dict__['_tiled_fn_cache'].values())))
        torch.cuda.synchronize()
        if i == 7:
            mem['with_8_graphs'] = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    cache = model.__dict__['_tiled_fn_cache']
    mem['after_eviction'] = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    if len(cache) != 8 or programs[0].graph is not None or any(p.graph is None for p in programs[1:]):
        raise AssertionError(f'LRU: {len(cache)} programs, first graph {programs[0].graph}')
    for p in cache.values():
        p.release()
    cache.clear()
    torch.cuda.synchronize()
    mem['all_released'] = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    torch.cuda.empty_cache()
    mem['after_empty_cache'] = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    out['lru_sizes'] = len(sizes)
    out['lru_programs'] = 8
    out['device_memory_gb_allocated_reserved'] = json.dumps(
        {k: [round(a / 1e9, 3), round(r / 1e9, 3)] for k, (a, r) in mem.items()})

    for h, w in ((300, 400), (290, 390), (320, 420)):
        x = np.random.default_rng(h).random((h, w, 3), dtype=np.float32)
        y = upscale_tiled(model, x, tile=128, dtype=torch.bfloat16, bucket=True)
        if tuple(y.shape) != (4 * h, 4 * w, 3):
            raise AssertionError(f'bucket: shape {tuple(y.shape)}')
    (program,) = cache.values()
    if program.replays != 3:
        raise AssertionError(f'bucket: {len(cache)} programs, {program.replays} replays')
    out['bucket_sizes_one_program_replays'] = program.replays
    del model
    torch.cuda.empty_cache()

    rh = RHA
    model = resselt_tpu_torch.load_from_state_dict(
        make_rha(rh['dim'], rh['scale'], down_list=rh['down_list'], res_blocks=rh['res_blocks'], seed=0), device='cuda')
    out['rha_sizes_bf16'] = json.dumps(graph_pool_sizes(model, POOL_SIZES, torch.bfloat16))
    del model
    torch.cuda.empty_cache()
    return out


def _int8_card_vs_cpu(sd: dict) -> tuple:
    """One int8 model on the card against the CPU, f32, TF32 off, on a
    1 x 64 x 64 image.  Every int8 conv the card's forward ran is run again
    on the CPU on the same input, weights and scales: within
    INT8_TOL x max|y| (the same codes, an exact int32 sum).  The whole
    forwards only agree to the int8 model's own sensitivity: the dynamic
    activation quant turns a last-bit difference upstream of an int8 conv
    (the card's kernels sum in another order than the CPU's) into a flipped
    code; their PSNR, and the PSNR of int8 against float, must exceed 35 dB
    (the repo's floor for a lossy serving mode).  Returns the figures, the
    float model and the int8 model on the card."""
    import numpy as np
    import torch

    import resselt_tpu_torch
    from resselt_tpu_torch import metrics
    from resselt_tpu_torch.nn import functional as F

    model = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    q = model.quantize_int8()
    q_cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu').quantize_int8()
    x = np.random.default_rng(5).random((1, 64, 64, 3), dtype=np.float32)
    calls, real = [], F.conv2d_int8

    def recording(x_, w8, scale, b=None, **kw):
        y = real(x_, w8, scale, b, **kw)
        calls.append((x_.cpu(), w8.cpu(), scale.cpu(), None if b is None else b.cpu(), kw, y.cpu()))
        return y

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    F.conv2d_int8 = recording
    try:
        y_card = q(x).cpu()
    finally:
        F.conv2d_int8 = real
    y_float = model(x).cpu()
    torch.backends.cudnn.allow_tf32 = saved
    y_cpu = q_cpu(x)
    worst = 0.0
    for x_, w8, scale, b, kw, y in calls:
        want = real(x_, w8, scale, b, **kw)
        err = float((y - want).abs().max()) / max(float(want.abs().max()), 1e-12)
        worst = max(worst, err)
    if not calls or not worst <= INT8_TOL:
        raise AssertionError(f'{len(calls)} int8 convs, worst card vs cpu {worst} x max|y|')
    res = {'int8_convs': sum(v.dtype == torch.int8 for v in q.params.values()),
           'int8_conv_calls_per_forward': len(calls), 'per_conv_card_vs_cpu_max_rel': worst,
           'forward_card_vs_cpu_max_abs': float((y_card - y_cpu).abs().max()),
           'forward_card_vs_cpu_psnr_db': round(metrics.psnr(y_card, y_cpu), 2),
           'int8_vs_float_psnr_db_card': round(metrics.psnr(y_card, y_float), 2),
           'int8_vs_float_psnr_db_cpu': round(metrics.psnr(y_cpu, resselt_tpu_torch.load_from_state_dict(
               sd, device='cpu')(x)), 2)}
    if not min(res['forward_card_vs_cpu_psnr_db'], res['int8_vs_float_psnr_db_card'],
               res['int8_vs_float_psnr_db_cpu']) > BF16_PSNR:
        raise AssertionError(f'int8 PSNR under {BF16_PSNR} dB: {res}')
    return res, model, q


def phase_int8() -> dict:
    """int8 serving: ESRGAN-23 at the bench config quantized (its int8
    convs), held card against CPU (:func:`_int8_card_vs_cpu`), its bench
    forward's ms in bf16 against the float model's (recorded, not a gate),
    and its tiled 720p image through the graph path against the host loop,
    then four distinct 720p-class sizes (:func:`graph_pool_sizes`);
    Compact and SPAN (JAX's test families) and CUGAN (whose transposed convs
    stay float) card against CPU."""
    import torch

    from resselt_tpu_torch.zoo import make_compact, make_cugan, make_esrgan, make_span

    res, model, q = _int8_card_vs_cpu(make_esrgan(BENCH['num_filters'], BENCH['num_blocks'], BENCH['scale'], seed=0))
    out = {'ESRGAN': res}
    x = torch.rand((BENCH['batch'], BENCH['tile'], BENCH['tile'], 3),
                   generator=torch.Generator().manual_seed(1)).to('cuda')
    for name, m in (('bf16', model), ('int8', q), ('bf16_again', model), ('int8_again', q)):
        m(x, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            y = m(x, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        res[f'bench_ms_{name}'] = (time.perf_counter() - t0) / 3 * 1e3
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f'{name} bench forward is not finite')
    del x, y
    import numpy as np

    img = np.random.default_rng(2).random((720, 1280, 3), dtype=np.float32)
    t = phase_tiled(q, img, BENCH['tile'], torch.bfloat16, GRAPH_BF16_TOL)
    res.update({f'int8_{k}': t[k] for k in ('tiled_s', 'tiled_host_s', 'tiled_graph_first_s',
                                            'tiled_graph_vs_host_max_abs', 'tiled_graph_resident_gb')})
    res['int8_sizes_bf16'] = graph_pool_sizes(q, POOL_SIZES, torch.bfloat16)
    del model, q
    torch.cuda.empty_cache()
    for name, sd in (('Compact', make_compact(seed=0)), ('SPAN', make_span(seed=0)), ('CUGAN', make_cugan('2x', seed=0))):
        out[name] = _int8_card_vs_cpu(sd)[0]
    torch.cuda.empty_cache()
    return out


def phase_cache_tools(tmp: str) -> dict:
    """The cache and the tools on the card: ESRGAN-23 converted to ``.npz``
    and ``.safetensors``; the ``.npz`` model loaded on the card gives the
    checkpoint-loaded model's output bit for bit (bf16, 2 x 128^2); ``inspect
    --json``; the CLI on the ``.npz`` model over a directory of three PNGs
    (background I/O) with ``--int8``, ``--tile 64`` (the int8 model through
    the graph path) and ``--trace``, whose trace file must exist."""
    import contextlib
    import io

    import numpy as np
    import torch
    from PIL import Image

    import resselt_tpu_torch
    from resselt_tpu_torch import convert, inspect, upscale
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.zoo import make_esrgan

    sd = make_esrgan(BENCH['num_filters'], BENCH['num_blocks'], BENCH['scale'], seed=0)
    ckpt, npz, st = (os.path.join(tmp, f) for f in ('m.safetensors', 'm.npz', 'converted.safetensors'))
    write_safetensors(sd, ckpt)
    t0 = time.perf_counter()
    if convert.main([ckpt, npz]) != 0 or convert.main([ckpt, st]) != 0:
        raise AssertionError('convert failed')
    res = {'convert_s': time.perf_counter() - t0}
    t0 = time.perf_counter()
    cached = resselt_tpu_torch.load_model(npz)
    res['load_npz_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = resselt_tpu_torch.load_from_file(ckpt)
    res['load_checkpoint_s'] = time.perf_counter() - t0
    exported = resselt_tpu_torch.load_from_file(st)
    x = torch.rand((2, 128, 128, 3), generator=torch.Generator().manual_seed(6)).to('cuda')
    want = model(x, dtype=torch.bfloat16)
    for name, m in (('npz', cached), ('safetensors', exported)):
        if not torch.equal(m(x, dtype=torch.bfloat16), want) or m.serving_halo != model.serving_halo:
            raise AssertionError(f'the {name} model differs from the checkpoint-loaded one')
    res['npz_output_bit_identical'] = True
    del cached, exported, model, x, want
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = inspect.main([npz, '--json', '--size', '64', '64'])
    info = json.loads(buf.getvalue())
    if rc != 0 or info['arch'] != 'ESRGAN' or info['params'] != sum(v.size for v in sd.values()) or \
            not info['cost_at_size']['gflops'] > 0:
        raise AssertionError(f'inspect: {info}')
    res['inspect'] = json.dumps(info['cost_at_size'])
    indir, outdir, trace = (os.path.join(tmp, d) for d in ('in', 'out', 'trace'))
    os.makedirs(indir)
    for i in range(3):
        Image.fromarray((np.random.default_rng(i).random((96, 128, 3)) * 255).astype(np.uint8)).save(
            os.path.join(indir, f'{i}.png'))
    t0 = time.perf_counter()
    rc = upscale.main([npz, indir, outdir, '--int8', '--bf16', '--tile', '64', '--trace', trace])
    res['cli_int8_trace_s'] = time.perf_counter() - t0
    outs = sorted(os.listdir(outdir)) if os.path.isdir(outdir) else []
    sizes = {Image.open(os.path.join(outdir, f)).size for f in outs}
    trace_file = os.path.join(trace, 'resselt_tpu_torch.trace.json')
    if rc != 0 or len(outs) != 3 or sizes != {(512, 384)} or not os.path.isfile(trace_file):
        raise AssertionError(f'cli: rc {rc}, outputs {outs} {sizes}, trace {os.listdir(trace) if os.path.isdir(trace) else None}')
    res['cli_trace_mb'] = round(os.path.getsize(trace_file) / 1e6, 2)
    torch.cuda.empty_cache()
    return res


# a directory of photos in ten sizes, none padding to another's grid (the CLI over mixed sizes)
CLI_SIZES = ((320, 480), (336, 512), (360, 540), (384, 576), (400, 600), (420, 640), (448, 672), (480, 720),
             (512, 768), (540, 810))


def phase_cli_sizes(tmp: str) -> dict:
    """A directory of photos in ten sizes, bf16 at the loader's hints, for
    ATD-light (the family whose host loop leaves the card most idle) and
    ESRGAN-23 (the card busy).  First the library: the ten images through
    ``upscale_tiled`` on the host loop and on the graph path, which pays a
    warm-up run and a capture for every size (seconds for the ten, the
    model loaded once).  Then the CLI over the ten as JPEGs (``--tile
    auto``), which sends a size of its own to the host loop and sizes that
    inputs share to the graph: as they are (all ten on the host loop) and
    with ``--bucket`` (ATD-light's 160 tiles pad them into five sizes,
    ESRGAN's 256 into three).  Each CLI run loads the model anew.
    Recorded, not a gate; every output must have its size."""
    import numpy as np
    import torch
    from PIL import Image

    import resselt_tpu_torch
    from resselt_tpu_torch import upscale
    from resselt_tpu_torch.io import write_safetensors
    from resselt_tpu_torch.parallel import upscale_tiled
    from resselt_tpu_torch.zoo import make_atd, make_esrgan

    at = ATD
    builders = {
        'ATD-light': lambda: make_atd(at['embed_dim'], at['depths'], at['num_heads'], at['window_size'],
                                      at['num_tokens'], at['reducted_dim'], at['convffn_kernel_size'], at['mlp_ratio'],
                                      at['scale'], seed=0),
        'ESRGAN': lambda: make_esrgan(BENCH['num_filters'], BENCH['num_blocks'], BENCH['scale'], seed=0),
    }
    indir = os.path.join(tmp, 'sizes')
    os.makedirs(indir)
    imgs = [(np.random.default_rng(20 + i).random((h, w, 3)) * 255).astype(np.uint8) for i, (h, w) in
            enumerate(CLI_SIZES)]
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(os.path.join(indir, f'{i}.jpg'))
    res = {}
    for name, build in builders.items():
        sd = build()
        model = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
        row = {}
        for mode, on_device in (('library_host_loop', False), ('library_graph', None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for img in imgs:
                upscale_tiled(model, img, dtype=torch.bfloat16, on_device=on_device).cpu()
            row[f'{mode}_s'] = time.perf_counter() - t0
        cache = model.__dict__['_tiled_fn_cache']
        for p in cache.values():
            p.release()
        cache.clear()
        del model
        torch.cuda.empty_cache()
        ckpt = os.path.join(tmp, f'{name}.safetensors')
        write_safetensors(sd, ckpt)
        for mode, flags in (('cli', []), ('cli_bucket', ['--bucket'])):
            outdir = os.path.join(tmp, f'{name}_{mode}')
            t0 = time.perf_counter()
            rc = upscale.main([ckpt, indir, outdir, '--bf16', '--tile', 'auto', *flags])
            row[f'{mode}_s'] = time.perf_counter() - t0
            sizes = [Image.open(os.path.join(outdir, f'{i}.jpg')).size for i in range(len(CLI_SIZES))]
            if rc != 0 or sizes != [(w * 4, h * 4) for h, w in CLI_SIZES]:
                raise AssertionError(f'cli {name} {mode}: rc {rc}, sizes {sizes}')
        res[name] = json.dumps(row)
    return res


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


def over_bound_ms(rows: list[dict], prefix: str = '') -> float:
    """What the rows' kernel launches of one bench forward take beyond their
    bounds: the sum of launches per forward x (ms - bound ms), over the rows
    whose name starts with ``prefix``."""
    return sum(r['per_forward'] * (r['ms'] - r['bound_ms']) for r in rows if r['name'].startswith(prefix))


def check_bench_counts(counts: dict, mine: set, per_forward: int, reps: int, checked: set) -> int:
    """The bench forwards launched the kernels of the wrappers named in
    ``mine`` ``per_forward`` times each forward, no other kernel, and only
    at shapes the kernels phase checked.  Returns the launches."""
    bench = sum(counts[k][0] for k in mine)
    if bench != per_forward * reps:
        raise AssertionError(f'{bench} kernel launches of {sorted(mine)} in {reps} bench forwards, '
                             f'expected {per_forward} each')
    others = {k: c[0] for k, c in counts.items() if k not in mine and c[0]}
    if others:
        raise AssertionError(f'the bench forwards launched other kernels: {others}')
    ran = {(k, key) for k, (_, by_shape) in counts.items() for key in by_shape}
    if ran - checked:
        raise AssertionError(f'the bench forwards ran shapes the kernels phase did not check: {sorted(ran - checked)}')
    return bench


def main() -> int:
    import numpy as np
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

    import resselt_tpu_torch
    from resselt_tpu_torch.core import ModelMetadata
    from resselt_tpu_torch.ops import _build
    from resselt_tpu_torch.ops import fused_conv as fc
    from resselt_tpu_torch.zoo import (make_atd, make_eimn, make_esrgan, make_hat, make_plksr, make_realplksr,
                                       make_swinir)

    t0 = time.perf_counter()
    took = _build.build()
    log('build', seconds=round(time.perf_counter() - t0, 2), kernels=took,
        ptxas=json.dumps({name: ptxas_report(_build.build_log(name)) for name in took}))

    # -- ESRGAN: the conv3x3 kernel ------------------------------------------
    shapes = conv_shapes(BENCH['batch'], BENCH['tile'])
    rows = phase_kernels('cuda', shapes, reps=10)
    log('kernels', f32_tol=F32_TOL, bf16_rtol=BF16_RTOL, bf16_atol=BF16_ATOL, rows=json.dumps(rows))

    reps = 5
    with tempfile.TemporaryDirectory() as tmp:
        sd = make_esrgan(BENCH['num_filters'], BENCH['num_blocks'], BENCH['scale'], seed=0)
        model, ckpt = phase_load('cuda', sd, 'esrgan', 'ESRGAN', ModelMetadata(3, 3, BENCH['scale'], 'ESRGAN'), tmp)
        log('load', arch=model.arch_id, metadata=repr(model.metadata), files='safetensors,pth')

        res = phase_model(model, sd, 64, fc.fused_conv3x3_act)
        if res['launches_per_forward'] != 351:
            raise AssertionError(f"{res['launches_per_forward']} kernel launches per forward, expected 351")
        log('model', tol=MODEL_TOL, **res)

        serve = phase_serve(model, ckpt, tmp, BENCH['batch'], BENCH['tile'], timed_reps=reps, img_hw=(720, 1280),
                            tiled_tile=BENCH['tile'])
        counts = serve.pop('bench_counts')
        serve.pop('bench_paths')
        serve.pop('bench_plain')
        serve.pop('shapes')
        launches = serve.pop('launches')['act']
        if launches == 0:
            raise AssertionError('the main path launched no conv3x3 kernel')
        checked = {(r['entry'], shape_key(s)) for r, s in zip(rows, shapes)}
        bench_launches = check_bench_counts(counts, {'act', 'pack2'}, 351, reps, checked)
        for r, s in zip(rows, shapes):
            r['per_forward'] = counts[r['entry']][1].get(shape_key(s), 0) / reps
        conv_ms = sum(r['ms'] * r['per_forward'] for r in rows)
        log('serve', dtype='bfloat16', batch=BENCH['batch'], tile=BENCH['tile'], launches=launches,
            launches_per_bench_forward=bench_launches / reps, conv_ms_per_bench_forward=conv_ms, **serve)
        del model, sd
        torch.cuda.empty_cache()

    # -- PLKSR: the large-kernel conv ----------------------------------------
    nb = PLKSR['n_blocks']
    lk = lk_shapes(BENCH['batch'], BENCH['tile'], PLKSR['pdim'], PLKSR['kernel_size'])
    lk_rows = phase_lk_kernels('cuda', lk, reps=10)
    log('lk_kernels', f32_tol=F32_TOL, bf16_rtol=BF16_RTOL, bf16_atol=BF16_ATOL, rows=json.dumps(lk_rows))

    with tempfile.TemporaryDirectory() as tmp:
        sd = make_plksr(PLKSR['dim'], nb, PLKSR['scale'], PLKSR['kernel_size'], seed=0)
        model, ckpt = phase_load('cuda', sd, 'plksr', 'PLKSR', ModelMetadata(3, 3, PLKSR['scale'], 'PLKSR'), tmp)
        log('plksr_load', arch=model.arch_id, metadata=repr(model.metadata), files='safetensors,pth')

        res = phase_model(model, sd, 64, fc.fused_conv_lk)
        if res['launches_per_forward'] != nb:
            raise AssertionError(f"{res['launches_per_forward']} lk launches per PLKSR forward, expected {nb}")
        rsd = make_realplksr(PLKSR['dim'], 4, PLKSR['scale'], PLKSR['kernel_size'], dysample=True, seed=1)
        real = resselt_tpu_torch.load_from_state_dict(rsd, device='cuda')
        rres = phase_model(real, rsd, 64, fc.fused_conv_lk, bf16=False)
        if rres['launches_per_forward'] != 4 or real.metadata.name != 'RealPLKSR' or not real.config.dys:
            raise AssertionError(f'RealPLKSR: {rres}, {real.metadata}, dys {real.config.dys}')
        log('plksr_model', tol=MODEL_TOL, **res, realplksr_dys_4_blocks=json.dumps(rres))
        del real

        serve = phase_serve(model, ckpt, tmp, BENCH['batch'], BENCH['tile'], timed_reps=reps, img_hw=(720, 1280),
                            tiled_tile=BENCH['tile'])
        counts = serve.pop('bench_counts')
        paths = serve.pop('bench_paths')['lk']
        serve.pop('bench_plain')
        serve.pop('shapes')
        lk_launches = serve.pop('launches')['lk']
        checked = {('lk', lk_shape_key(s)) for s in lk}
        lk_bench = check_bench_counts(counts, {'lk'}, nb, reps, checked)
        on_path = sum(c for (_, path), c in paths.items() if path == 'stacked')
        if on_path != lk_bench:
            raise AssertionError(f'{lk_bench} lk launches in the bench forwards, {on_path} on the stacked path: {paths}')
        for r, s in zip(lk_rows, lk):
            r['per_forward'] = counts['lk'][1].get(lk_shape_key(s), 0) / reps
        lk_ms = sum(r['ms'] * r['per_forward'] for r in lk_rows)
        log('plksr_serve', dtype='bfloat16', batch=BENCH['batch'], tile=BENCH['tile'], launches=lk_launches,
            launches_per_bench_forward=lk_bench / reps, stacked_path_launches_per_bench_forward=on_path / reps,
            lk_ms_per_bench_forward=lk_ms, **serve)

    # -- SwinIR-M: the window attention ---------------------------------------
    from resselt_tpu_torch.ops import window_attention as wa

    sw = SWINIR
    n_blocks = sum(sw['depths'])
    wshapes = wattn_shapes(BENCH['batch'], BENCH['tile'], sw, others=(ATD, HAT, DAT, RGT, DRCT, FDAT, OMNI, FLEXNET))
    w_rows = phase_wattn_kernels('cuda', wshapes, reps=10)
    log('wattn_kernels', f32_tol=F32_TOL, bf16_rtol=BF16_RTOL, bf16_atol=WATTN_BF16_ATOL, rows=json.dumps(w_rows))

    with tempfile.TemporaryDirectory() as tmp:
        sd = make_swinir(sw['embed_dim'], sw['depths'], sw['num_heads'], sw['window_size'], upscale=sw['scale'],
                         img_size=sw['img_size'], seed=0)
        masks = frozenset(k for k in sd if k.endswith('.attn_mask'))
        model, ckpt = phase_load('cuda', sd, 'swinir', 'SwinIR', ModelMetadata(3, 3, sw['scale'], 'SwinIR'), tmp,
                                 dropped=masks)
        if (model.config.embed_dim, model.config.depths, model.config.window_size) != (180, (6,) * 6, 8):
            raise AssertionError(f'SwinIR config {model.config}')
        log('swinir_load', arch=model.arch_id, metadata=repr(model.metadata), files='safetensors,pth',
            dropped_attn_masks=len(masks))

        res = phase_model(model, sd, 64, wa.window_mha, tol=SWINIR_TOL)
        if res['launches_per_forward'] != n_blocks or res['plain_attentions_per_forward'] != 0:
            raise AssertionError(f"{res['launches_per_forward']} window_mha launches per SwinIR forward, "
                                 f'expected {n_blocks}')
        rsd = make_swinir(sw['embed_dim'], (2, 2), (6, 6), sw['window_size'], upscale=sw['scale'],
                          upsampler='nearest+conv', img_size=sw['img_size'], seed=1)
        real = resselt_tpu_torch.load_from_state_dict(rsd, device='cuda')
        rres = phase_model(real, rsd, 64, wa.window_mha, bf16=False, tol=SWINIR_TOL)
        if rres['launches_per_forward'] != 4 or real.config.upsampler != 'nearest+conv':
            raise AssertionError(f'real-world SwinIR: {rres}, {real.config}')
        log('swinir_model', tol=SWINIR_TOL, **res, realsr_nearest_conv_2x2_blocks=json.dumps(rres))
        del real

        serve = phase_serve(model, ckpt, tmp, BENCH['batch'], BENCH['tile'], timed_reps=reps, img_hw=(720, 1280))
        counts = serve.pop('bench_counts')
        serve.pop('bench_paths')
        if serve.pop('bench_plain')[0]:
            raise AssertionError('the SwinIR-M bench forwards sent window attentions to the plain path')
        w_launches = serve.pop('launches')['wattn']
        phase_shapes = serve.pop('shapes')['wattn']
        checked = {('wattn', wattn_shape_key(s)) for s in wshapes}
        w_bench = check_bench_counts(counts, {'wattn'}, n_blocks, reps, checked)
        unchecked = {('wattn', key) for key in phase_shapes} - checked
        if unchecked:
            raise AssertionError(f'the serve phase ran window shapes wattn_kernels did not check: {sorted(unchecked)}')
        timed = wattn_timed_rows(wshapes)
        for i, (r, s) in enumerate(zip(w_rows, wshapes)):
            key = wattn_shape_key(s)
            r['per_forward'] = counts['wattn'][1].get(key, 0) / reps if timed[key] == i else 0.0
        w_ms = sum(r['ms'] * r['per_forward'] for r in w_rows)
        w_checked = checked
        log('swinir_serve', dtype='bfloat16', batch=BENCH['batch'], tile=BENCH['tile'], launches=w_launches,
            launches_per_bench_forward=w_bench / reps, wattn_ms_per_bench_forward=w_ms,
            tiled_tile=sw['tile'], tiled_halo=sw['halo'], **serve)

    # -- EIMN_L: the fused MOLRCM ------------------------------------------------
    from resselt_tpu_torch.ops import molrcm as mo

    ei = EIMN
    n_molrcm = ei['num_stages'] * ei['depths']
    mshapes = molrcm_shapes(BENCH['batch'], BENCH['tile'], ei)
    m_rows = phase_molrcm_kernels('cuda', mshapes, reps=10)
    log('molrcm_kernels', f32_tol=f'{MOLRCM_TOL} x max|plain|', bf16_rtol=BF16_RTOL, bf16_atol=BF16_ATOL,
        rows=json.dumps(m_rows))

    with tempfile.TemporaryDirectory() as tmp:
        sd = make_eimn(ei['embed_dims'], ei['num_stages'], ei['depths'], ei['mlp_ratio'], ei['scale'], seed=0)
        model, ckpt = phase_load('cuda', sd, 'eimn', 'eimn', ModelMetadata(3, 3, ei['scale'], 'EIMN'), tmp)
        cfg = model.config
        if (cfg.embed_dims, cfg.num_stages, cfg.depths, cfg.mlp_ratio) != (64, 16, 1, 170 / 64):
            raise AssertionError(f'EIMN config {cfg}')
        log('eimn_load', arch=model.arch_id, metadata=repr(model.metadata), config=repr(cfg), files='safetensors,pth')

        res = phase_model(model, sd, 64, mo.fused_molrcm)
        if res['launches_per_forward'] != n_molrcm:
            raise AssertionError(f"{res['launches_per_forward']} fused_molrcm launches per EIMN forward, "
                                 f'expected {n_molrcm}')
        log('eimn_model', tol=MODEL_TOL, **res)

        serve = phase_serve(model, ckpt, tmp, BENCH['batch'], BENCH['tile'], timed_reps=reps, img_hw=(720, 1280))
        counts = serve.pop('bench_counts')
        serve.pop('bench_paths')
        serve.pop('bench_plain')
        m_launches = serve.pop('launches')['molrcm']
        phase_shapes = serve.pop('shapes')['molrcm']
        checked = set().union(*(molrcm_shape_keys(s) for s in mshapes))
        m_bench = check_bench_counts(counts, {'molrcm'}, n_molrcm, reps, checked)
        strip = sum(c for key, c in counts['molrcm'][1].items() if key[-1] == 'bfloat16')
        if strip != m_bench:  # the 16-bit strip kernel is the only kernel bf16 launches reach
            raise AssertionError(f'{m_bench} MOLRCM launches in the bench forwards, {strip} in bf16')
        unchecked = {('molrcm', key) for key in phase_shapes} - checked
        if unchecked:
            raise AssertionError(f'the serve phase ran MOLRCM shapes molrcm_kernels did not check: {sorted(unchecked)}')
        for r, s in zip(m_rows, mshapes):
            r['per_forward'] = counts['molrcm'][1].get((s['n'], s['h'], s['w'], s['dim'], 'bfloat16'), 0) / reps
        m_ms = sum(r['ms'] * r['per_forward'] for r in m_rows)
        log('eimn_serve', dtype='bfloat16', batch=BENCH['batch'], tile=BENCH['tile'], launches=m_launches,
            launches_per_bench_forward=m_bench / reps, strip_kernel_launches_per_bench_forward=strip / reps,
            molrcm_ms_per_bench_forward=m_ms,
            tiled_tile=ei['tile'], tiled_halo=ei['halo'], **serve)

    # -- ATD-light: the row gather, and the window attention at n 256 --------------
    from resselt_tpu_torch.ops import row_gather

    at = ATD
    n_layers = sum(at['depths'])
    gshapes = gather_shapes(BENCH['batch'], BENCH['tile'], at)
    g_rows = phase_gather_kernels('cuda', gshapes, reps=10)
    log('gather_kernels', tol='exact', rows=json.dumps(g_rows))
    g_checked = {('gather', gather_shape_key(s)) for s in gshapes}

    def serve_window_model(model, ckpt, tmp, mine: dict, cfg: dict, plain: int = 0):
        """phase_serve for a model on the window-attention kernel (and, for
        ATD, the row gather): ``mine`` maps each of its wrappers' names to
        the launches expected per forward, ``plain`` is the window
        attentions per forward the kernel does not take (the plain path).
        Every shape of the phase must have been checked by a kernels phase;
        each checked row's launches per bench forward are added to its
        ``per_forward``.  Returns the phase's fields (with the plain path's
        attentions per bench forward, in total and per shape), and per
        wrapper (launches, per bench forward, ms per bench forward)."""
        serve = phase_serve(model, ckpt, tmp, BENCH['batch'], BENCH['tile'], timed_reps=reps, img_hw=(720, 1280))
        counts = serve.pop('bench_counts')
        serve.pop('bench_paths')
        plain_calls, plain_shapes = serve.pop('bench_plain')
        if plain_calls != plain * reps:
            raise AssertionError(f'{plain_calls} plain-path window attentions in {reps} bench forwards, '
                                 f'expected {plain} each: {plain_shapes}')
        serve['plain_attentions_per_bench_forward'] = plain_calls / reps
        serve['plain_attention_shapes'] = json.dumps({str(k): v / reps for k, v in plain_shapes.items()})
        figures = {'plain': {k: v / reps for k, v in plain_shapes.items()}}
        launches = serve.pop('launches')
        phase_shapes = serve.pop('shapes')
        checked = w_checked | g_checked
        check_bench_counts(counts, set(mine), sum(mine.values()), reps, checked)
        unchecked = {(k, key) for k in mine for key in phase_shapes[k]} - checked
        if unchecked:
            raise AssertionError(f'the serve phase ran shapes no kernels phase checked: {sorted(unchecked)}')
        for name, per_forward in mine.items():
            if counts[name][0] != per_forward * reps:
                raise AssertionError(f'{counts[name][0]} {name} launches in {reps} bench forwards, '
                                     f'expected {per_forward} each')
            table, shapes_, key_of = ((w_rows, wshapes, wattn_shape_key) if name == 'wattn'
                                      else (g_rows, gshapes, gather_shape_key))
            timed = wattn_timed_rows(wshapes) if name == 'wattn' else None
            ms = 0.0
            for i, (r, s) in enumerate(zip(table, shapes_)):
                n = counts[name][1].get(key_of(s), 0) / reps
                if timed is not None and timed[key_of(s)] != i:
                    n = 0.0  # the shift-mask row stands for this key's launches
                r['per_forward'] = r.get('per_forward', 0) + n
                ms += r['ms'] * n
            figures[name] = (launches[name], counts[name][0] / reps, ms)
        serve.update(dtype='bfloat16', batch=BENCH['batch'], tile=BENCH['tile'], tiled_tile=cfg['tile'],
                     tiled_halo=cfg['halo'], tiled_batch=cfg['tile_batch'])
        return serve, figures

    with tempfile.TemporaryDirectory() as tmp:
        sd = make_atd(at['embed_dim'], at['depths'], at['num_heads'], at['window_size'], at['num_tokens'],
                      at['reducted_dim'], at['convffn_kernel_size'], at['mlp_ratio'], at['scale'], seed=0)
        model, ckpt = phase_load('cuda', sd, 'atd', 'ATD', ModelMetadata(3, 3, at['scale'], 'ATD'), tmp)
        cfg = model.config
        if ((cfg.embed_dim, cfg.depths, cfg.window_size, cfg.category_size, cfg.num_tokens, cfg.upsampler)
                != (48, (6,) * 5, 16, 128, 64, 'pixelshuffledirect')):
            raise AssertionError(f'ATD config {cfg}')
        log('atd_load', arch=model.arch_id, metadata=repr(model.metadata), config=repr(cfg), files='safetensors,pth')

        x64 = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
        cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
        flips32, tokens = atd_category_flips(cpu, model, x64)
        flipsb, _ = atd_category_flips(cpu, model, x64, torch.bfloat16)
        res = phase_model(model, sd, 64, (wa.window_mha, row_gather), tol=ATD_TOL)
        if res['launches_per_forward'] != [n_layers, 2 * n_layers] or res['plain_attentions_per_forward'] != 0:
            raise AssertionError(f"{res['launches_per_forward']} window_mha and row_gather launches per ATD forward, "
                                 f'expected {[n_layers, 2 * n_layers]}')
        log('atd_model', tol=ATD_TOL, **res, layer0_category_flips_f32_card_vs_cpu=f'{flips32}/{tokens}',
            layer0_category_flips_bf16_vs_f32=f'{flipsb}/{tokens}')
        del cpu

        serve, atd_fig = serve_window_model(model, ckpt, tmp, {'wattn': n_layers, 'gather': 2 * n_layers}, at)
        log('atd_serve', launches=atd_fig['wattn'][0] + atd_fig['gather'][0],
            wattn_launches_per_bench_forward=atd_fig['wattn'][1], gather_launches_per_bench_forward=atd_fig['gather'][1],
            wattn_ms_per_bench_forward=atd_fig['wattn'][2], gather_ms_per_bench_forward=atd_fig['gather'][2], **serve)
        del model, sd
        torch.cuda.empty_cache()

    # -- HAT-S: the window attention at n 256; OCAB on the plain path ----------------
    ha = HAT
    n_habs = sum(ha['depths'])
    with tempfile.TemporaryDirectory() as tmp:
        sd = make_hat(ha['embed_dim'], ha['depths'], ha['num_heads'], ha['window_size'], ha['overlap_ratio'],
                      ha['compress_ratio'], ha['squeeze_factor'], ha['mlp_ratio'], ha['scale'], ha['num_feat'], seed=0)
        model, ckpt = phase_load('cuda', sd, 'hat', 'HAT', ModelMetadata(3, 3, ha['scale'], 'HAT'), tmp)
        cfg = model.config
        if ((cfg.embed_dim, cfg.depths, cfg.window_size, cfg.overlap_win_size, cfg.compress_ratio, cfg.squeeze_factor,
             cfg.num_feat) != (144, (6,) * 6, 16, 24, 24, 24, 64)):
            raise AssertionError(f'HAT config {cfg}')
        log('hat_load', arch=model.arch_id, metadata=repr(model.metadata), config=repr(cfg), files='safetensors,pth')

        n_ocabs = len(ha['depths'])
        res = phase_model(model, sd, 64, wa.window_mha, tol=HAT_TOL)
        if res['launches_per_forward'] != n_habs or res['plain_attentions_per_forward'] != n_ocabs:
            raise AssertionError(f"{res['launches_per_forward']} window_mha launches and "
                                 f"{res['plain_attentions_per_forward']} plain-path attentions per HAT forward, "
                                 f'expected {n_habs} and {n_ocabs}')
        log('hat_model', tol=HAT_TOL, **res)

        serve, hat_fig = serve_window_model(model, ckpt, tmp, {'wattn': n_habs}, ha, plain=n_ocabs)
        log('hat_serve', launches=hat_fig['wattn'][0], launches_per_bench_forward=hat_fig['wattn'][1],
            wattn_ms_per_bench_forward=hat_fig['wattn'][2], **serve)
        del model, sd
        torch.cuda.empty_cache()

    # -- DAT-S, RGT-S and DRCT: the window attention at rectangular windows and head_dim 53 / 46 --------
    def window_family(stem: str, cfg: dict, sd: dict, arch: str, meta_name: str, expect: dict, n_wattn: int,
                      n_plain: int, tol: float, dropped: frozenset | None = None, extra_models: tuple = ()):
        """Load, model and serve phases of one window transformer, with its
        window_mha launches and plain-path attentions per forward asserted;
        ``dropped``: the checkpoint keys the loader leaves out of the params
        (default: the ``attn_mask`` buffers); ``extra_models``: (label, state
        dict, window_mha launches per forward) of small variants held card
        against CPU in f32 in the model phase.  The serve phase reports the
        peak device memory.  Returns the serve phase's fields and figures."""
        if dropped is None:
            dropped = frozenset(k for k in sd if '.attn_mask' in k)
        with tempfile.TemporaryDirectory() as tmp:
            model, ckpt = phase_load('cuda', sd, stem, arch, ModelMetadata(3, 3, cfg['scale'], meta_name), tmp,
                                     dropped=dropped)
            got = {k: getattr(model.config, k) for k in expect}
            if got != expect:
                raise AssertionError(f'{meta_name} config {got}, expected {expect}')
            log(f'{stem}_load', arch=model.arch_id, metadata=repr(model.metadata), config=repr(model.config),
                files='safetensors,pth', dropped_keys=len(dropped))

            res = phase_model(model, sd, 64, wa.window_mha, tol=tol)
            if (res['launches_per_forward'], res['plain_attentions_per_forward']) != (n_wattn, n_plain):
                raise AssertionError(f"{res['launches_per_forward']} window_mha launches and "
                                     f"{res['plain_attentions_per_forward']} plain-path attentions per {meta_name} "
                                     f'forward, expected {n_wattn} and {n_plain}')
            for label, esd, n in extra_models:
                extra = resselt_tpu_torch.load_from_state_dict(esd, device='cuda')
                eres = phase_model(extra, esd, 64, wa.window_mha, bf16=False, tol=tol)
                if (eres['launches_per_forward'], eres['plain_attentions_per_forward']) != (n, 0):
                    raise AssertionError(f'{meta_name} {label}: {eres}, expected {n} window_mha launches')
                res[label] = json.dumps(eres)
                del extra
            log(f'{stem}_model', tol=tol, **res)

            serve, fig = serve_window_model(model, ckpt, tmp, {'wattn': n_wattn}, cfg, plain=n_plain)
            del model
            torch.cuda.empty_cache()
            return serve, fig

    from resselt_tpu_torch.zoo import make_dat, make_drct, make_rgt

    da, rg, dr = DAT, RGT, DRCT
    n_spatial = sum(len([b for b in range(d) if b % 2 == 0]) for d in da['depth'])
    serve, dat_fig = window_family(
        'dat', da, make_dat(da['embed_dim'], da['depth'], da['num_heads'], da['split_size'], da['expansion_factor'],
                            da['scale'], seed=0), 'dat', 'DAT',
        {'embed_dim': 180, 'depth': da['depth'], 'num_heads': da['num_heads'], 'split_size': (8, 16),
         'expansion_factor': 2.0, 'upsampler': 'pixelshuffle', 'img_size': 64}, 2 * n_spatial, 0, DAT_TOL)
    log('dat_serve', launches=dat_fig['wattn'][0], launches_per_bench_forward=dat_fig['wattn'][1],
        wattn_ms_per_bench_forward=dat_fig['wattn'][2], **serve)

    n_lsa = sum(len([b for b in range(d) if b % 2 == 0]) for d in rg['depth'])
    serve, rgt_fig = window_family(
        'rgt', rg, make_rgt(rg['embed_dim'], rg['depth'], rg['num_heads'], rg['split_size'], rg['mlp_ratio'],
                            rg['c_ratio'], rg['scale'], seed=0), 'RGT', 'RGT',
        {'embed_dim': 180, 'depth': rg['depth'], 'num_heads': rg['num_heads'], 'split_size': (8, 32),
         'mlp_ratio': 2.0, 'c_ratio': 0.5}, 2 * n_lsa, 0, RGT_TOL)
    log('rgt_serve', launches=rgt_fig['wattn'][0], launches_per_bench_forward=rgt_fig['wattn'][1],
        wattn_ms_per_bench_forward=rgt_fig['wattn'][2], **serve)

    n_kernel = len(window_classes(dr)[1])  # the blocks of a group the kernel takes
    serve, drct_fig = window_family(
        'drct', dr, make_drct(dr['embed_dim'], dr['num_layers'], dr['num_heads'][0], dr['window_size'], dr['gc'],
                              dr['mlp_ratio'], dr['scale'], img_size=dr['img_size'], seed=0), 'DRCT', 'DRCT',
        {'embed_dim': 180, 'num_layers': 6, 'num_heads': dr['num_heads'], 'window_size': 16, 'gc': 32,
         'img_size': 64}, n_kernel * dr['num_layers'], (5 - n_kernel) * dr['num_layers'], DRCT_TOL)
    p_rows = time_plain_attentions('cuda', drct_fig['plain'], reps=10)
    log('drct_serve', launches=drct_fig['wattn'][0], launches_per_bench_forward=drct_fig['wattn'][1],
        wattn_ms_per_bench_forward=drct_fig['wattn'][2],
        plain_attention_ms_per_bench_forward=sum(r['plain_ms'] * r['per_forward'] for r in p_rows),
        plain_attention_library_ms_per_bench_forward=sum(r['library_ms'] * r['per_forward'] for r in p_rows),
        plain_attention_rows=json.dumps(p_rows), **serve)

    # -- FDAT-M and OmniSR: the window attention at n 64, head_dim 30 and 16, unmasked ----------------
    from resselt_tpu_torch.zoo import make_fdat, make_omni

    fd = FDAT
    n_fdat = fd['num_groups'] * fd['depth_per_group']  # one spatial block of each (spatial, channel) pair
    fdat_small = tuple(
        (f'{up}_2x_1_group_model', make_fdat(fd['embed_dim'], 1, 1, fd['num_heads'], fd['window_size'],
                                             fd['ffn_expansion_ratio'], fd['aim_reduction_ratio'], fd['mid_dim'], up,
                                             2, seed=1), 1)
        for up in ('lda', 'dysample'))
    serve, fdat_fig = window_family(
        'fdat', fd, make_fdat(fd['embed_dim'], fd['num_groups'], fd['depth_per_group'], fd['num_heads'],
                              fd['window_size'], fd['ffn_expansion_ratio'], fd['aim_reduction_ratio'], fd['mid_dim'],
                              fd['upsampler'], fd['scale'], seed=0), 'FDAT', 'FDAT',
        {'embed_dim': 120, 'num_groups': 4, 'depth': 6, 'num_heads': 4, 'window_size': 8, 'ffn_expansion_ratio': 2.0,
         'aim_reduction_ratio': 8, 'mid_dim': 64, 'upsampler_type': 'transpose+conv', 'unshuffle_mod': False},
        n_fdat, 0, FDAT_TOL, dropped=frozenset({'upsampler.MetaUpsample'}), extra_models=fdat_small)
    log('fdat_serve', launches=fdat_fig['wattn'][0], launches_per_bench_forward=fdat_fig['wattn'][1],
        wattn_ms_per_bench_forward=fdat_fig['wattn'][2], **serve)

    om = OMNI
    n_omni = 2 * om['res_num'] * om['block_num']  # block and grid attention in each OSA block
    serve, omni_fig = window_family(
        'omni', om, make_omni(om['num_feat'], om['block_num'], om['pe'], om['window_size'], om['res_num'], om['scale'],
                              seed=0), 'OmniSR', 'OmniSR',
        {'num_feat': 64, 'block_num': 1, 'pe': True, 'window_size': 8, 'res_num': 5, 'up_scale': 4}, n_omni, 0,
        OMNI_TOL, dropped=frozenset(),
        extra_models=(('no_pe_2x_1_group_model', make_omni(om['num_feat'], 1, False, om['window_size'], 1, 2, seed=1),
                       2),))
    log('omni_serve', launches=omni_fig['wattn'][0], launches_per_bench_forward=omni_fig['wattn'][1],
        wattn_ms_per_bench_forward=omni_fig['wattn'][2], **serve)

    # -- the six 3x3-conv families: conv3x3.cu at their shapes --------------------------------
    from resselt_tpu_torch.parallel.tiling import _resolve_halo_hint
    from resselt_tpu_torch.zoo import make_compact, make_mosr, make_rcan, make_span, make_spanplus, make_spanpp

    fshapes = conv_family_shapes(BENCH['batch'], BENCH['tile'])
    f_rows = phase_kernels('cuda', fshapes, reps=10)
    log('conv_family_kernels', f32_tol=F32_TOL, bf16_rtol=BF16_RTOL, bf16_atol=BF16_ATOL, rows=json.dumps(f_rows))
    f_checked = {('act', shape_key(s)) for s in fshapes}

    def cpu_routed_convs(sd: dict, size: int = 64) -> int:
        """The convs that ``ops.conv_route`` sends to the 3x3 kernel's wrapper
        in one f32 forward of ``sd`` on the CPU (where the wrapper runs its
        plain version and counts nothing), on the model phase's image size."""
        from resselt_tpu_torch.ops import conv_route

        cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
        calls, wrapped = [0], conv_route.fused_conv3x3_act

        def count(*args, **kwargs):
            calls[0] += 1
            return wrapped(*args, **kwargs)

        conv_route.fused_conv3x3_act = count
        try:
            cpu(np.random.default_rng(0).random((1, size, size, 3), dtype=np.float32))
        finally:
            conv_route.fused_conv3x3_act = wrapped
        return calls[0]

    def flop_count(sd: dict, cfg: dict) -> dict:
        """torch.utils.flop_counter's count of one f32 forward on the CPU,
        scaled to bench_families.md's batch (``flop_batch``, default 8) of
        its tile (``flop_tile``, default 256), and its ratio to that file's
        XLA count of the reference-default forward (a work count, not a
        time).  Taken on one ``flop_size`` image (default 64^2: the count
        scales with the pixels; the tile where the model pads by a fixed
        halo or transforms whole maps).  With ``dft`` it also counts the
        FLOPs the JAX package's matmul DFT (``_dft_mats``: 4 h w (w/2 + 1) +
        8 h^2 (w/2 + 1) per plane, each way, for 2 <= h, w <= 1024) spends
        on the same transforms, which torch.fft does without matmuls and the
        flop counter does not see, and the ratio of the sum."""
        from torch.utils.flop_counter import FlopCounterMode

        from resselt_tpu_torch.nn import spectral

        size = cfg.get('flop_size', 64)
        scale = cfg.get('flop_batch', 8) * (cfg.get('flop_tile', 256) / size) ** 2
        cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
        dft, wrapped = [0], (spectral.rfft2_planes, spectral.irfft2_planes)

        def mm_dft(planes: int, h: int, w: int) -> None:
            if 2 <= h <= 1024 and 2 <= w <= 1024:
                dft[0] += planes * (4 * h * w * (w // 2 + 1) + 8 * h * h * (w // 2 + 1))

        def rfft2(x, *args, **kwargs):
            mm_dft(x.numel() // (x.shape[-2] * x.shape[-1]), x.shape[-2], x.shape[-1])
            return wrapped[0](x, *args, **kwargs)

        def irfft2(re, im, s, *args, **kwargs):
            mm_dft(re.numel() // (re.shape[-2] * re.shape[-1]), int(s[0]), int(s[1]))
            return wrapped[1](re, im, s, *args, **kwargs)

        if cfg.get('dft'):
            spectral.rfft2_planes, spectral.irfft2_planes = rfft2, irfft2
        try:
            with FlopCounterMode(display=False) as counter:
                cpu(np.random.default_rng(0).random((1, size, size, 3), dtype=np.float32))
        finally:
            spectral.rfft2_planes, spectral.irfft2_planes = wrapped
        gflop = counter.get_total_flops() * scale / 1e9
        ref = cfg.get('xla_gflop')
        out = {'gflop': round(gflop, 1), 'at': f"{cfg.get('flop_batch', 8)} x {cfg.get('flop_tile', 256)}^2",
               'xla_gflop_reference_default': ref, 'ratio_to_xla_count': round(gflop / ref, 3) if ref else None}
        if cfg.get('dft'):
            out['matmul_dft_gflop'] = round(dft[0] * scale / 1e9, 1)
            out['ratio_with_matmul_dft'] = round((gflop + out['matmul_dft_gflop']) / ref, 3)
        return out

    def conv_family(stem: str, cfg: dict, sd: dict, arch: str, expect: dict, n_conv: int, tol: float,
                    extra_models: tuple = (), serve_config: dict | None = None, n_wattn: int | None = None):
        """Load, model and serve phases of one conv family: its conv3x3
        launches per forward asserted (``n_conv``, and the count the CPU's
        forward routes) in the model phase and the bench forwards, which
        may launch no other kernel and only shapes conv_family_kernels
        checked; ``expect``: config fields the loader must infer;
        ``extra_models``: (label, state dict, launches per forward[,
        window_mha launches, plain-path attentions]) of small variants held
        card against CPU in f32; ``serve_config``: ``with_config`` fields of
        the served model (SpanPP's ``eval_scale``: the tiled driver needs an
        integer scale); a ``cfg`` with ``xla_gflop`` reports the forward's
        FLOP count against it; ``n_wattn``: the window_mha launches per
        forward of a family that also runs the window-attention kernel
        (FlexNet), asserted as the conv3x3 count, with no attention on the
        plain path and every window shape checked by wattn_kernels.  Returns
        the serve phase's fields and (launches, per bench forward, conv ms
        per bench forward, launches per forward by row, and with
        ``n_wattn`` the window_mha launches, per bench forward and ms per
        bench forward)."""
        with tempfile.TemporaryDirectory() as tmp:
            cpu_params = resselt_tpu_torch.load_from_state_dict(sd, device='cpu').params
            params = {k: v.numpy() for k, v in cpu_params.items()}
            meta = ModelMetadata(3, 3, cfg.get('scale_list', cfg['scale']), cfg['name'])
            model, ckpt = phase_load('cuda', sd, stem, arch, meta, tmp, expect=params)
            got = {k: getattr(model.config, k) for k in expect}
            if got != expect:
                raise AssertionError(f"{cfg['name']} config {got}, expected {expect}")
            log(f'{stem}_load', arch=model.arch_id, metadata=repr(model.metadata), config=repr(model.config),
                files='safetensors,pth', params=len(params), checkpoint_keys=len(sd))

            entry = (fc.fused_conv3x3_act, wa.window_mha)
            res = phase_model(model, sd, 64, entry, tol=tol)
            cpu_count = cpu_routed_convs(sd)
            n_act, n_w = res['launches_per_forward']
            if not n_act == cpu_count == n_conv:
                raise AssertionError(f"{n_act} conv3x3 launches per {cfg['name']} forward, "
                                     f'{cpu_count} routed on the CPU, expected {n_conv}')
            if (n_w, res['plain_attentions_per_forward']) != (n_wattn or 0, 0):
                raise AssertionError(f"{n_w} window_mha launches and {res['plain_attentions_per_forward']} plain-path "
                                     f"attentions per {cfg['name']} forward, expected {n_wattn or 0} and 0")
            res['launches_per_forward'] = n_act if n_wattn is None else [n_act, n_w]
            res['cpu_routed_per_forward'] = cpu_count
            for label, esd, n, *attention in extra_models:
                extra = resselt_tpu_torch.load_from_state_dict(esd, device='cuda')
                eres = phase_model(extra, esd, 64, entry, bf16=False, tol=tol)
                eres['cpu_routed_per_forward'] = cpu_routed_convs(esd)
                got = [*eres['launches_per_forward'], eres['plain_attentions_per_forward']]
                if not got[0] == eres['cpu_routed_per_forward'] == n or got[1:] != (attention or [0, 0]):
                    raise AssertionError(f"{cfg['name']} {label}: {eres}, expected {n} conv3x3 launches and "
                                         f'(window_mha, plain) {attention or [0, 0]}')
                res[label] = json.dumps(eres)
                del extra
            if 'xla_gflop' in cfg:
                res['flops'] = json.dumps(flop_count(sd, cfg))
            log(f'{stem}_model', tol=tol, **res)

            served = model.with_config(**serve_config) if serve_config else model
            serve = phase_serve(served, ckpt, tmp, BENCH['batch'], BENCH['tile'], timed_reps=reps, img_hw=(720, 1280),
                                tiled_tile=cfg['tile'])
            counts = serve.pop('bench_counts')
            serve.pop('bench_paths')
            if serve.pop('bench_plain')[0]:
                raise AssertionError(f"the {cfg['name']} bench forwards sent window attentions to the plain path")
            phase_shapes = serve.pop('shapes')
            launches = serve.pop('launches')
            mine = {'act': n_conv, **({} if n_wattn is None else {'wattn': n_wattn})}
            check_bench_counts(counts, set(mine), sum(mine.values()), reps, f_checked | w_checked)
            for name, per_forward in mine.items():
                if counts[name][0] != per_forward * reps:
                    raise AssertionError(f"{counts[name][0]} {name} launches in {reps} {cfg['name']} bench forwards, "
                                         f'expected {per_forward} each')
            per_row = {r['name']: counts['act'][1].get(shape_key(s), 0) / reps for r, s in zip(f_rows, fshapes)}
            conv_ms = sum(r['ms'] * per_row[r['name']] for r in f_rows)
            figures = (launches['act'], counts['act'][0] / reps, conv_ms, {k: v for k, v in per_row.items() if v})
            if n_wattn is not None:
                unchecked = {('wattn', key) for key in phase_shapes['wattn']} - w_checked
                if unchecked:
                    raise AssertionError(f'the serve phase ran window shapes wattn_kernels did not check: '
                                         f'{sorted(unchecked)}')
                timed, w_ms = wattn_timed_rows(wshapes), 0.0
                for i, (r, s) in enumerate(zip(w_rows, wshapes)):
                    key = wattn_shape_key(s)
                    n = counts['wattn'][1].get(key, 0) / reps if timed[key] == i else 0.0
                    r['per_forward'] = r.get('per_forward', 0) + n
                    w_ms += r['ms'] * n
                figures += ((launches['wattn'], counts['wattn'][0] / reps, w_ms),)
            serve.update(dtype='bfloat16', batch=BENCH['batch'], tile=BENCH['tile'], tiled_tile=cfg['tile'],
                         tiled_halo=_resolve_halo_hint(served, cfg['tile'], torch.bfloat16))
            del model, served
            torch.cuda.empty_cache()
            return serve, figures

    c_figs = {}
    sp = SPANPP
    serve, c_figs['SpanPP'] = conv_family(
        'spanpp', sp, make_spanpp(sp['feature_channels'], ig_kernel=sp['ig_kernel'], implicit_dim=sp['implicit_dim'],
                                  latent_layers=sp['latent_layers'], seed=0), 'SpanPP',
        {'feature_channels': 48, 'scale_list': (1, 2, 3, 4), 'eval_scale': 2, 'ig_kernel': 3, 'implicit_dim': 256,
         'latent_layers': 4}, 21, MODEL_TOL, serve_config={'eval_scale': sp['scale']})
    log('spanpp_serve', launches=c_figs['SpanPP'][0], launches_per_bench_forward=c_figs['SpanPP'][1],
        conv_ms_per_bench_forward=c_figs['SpanPP'][2], per_forward_by_row=json.dumps(c_figs['SpanPP'][3]), **serve)

    sn = SPAN
    serve, c_figs['SPAN'] = conv_family(
        'span', sn, make_span(sn['feature_channels'], sn['scale'], seed=0), 'SPAN',
        {'feature_channels': 48, 'upscale': 4, 'norm': True}, 21, MODEL_TOL,
        extra_models=(('no_norm_16_features_2x_model', make_span(16, 2, seed=1, norm=False), 21),))
    log('span_serve', launches=c_figs['SPAN'][0], launches_per_bench_forward=c_figs['SPAN'][1],
        conv_ms_per_bench_forward=c_figs['SPAN'][2], per_forward_by_row=json.dumps(c_figs['SPAN'][3]), **serve)

    rc = RCAN
    n_rcan = 1 + rc['n_resgroups'] * (2 * rc['n_resblocks'] + 1) + 1 + 2 + 1  # head, body, tail.0 x 2, tail.1
    serve, c_figs['RCAN'] = conv_family(
        'rcan', rc, make_rcan(rc['n_feats'], rc['n_resgroups'], rc['n_resblocks'], rc['reduction'], rc['scale'],
                              seed=0), 'RCAN',
        {'n_feats': 64, 'n_resgroups': 10, 'n_resblocks': 20, 'reduction': 16, 'scale': 4, 'norm': True,
         'rgb_range': 255, 'unshuffle_mod': False}, n_rcan, MODEL_TOL,
        extra_models=(('unshuffle_2x_2_groups_model', make_rcan(32, 2, 2, 8, 2, unshuffle=True, seed=1),
                       1 + 2 * 5 + 1 + 2 + 1),))
    log('rcan_serve', launches=c_figs['RCAN'][0], launches_per_bench_forward=c_figs['RCAN'][1],
        conv_ms_per_bench_forward=c_figs['RCAN'][2], per_forward_by_row=json.dumps(c_figs['RCAN'][3]), **serve)

    mo_ = MOSR
    n_mosr = 1 + 2 * mo_['n_block'] + 2 + 2 + 1  # stem, fc1 / fc2, tail, shortcut, head
    serve, c_figs['MoSR'] = conv_family(
        'mosr', mo_, make_mosr(mo_['dim'], mo_['n_block'], mo_['scale'], seed=0), 'MoSR',
        {'dim': 64, 'n_block': 24, 'upscale': 4, 'upsampler': 'ps', 'expansion_ratio': 1.5, 'conv_ratio': 1.0,
         'kernel_size': 7}, n_mosr, MODEL_TOL,
        extra_models=(('dys_2x_2_blocks_model', make_mosr(32, 2, 2, seed=1, upsampler='dys'), 1 + 4 + 2 + 2),
                      ('gps_4x_2_blocks_model', make_mosr(32, 2, 4, seed=2, upsampler='gps'), 1 + 4 + 2 + 2 + 1)))
    log('mosr_serve', launches=c_figs['MoSR'][0], launches_per_bench_forward=c_figs['MoSR'][1],
        conv_ms_per_bench_forward=c_figs['MoSR'][2], per_forward_by_row=json.dumps(c_figs['MoSR'][3]), **serve)

    co = COMPACT
    serve, c_figs['Compact'] = conv_family(
        'compact', co, make_compact(co['num_feat'], co['num_conv'], co['scale'], seed=0), 'Compact',
        {'num_feat': 64, 'num_conv': 16, 'upscale': 4}, co['num_conv'] + 2, MODEL_TOL)
    log('compact_serve', launches=c_figs['Compact'][0], launches_per_bench_forward=c_figs['Compact'][1],
        conv_ms_per_bench_forward=c_figs['Compact'][2], per_forward_by_row=json.dumps(c_figs['Compact'][3]), **serve)

    spp = SPANPLUS
    n_spanplus = 1 + 3 * (spp['blocks'][0] + 2) + 1 + 1  # stem, SPABs, conv_2, head
    serve, c_figs['SPANPlus'] = conv_family(
        'spanplus', spp, make_spanplus(spp['feature_channels'], spp['blocks'], spp['scale'], seed=0), 'spanplus',
        {'feature_channels': 48, 'blocks': (4,), 'upscale': 2, 'upsampler': 'ps'}, n_spanplus, SPANPLUS_TOL,
        extra_models=(('dys_2x_1_block_model', make_spanplus(32, (1,), 2, seed=1, upsampler='dys'), 11),
                      ('conv_1x_1_block_model', make_spanplus(32, (1,), 1, seed=2, upsampler='conv'), 12)))
    log('spanplus_serve', launches=c_figs['SPANPlus'][0], launches_per_bench_forward=c_figs['SPANPlus'][1],
        conv_ms_per_bench_forward=c_figs['SPANPlus'][2], per_forward_by_row=json.dumps(c_figs['SPANPlus'][3]),
        **serve)

    # -- CUGAN (plain torch, no kernel) and the restoration U-nets and the MoSR lineage on conv3x3.cu -----------
    from resselt_tpu_torch.zoo import make_cugan, make_gater, make_gaterv2, make_gaterv3, make_moesr, make_mosrv2

    cg = dict(CUGAN, flop_size=256)
    serve, cugan_fig = conv_family(
        'cugan', cg, make_cugan(cg['variant'], seed=0), 'CuGAN',
        {'variant': '2x', 'in_channels': 3, 'out_channels': 3, 'pro': False}, 0, MODEL_TOL,
        extra_models=(('3x_model', make_cugan('3x', seed=1), 0), ('4x_pro_model', make_cugan('4x', True, seed=2), 0),
                      ('2x_fast_model', make_cugan('2x_fast', seed=3), 0)))
    log('cugan_serve', launches=cugan_fig[0], launches_per_bench_forward=cugan_fig[1], **serve)

    ga = GATER
    n_gater = 9  # in_to_dim, six stage convs (body.0), dim_to_ch.0 and .1
    serve, c_figs['GateR'] = conv_family(
        'gater', ga, make_gater(ga['dim'], ga['num_blocks'], seed=0, latent_att=ga['latent_att']), 'GateR',
        {'dim': 64, 'num_blocks': (2, 2, 2, 4, 2, 2, 2), 'latent_att': True}, n_gater, GATER_TOL,
        extra_models=(('dwconv_latent_16_model', make_gater(16, (1, 1, 1, 2, 1, 1, 1), seed=1), n_gater),))
    log('gater_serve', launches=c_figs['GateR'][0], launches_per_bench_forward=c_figs['GateR'][1],
        conv_ms_per_bench_forward=c_figs['GateR'][2], per_forward_by_row=json.dumps(c_figs['GateR'][3]), **serve)

    m2 = MOSRV2
    n_mosrv2 = 1 + 2 * m2['n_block'] + 2 + 1  # stem, fc1 / fc2, tail, the pixelshuffledirect head
    serve, c_figs['MoSRv2'] = conv_family(
        'mosrv2', m2, make_mosrv2(m2['dim'], m2['n_block'], m2['scale'], upsampler=m2['upsampler'], seed=0), 'MoSRv2',
        {'dim': 64, 'n_block': 24, 'scale': 4, 'upsampler': 'pixelshuffledirect', 'expansion_ratio': 1.5,
         'mid_dim': 32, 'group': 4, 'unshuffle_mod': False, 'rms_norm': True}, n_mosrv2, MODEL_TOL,
        extra_models=(('dysample_unshuffle_ln_2x_model', make_mosrv2(32, 2, 2, upsampler='dysample', mid_dim=16,
                                                                     unshuffle_mod=True, rms_norm=False, seed=1),
                       1 + 4 + 2 + 1),
                      ('pixelshuffle_3x_model', make_mosrv2(32, 2, 3, upsampler='pixelshuffle', seed=2),
                       1 + 4 + 2 + 3)))
    log('mosrv2_serve', launches=c_figs['MoSRv2'][0], launches_per_bench_forward=c_figs['MoSRv2'][1],
        conv_ms_per_bench_forward=c_figs['MoSRv2'][2], per_forward_by_row=json.dumps(c_figs['MoSRv2'][3]), **serve)

    me = MOESR
    n_moesr = 1 + me['n_blocks'] * (2 * me['n_block'] + 1 + 6 + 1) + 1  # in_to_dim, blocks and MSGs, head
    serve, c_figs['MoESR'] = conv_family(
        'moesr', me, make_moesr(me['dim'], me['n_blocks'], me['n_block'], me['scale'],
                                expansion_factor=me['expansion'], expansion_msg=me['expansion'], seed=0), 'MoESR',
        {'dim': 64, 'n_blocks': 6, 'n_block': 6, 'scale': 4, 'expansion_factor': 2.5, 'expansion_msg': 2.5,
         'upsampler': 'pixelshuffledirect', 'upsample_dim': 64}, n_moesr, MODEL_TOL,
        extra_models=(('dysample_2x_model', make_moesr(32, 1, 2, 2, upsampler='dysample', upsample_dim=16, seed=1),
                       1 + 4 + 8 + 1),))
    log('moesr_serve', launches=c_figs['MoESR'][0], launches_per_bench_forward=c_figs['MoESR'][1],
        conv_ms_per_bench_forward=c_figs['MoESR'][2], per_forward_by_row=json.dumps(c_figs['MoESR'][3]), **serve)

    g2 = GATERV2
    n_gaterv2 = 1 + len(g2['enc_blocks']) + len(g2['dec_blocks']) + 1  # in_to_dim, scale.0 per stage, dim_to_in
    serve, c_figs['GateRv2'] = conv_family(
        'gaterv2', g2, make_gaterv2(g2['dim'], g2['enc_blocks'], g2['dec_blocks'], g2['num_latent'], seed=0),
        'GateRv2', {'dim': 32, 'enc_blocks': (2, 2, 4), 'dec_blocks': (4, 2, 2), 'num_latent': 6, 'scale': 1},
        n_gaterv2, GATER_TOL,
        extra_models=(('pixelshuffle_2x_model', make_gaterv2(16, (1, 1), (1, 1), 1, 2, upsampler='pixelshuffle',
                                                              upsample_mid_dim=16, seed=1), 10),))
    log('gaterv2_serve', launches=c_figs['GateRv2'][0], launches_per_bench_forward=c_figs['GateRv2'][1],
        conv_ms_per_bench_forward=c_figs['GateRv2'][2], per_forward_by_row=json.dumps(c_figs['GateRv2'][3]), **serve)

    g3 = GATERV3
    n_gaterv3 = 1 + 3 * (g3['span_blocks'] + 2) + 1 + len(g3['enc_blocks']) + len(g3['dec_blocks']) + 1
    serve, c_figs['GateRV3'] = conv_family(
        'gaterv3', g3, make_gaterv3(g3['dim'], g3['enc_blocks'], g3['dec_blocks'], g3['num_latent'],
                                    attention=g3['attention'], span_blocks=g3['span_blocks'], seed=0), 'GateRV3',
        {'dim': 32, 'enc_blocks': (2, 2, 4), 'dec_blocks': (4, 2, 2), 'num_latent': 4, 'scale': 1,
         'attention': True, 'span_blocks': 4}, n_gaterv3, GATER_TOL,
        extra_models=(('dysample_end_kernel_3_2x_model', make_gaterv3(16, (1, 1), (1, 1), 1, 2, upsampler='dysample',
                                                                       upsample_mid_dim=16, attention=False,
                                                                       span_blocks=1, end_kernel=3, seed=1), 16),
                      ('lda_2x_model', make_gaterv3(16, (1, 1), (1, 1), 1, 2, upsampler='lda', upsample_mid_dim=32,
                                                    span_blocks=1, seed=2), 18)))
    log('gaterv3_serve', launches=c_figs['GateRV3'][0], launches_per_bench_forward=c_figs['GateRV3'][1],
        conv_ms_per_bench_forward=c_figs['GateRV3'][2], per_forward_by_row=json.dumps(c_figs['GateRV3'][3]), **serve)

    # -- the last eight: RTMoSR, SMoSR, RHA, FlexNet (with the window attention) and the spectral four ----------
    from resselt_tpu_torch.zoo import (make_figsr, make_flexnet, make_gfisr, make_gfisrv2, make_lawfft, make_rha,
                                       make_rtmosr, make_smosr)

    def last_eight(stem: str, cfg: dict, sd: dict, expect: dict, n_conv: int, tol: float, extra_models: tuple = (),
                   n_wattn: int | None = None):
        """conv_family's three phases for one of the eight, its serve line
        logged; returns its figures."""
        serve, fig = conv_family(stem, cfg, sd, cfg['name'], expect, n_conv, tol, extra_models, n_wattn=n_wattn)
        if n_wattn is not None:
            serve.update(wattn_launches_per_bench_forward=fig[4][1], wattn_ms_per_bench_forward=fig[4][2])
        log(f'{stem}_serve', launches=fig[0], launches_per_bench_forward=fig[1], conv_ms_per_bench_forward=fig[2],
            per_forward_by_row=json.dumps(fig[3]), **serve)
        return fig

    rt = RTMOSR
    c_figs['RTMoSR'] = last_eight(
        'rtmosr', rt, make_rtmosr(rt['dim'], rt['n_blocks'], rt['scale'], seed=0),
        {'scale': 2, 'dim': 64, 'ffn_expansion': 2.0, 'n_blocks': 2, 'unshuffle_mod': True, 'dccm': True, 'se': True},
        1 + 3 * rt['n_blocks'] + 1, MODEL_TOL,  # stem; fc1, poll.1, fc2 a block; head
        extra_models=(('plain_fc2_4x_model', make_rtmosr(32, 2, 4, unshuffle_mod=False, dccm=False, se=False, seed=1),
                       1 + 2 * 2 + 1),))

    sm = SMOSR
    n_smb = 2 + sm['n_mb'] + 1
    c_figs['SMoSR'] = last_eight(
        'smosr', sm, make_smosr(sm['dim'], sm['n_mb'], sm['scale'], seed=0),
        {'dim': 64, 'scale': 4, 'rep': False, 'n_mb': 2, 'upsampler': 'pixelshuffledirect'},
        2 * n_smb + 1 + 1, LAST_EIGHT_TOL,  # body.0 and body.2 a block; end_block.1; head
        extra_models=(('rep_dysample_2x_model', make_smosr(16, 1, 2, rep=True, upsampler='dysample', seed=1),
                       2 * 4 + 1 + 2),
                      ('pa_up_4x_model', make_smosr(16, 1, 4, upsampler='pa_up', seed=2), 2 * 4 + 1 + 5)))

    rh = RHA
    c_figs['RHA'] = last_eight(
        'rha', rh, make_rha(rh['dim'], rh['scale'], down_list=rh['down_list'], res_blocks=rh['res_blocks'], seed=0),
        {'dim': 64, 'scale': 4, 'down_list': (8, 4, 2, 1), 'res_blocks': 6, 'expansion_ratio': 1.5,
         'upsample': 'pixelshuffle', 'window_size': 8, 'unshuffle_mod': False},
        1 + 2 * len(rh['down_list']) * rh['res_blocks'] + 4, LAST_EIGHT_TOL,  # stem; fc1, fc2 a block; the tail's 4
        extra_models=(('unshuffle_2x_model', make_rha(32, 2, mid_dim=32, down_list=(2, 1), res_blocks=2,
                                                      upsample='pixelshuffledirect', unshuffle_mod=True, seed=1),
                       1 + 8 + 1),))

    fx = FLEXNET
    n_groups = len(fx['num_blocks'])
    c_figs['FlexNet'] = last_eight(
        'flexnet', fx, make_flexnet(fx['dim'], fx['num_blocks'], fx['scale'], window_size=fx['window_size'],
                                    hidden_rate=fx['hidden_rate'], seed=0),
        {'dim': 64, 'scale': 4, 'num_blocks': (6,) * 6, 'window_size': 8, 'hidden_rate': 4, 'pipeline_type': 'linear',
         'upsampler': 'ps'},
        2 + 1 + 2 * n_groups + 1, LAST_EIGHT_TOL, n_wattn=sum(fx['num_blocks']),  # short cut; stem; ConvBlocks; head
        extra_models=(('meta_dys_2x_model', make_flexnet(16, (1, 1, 1, 1), 2, hidden_rate=2, pipeline_type='meta',
                                                         upsampler='dys', seed=1), 2 + 1 + 14 + 6, 6, 1),
                      ('linear_n+c_4x_channel_norm_model', make_flexnet(32, (3, 1), 4, hidden_rate=2, channel_norm=True,
                                                                        upsampler='n+c', seed=2),
                       2 + 1 + 4 + 1 + 4, 4, 0)))
    w_figs_flexnet = {'wattn': c_figs['FlexNet'][4]}

    gf = GFISR
    c_figs['GFISR'] = last_eight(
        'gfisr', gf, make_gfisr(gf['dim'], gf['n_blocks'], gf['scale'], seed=0),
        {'dim': 64, 'n_blocks': 24, 'scale': 4, 'expansion_ratio': 1.5, 'fft_mode': True,
         'upsampler': 'pixelshuffledirect', 'pixel_unshuffle': False},
        1 + 2 * gf['n_blocks'] + 1, LAST_EIGHT_TOL,
        extra_models=(('unshuffle_2x_pa_up_model', make_gfisr(16, 5, 2, upsampler='pa_up', mid_dim=16,
                                                              pixel_unshuffle=True, seed=1), 1 + 10 + 5),
                      ('lda_2x_model', make_gfisr(16, 5, 2, upsampler='lda', mid_dim=16, seed=2), 1 + 10 + 2)))
    g2_ = GFISRV2
    c_figs['GFISRV2'] = last_eight(
        'gfisrv2', g2_, make_gfisrv2(g2_['dim'], g2_['n_blocks'], g2_['scale'], seed=0),
        {'dim': 64, 'n_blocks': 22, 'scale': 4, 'expansion_ratio': 1.5, 'upsampler': 'pixelshuffledirect',
         'pixel_unshuffle': False},
        1 + 2 * g2_['n_blocks'] + 2 + 1, LAST_EIGHT_TOL,
        extra_models=(('transpose_conv_3x_model', make_gfisrv2(16, 4, 3, upsampler='transpose+conv', mid_dim=16,
                                                               seed=1), 1 + 8 + 2 + 1),))
    fg = FIGSR
    c_figs['FIGSR'] = last_eight(
        'figsr', fg, make_figsr(fg['dim'], fg['n_blocks'], fg['scale'], seed=0),
        {'dim': 64, 'n_blocks': 18, 'scale': 4, 'expansion_ratio': 2.0, 'gc': 8, 'square_kernel_size': 3,
         'band_kernel_size': 11},
        1 + 3 * fg['n_blocks'] + 1 + 1, LAST_EIGHT_TOL,
        extra_models=(('square_5_dysample_2x_model', make_figsr(16, 2, 2, upsampler='dysample', mid_dim=16, gc=4,
                                                                square_kernel_size=5, seed=1), 1 + 4 + 1 + 1),))
    lw = LAWFFT
    c_figs['LAWFFT'] = last_eight(
        'lawfft', lw, make_lawfft(lw['dim'], lw['n_rblock'], lw['n_mblock'], lw['scale'], seed=0),
        {'dim': 64, 'n_rblock': 4, 'n_mblock': 6, 'scale': 4, 'window_size': 8, 'upsampler': 'pixelshuffledirect',
         'unshuffle_mod': False},
        2, LAST_EIGHT_TOL,
        extra_models=(('unshuffle_2x_pixelshuffle_model', make_lawfft(16, 1, 2, 2, unshuffle_mod=True,
                                                                      upsampler='pixelshuffle', mid_dim=16, seed=1),
                       1 + 4),))

    # -- the serving side: the graph path, int8, the cache and the tools ---------------------------------------
    log('graph', f32_tol=GRAPH_F32_TOL, **phase_graph())
    log('int8', per_conv_tol=f'{INT8_TOL} x max|y|', psnr_floor_db=BF16_PSNR,
        **{k: json.dumps(v) for k, v in phase_int8().items()})
    with tempfile.TemporaryDirectory() as tmp:
        log('cache_tools', **phase_cache_tools(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        log('cli_sizes', sizes=json.dumps(CLI_SIZES), **phase_cli_sizes(tmp))

    w_figs = {'ATD-light': atd_fig, 'HAT-S': hat_fig, 'DAT-S': dat_fig, 'RGT-S': rgt_fig, 'DRCT': drct_fig,
              'FDAT-M': fdat_fig, 'OmniSR': omni_fig, 'FlexNet': w_figs_flexnet}
    head = next(r for r in rows if r['name'] == 'rdb stage0 64->192')
    lk_head = next(r for r in lk_rows if r['name'] == 'bench 16->16')
    w_head = next(r for r in w_rows if r['name'] == 'bench masked')
    m_head = next(r for r in m_rows if r['name'] == 'bench')
    g_head = next(r for r in g_rows if r['name'] == 'bench gather bfloat16')
    kernels = [{
        'name': 'fused_conv3x3_act',
        'route': 'cuda',
        'source': 'resselt_tpu_torch/csrc/conv3x3.cu',
        'replaces': 'resselt_tpu/ops/fused_conv.py:59',
        'launches': launches + sum(f[0] for f in c_figs.values()),
        'launches_by_path': {'ESRGAN': launches, **{k: f[0] for k, f in c_figs.items()}},
        'max_abs_err': max(r['max_abs_err_bf16'] for r in rows + f_rows),
        'ms': head['ms'],
        'plain_ms': head['plain_ms'],
        'bound_ms': head['bound_ms'],
        'bound_by': head['bound_by'],
        'library_ms': head['library_ms'],
        'timed_shape': head['name'] + ' bf16 ' + 'x'.join(map(str, head['shape'])),
        'ms_per_bench_forward': conv_ms,
        'ms_per_bench_forward_by_path': {'ESRGAN': conv_ms, **{k: f[2] for k, f in c_figs.items()}},
        'over_bound_ms_per_bench_forward': over_bound_ms(rows),
        'shapes': rows,
        'family_shapes': f_rows,
    }, {
        'name': 'fused_conv_lk',
        'route': 'cuda',
        'source': 'resselt_tpu_torch/csrc/conv_lk.cu',
        'replaces': 'resselt_tpu/ops/fused_conv.py:288',
        'launches': lk_launches,
        'max_abs_err': max(r['max_abs_err_bf16'] for r in lk_rows),
        'ms': lk_head['ms'],
        'plain_ms': lk_head['plain_ms'],
        'bound_ms': lk_head['bound_ms'],
        'bound_by': lk_head['bound_by'],
        'library_ms': lk_head['library_ms'],
        'timed_shape': f"PLKSR bench bf16 {'x'.join(map(str, lk_head['shape']))} k{lk_head['k']}",
        'ms_per_bench_forward': lk_ms,
        'over_bound_ms_per_bench_forward': over_bound_ms(lk_rows),
        'shapes': lk_rows,
    }, {
        'name': 'window_mha',
        'route': 'cuda',
        'source': 'resselt_tpu_torch/csrc/window_attn.cu',
        'replaces': 'resselt_tpu/ops/window_attention.py:32',
        'launches': w_launches + sum(f['wattn'][0] for f in w_figs.values()),
        'launches_by_path': {'SwinIR-M': w_launches, **{k: f['wattn'][0] for k, f in w_figs.items()}},
        'max_abs_err': max(r['max_abs_err_bf16'] for r in w_rows),
        'ms': w_head['ms'],
        'plain_ms': w_head['plain_ms'],
        'bound_ms': w_head['bound_ms'],
        'bound_by': w_head['bound_by'],
        'library_ms': w_head['library_ms'],
        'library_kernels': w_head['library_kernels'],
        'timed_shape': (f"SwinIR-M bench masked bf16 {w_head['windows']} windows x {w_head['n']} tokens, "
                        f"C {w_head['c']}, {w_head['heads']} heads, nW {w_head['mask_windows']}"),
        'ms_per_bench_forward': w_ms,
        'ms_per_bench_forward_by_path': {'SwinIR-M': w_ms, **{k: f['wattn'][2] for k, f in w_figs.items()}},
        'over_bound_ms_per_bench_forward_by_path': {
            'SwinIR-M': over_bound_ms(w_rows) - sum(over_bound_ms(w_rows, f'{k} ') for k in w_figs),
            **{k: over_bound_ms(w_rows, f'{k} ') for k in w_figs}},
        'shapes': w_rows,
    }, {
        'name': 'fused_molrcm',
        'route': 'cuda',
        'source': 'resselt_tpu_torch/csrc/molrcm.cu',
        'replaces': 'resselt_tpu/ops/molrcm.py:80',
        'launches': m_launches,
        'max_abs_err': max(r['max_abs_err_bf16'] for r in m_rows),
        'ms': m_head['ms'],
        'plain_ms': m_head['plain_ms'],
        'bound_ms': m_head['bound_ms'],
        'bound_by': m_head['bound_by'],
        'library_ms': None,
        'library_note': 'no single PyTorch call computes MOLRCM; eager_chain_ms is the eager bf16 chain of calls',
        'eager_chain_ms': m_head['eager_chain_ms'],
        'timed_shape': f"EIMN_L bench bf16 {'x'.join(map(str, m_head['shape']))}",
        'ms_per_bench_forward': m_ms,
        'over_bound_ms_per_bench_forward': over_bound_ms(m_rows),
        'shapes': m_rows,
    }, {
        'name': 'row_gather',
        'route': 'cuda',
        'source': 'resselt_tpu_torch/csrc/row_gather.cu',
        'replaces': 'tools/probe_acmsa_gather.py:39',
        'launches': atd_fig['gather'][0],
        'max_abs_err': max(r['max_abs_err'] for r in g_rows),
        'ms': g_head['ms'],
        'plain_ms': g_head['plain_ms'],
        'bound_ms': g_head['bound_ms'],
        'bound_by': g_head['bound_by'],
        'library_ms': g_head['library_ms'],
        'timed_shape': (f"ATD-light bench qkv gather bf16 {g_head['rows_out']} rows x {g_head['width']}, "
                        f"{g_head['idx']} indices"),
        'ms_per_bench_forward': atd_fig['gather'][2],
        'over_bound_ms_per_bench_forward': over_bound_ms(g_rows),
        'shapes': g_rows,
    }]
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
