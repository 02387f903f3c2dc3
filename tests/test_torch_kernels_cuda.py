"""The port's CUDA kernels (conv3x3, conv_lk, window_attn, molrcm,
row_gather) and main paths (ESRGAN, PLKSR, RealPLKSR, SwinIR, EIMN, ATD,
HAT, DAT, RGT, DRCT, FDAT, OmniSR, Compact, SPAN, SPANPlus, MoSR, SpanPP,
RCAN, CUGAN, GateR, MoSRv2, MoESR, GateRv2, GateRV3, RTMoSR, SMoSR, RHA,
FlexNet, GFISR, GFISRV2, FIGSR, LAWFFT) on the card.  Needs an NVIDIA GPU
and nvcc; every test here is marked ``cuda`` and skips without a card.

This file imports torch and resselt_tpu_torch only, so that it runs where
JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

f32 is held to 1e-4 against the plain version with TF32 off (exact f32
FMA); bf16 and fp16 to 2e-2 relative against the plain version in f32 from
the same 16-bit inputs (the output's rounding); the window attention in
bf16 and fp16 also to 1e-2 absolute, since P is rounded before P V.  The MOLRCM
kernel is held in f32 to 1.5e-3 x max|plain| (tests/test_pallas_ops.py's
tolerance for the JAX kernel).  The row gather is held to exact equality.
"""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.ops import row_gather, row_gather_ref
from resselt_tpu_torch.ops import fused_conv as fc
from resselt_tpu_torch.ops import molrcm as mo
from resselt_tpu_torch.ops import window_attention as wa
from resselt_tpu_torch.parallel import upscale_tiled
from resselt_tpu_torch.zoo import (make_atd, make_compact, make_cugan, make_dat, make_drct, make_eimn, make_esrgan,
                                   make_fdat, make_figsr, make_flexnet, make_gater, make_gaterv2, make_gaterv3,
                                   make_gfisr, make_gfisrv2, make_hat, make_lawfft, make_moesr, make_mosr, make_mosrv2,
                                   make_omni, make_plksr, make_rcan, make_realplksr, make_rgt, make_rha, make_rtmosr,
                                   make_smosr, make_span, make_spanplus, make_spanpp, make_swinir)


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    return torch.device('cuda')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('act', ['linear', 'lrelu', 'silu', 'mish'])
@pytest.mark.parametrize('n,h,w,cin,cout', [(2, 37, 29, 64, 192), (1, 16, 16, 3, 64), (3, 20, 70, 32, 160),
                                            (1, 33, 17, 64, 3), (2, 9, 40, 12, 64), (1, 5, 5, 48, 96),
                                            (1, 1, 1, 64, 64), (1, 7, 3, 256, 320),
                                            # the wgmma path's other N tiles (8, 16, 32, 48, 80), a split with a
                                            # ragged last slice, odd Cout through the 2-byte stores
                                            (2, 19, 35, 64, 8), (1, 40, 23, 32, 16), (1, 17, 50, 16, 24),
                                            (2, 31, 18, 48, 48), (1, 25, 33, 32, 128), (1, 21, 37, 64, 100),
                                            (1, 18, 20, 32, 7), (3, 64, 64, 64, 64)])
def test_kernel_matches_plain(cuda, dtype, act, n, h, w, cin, cout):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
    wt = torch.randn((cout, cin, 3, 3), generator=g, device=cuda) / (3 * cin ** 0.5)
    b = torch.randn((cout,), generator=g, device=cuda)
    taps = fc.pack_conv3x3_weight(wt, dtype)
    before = fc.fused_conv3x3_act.launches
    shape_before = fc.fused_conv3x3_act.by_shape[(n, h, w, cin, cout, act)]
    got = fc.fused_conv3x3_act(x, taps, b, act=act)
    torch.cuda.synchronize()
    assert fc.fused_conv3x3_act.launches == before + 1 and got.dtype == dtype
    assert fc.fused_conv3x3_act.by_shape[(n, h, w, cin, cout, act)] == shape_before + 1
    want = fc.fused_conv3x3_act_ref(x.float(), taps.float(), b, act=act)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
def test_pack2_and_no_bias(cuda, dtype):
    x = torch.randn((2, 24, 30, 64), device=cuda).to(dtype)
    wt = torch.randn((48, 64, 3, 3), device=cuda) / 24
    before = fc.fused_conv3x3_pack2.launches
    got = fc.fused_conv3x3_pack2(x, wt, None, act='lrelu')
    torch.cuda.synchronize()
    assert fc.fused_conv3x3_pack2.launches == before + 1
    want = fc.fused_conv3x3_pack2_ref(x.float(), wt.to(dtype).float(), None, act='lrelu')
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-3)
    torch.testing.assert_close(got.float(), want, rtol=tol[0], atol=tol[1])


def test_kernel_refuses_what_it_does_not_take(cuda):
    taps = fc.pack_conv3x3_weight(torch.zeros((8, 8, 3, 3), device=cuda))
    with pytest.raises(TypeError):
        fc.fused_conv3x3_act(torch.zeros((1, 4, 4, 8), device=cuda, dtype=torch.float64), taps.double())
    with pytest.raises(ValueError):  # not contiguous
        fc.fused_conv3x3_act(torch.zeros((1, 4, 8, 4), device=cuda).transpose(2, 3), taps)
    with pytest.raises(ValueError):  # packed weight in another dtype
        fc.fused_conv3x3_act(torch.zeros((1, 4, 4, 8), device=cuda, dtype=torch.bfloat16), taps)
    with pytest.raises(ValueError):  # channel mismatch
        fc.fused_conv3x3_act(torch.zeros((1, 4, 4, 16), device=cuda), taps)


def test_empty_input_launches_nothing(cuda):
    taps = fc.pack_conv3x3_weight(torch.zeros((8, 8, 3, 3), device=cuda))
    before = fc.fused_conv3x3_act.launches
    got = fc.fused_conv3x3_act(torch.zeros((0, 4, 4, 8), device=cuda), taps)
    assert got.shape == (0, 4, 4, 8) and fc.fused_conv3x3_act.launches == before


@pytest.mark.parametrize('scale,in_nc', [(4, 3), (2, 3), (4, 12)])
def test_esrgan_on_card_matches_cpu(cuda, scale, in_nc):
    sd = make_esrgan(16, 2, scale, in_nc=in_nc, gc=8, seed=scale)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, 19, 23, 3), dtype=np.float32)
    before = fc.fused_conv3x3_act.launches
    got = gpu(x)
    torch.cuda.synchronize()
    n_up = 2 if gpu.config.scale == 4 else 1
    assert fc.fused_conv3x3_act.launches - before == 2 * 3 * 5 + 2 + n_up + 2
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=5e-4)


def test_tiled_on_card_matches_cpu(cuda):
    sd = make_esrgan(16, 1, 2, gc=8, seed=5)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32, halo=8)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32, halo=8).numpy(), rtol=0, atol=5e-4)


# -- the large-kernel conv (csrc/conv_lk.cu) ----------------------------------


def _lk_check(cuda, dtype, n, h, w, cin, cout, k, act, bias=True, pitch=None, c0=0, path=None):
    """One launch against the plain version, counted once in total, per
    shape and on one path: 'f32' in f32, else a 16-bit path (``path`` where
    given)."""
    g = torch.Generator(device=cuda).manual_seed(k * 100 + cin)
    xw = torch.randn((n, h, w, pitch or cin), generator=g, device=cuda).to(dtype)
    x = xw[..., c0:c0 + cin]
    wt = torch.randn((cout, cin, k, k), generator=g, device=cuda) / (k * cin ** 0.5)
    b = torch.randn((cout,), generator=g, device=cuda) if bias else None
    taps = fc.pack_conv_lk_weight(wt, dtype)
    key = (n, h, w, cin, cout, k, act)
    before, shape_before = fc.fused_conv_lk.launches, fc.fused_conv_lk.by_shape[key]
    paths_before = {p: fc.fused_conv_lk.by_path[(key, p)] for p in (*fc.LK_PATHS, 'f32')}
    got = fc.fused_conv_lk(x, taps, b, k=k, act=act)
    torch.cuda.synchronize()
    assert fc.fused_conv_lk.launches == before + 1 and fc.fused_conv_lk.by_shape[key] == shape_before + 1
    took = [p for p, c in paths_before.items() if fc.fused_conv_lk.by_path[(key, p)] == c + 1]
    assert len(took) == 1 and (took[0] == 'f32') == (dtype == torch.float32), took
    if path is not None and dtype != torch.float32:
        assert took == [path]
    assert got.dtype == dtype and got.shape == (n, h, w, cout) and got.is_contiguous()
    want = fc.fused_conv_lk_ref(x.float(), taps.float(), b, k=k, act=act)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('act', ['linear', 'lrelu'])
@pytest.mark.parametrize('k', [5, 13, 17, 31])
@pytest.mark.parametrize('cin,cout', [(8, 8), (16, 16), (16, 5), (32, 24), (64, 64), (64, 40)])
def test_lk_kernel_matches_plain(cuda, dtype, act, k, cin, cout):
    _lk_check(cuda, dtype, 2, 37, 45, cin, cout, k, act)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('n,h,w', [(1, 1, 1), (1, 1, 19), (3, 7, 2), (1, 19, 200), (2, 33, 17), (1, 64, 127)])
def test_lk_kernel_odd_and_tiny_images(cuda, dtype, n, h, w):
    _lk_check(cuda, dtype, n, h, w, 16, 16, 17, 'linear')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('pitch,c0', [(64, 0), (20, 0), (64, 48), (24, 3)])
def test_lk_kernel_reads_a_channel_slice_in_place(cuda, dtype, pitch, c0):
    """x[..., c0:c0 + 16] of a wider tensor; c0 = 0 is PLKSR's partial
    conv (pitch 20 and c0 = 3 take the kernel's unvectorised loads)."""
    _lk_check(cuda, dtype, 2, 30, 41, 16, 16, 17, 'lrelu', pitch=pitch, c0=c0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('n,h,w,cin,cout,k,act,pitch,c0,path', [
    (1, 17, 257, 16, 16, 17, 'lrelu', 64, 16, 'stacked'),  # a second 256-column tile one column wide
    (2, 20, 260, 16, 8, 17, 'linear', 16, 0, 'stacked'),    # 8 output rows a tile
    (1, 1, 300, 16, 5, 13, 'linear', 16, 0, 'stacked'),     # Cout 5, one row
    (2, 33, 17, 16, 16, 17, 'linear', 24, 3, 'mma'),        # pixels not 16-byte aligned
    (3, 15, 17, 8, 8, 3, 'lrelu', 8, 0, 'mma'),             # Cin 8
    (4, 96, 128, 8, 8, 17, 'lrelu', 8, 0, 'mma'),           # Cin 8, a grid that fills the card
    (1, 21, 23, 64, 40, 31, 'linear', 64, 0, 'mma'),        # k 31 at Cin 64: the tiles path's halos do not fit
    (1, 40, 70, 16, 16, 31, 'lrelu', 16, 0, 'tiles'),       # k 31: the stacked path's weights do not fit
    (2, 37, 45, 32, 24, 13, 'lrelu', 48, 16, 'mma'),        # Cin 32, a 16-byte aligned slice at an offset
    (2, 37, 45, 64, 24, 13, 'lrelu', 96, 32, 'tiles'),      # a slice at an offset
    (1, 300, 15, 64, 64, 3, 'linear', 64, 0, 'tiles'),      # k 3
])
def test_lk_kernel_paths_match_plain(cuda, dtype, n, h, w, cin, cout, k, act, pitch, c0, path):
    """The edges of the three 16-bit paths, each counted (by_path) on the
    path csrc/conv_lk.cu's plan gives it."""
    _lk_check(cuda, dtype, n, h, w, cin, cout, k, act, pitch=pitch, c0=c0, path=path)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_lk_kernel_no_bias(cuda, dtype):
    _lk_check(cuda, dtype, 1, 20, 24, 32, 32, 9, 'linear', bias=False)


def test_lk_kernel_refuses_what_it_does_not_take(cuda):
    taps = fc.pack_conv_lk_weight(torch.zeros((16, 16, 17, 17), device=cuda))
    with pytest.raises(TypeError):
        fc.fused_conv_lk(torch.zeros((1, 8, 8, 16), device=cuda, dtype=torch.float64), taps.double())
    with pytest.raises(ValueError):  # pixels not at one pitch
        fc.fused_conv_lk(torch.zeros((1, 8, 16, 16), device=cuda).transpose(1, 2), taps)
    with pytest.raises(ValueError):  # packed weight in another dtype
        fc.fused_conv_lk(torch.zeros((1, 8, 8, 16), device=cuda, dtype=torch.bfloat16), taps)
    with pytest.raises(ValueError):  # weight for other input channels
        fc.fused_conv_lk(torch.zeros((1, 8, 8, 16), device=cuda), fc.pack_conv_lk_weight(torch.zeros((8, 8, 17, 17),
                                                                                                    device=cuda)))
    with pytest.raises(ValueError):  # weight for another k
        fc.fused_conv_lk(torch.zeros((1, 8, 8, 16), device=cuda), taps, k=13)
    with pytest.raises(ValueError):  # outside lk_conv_supported
        fc.fused_conv_lk(torch.zeros((1, 8, 8, 24), device=cuda), torch.zeros((24, 24, 17, 17), device=cuda))


def test_lk_empty_input_launches_nothing(cuda):
    taps = fc.pack_conv_lk_weight(torch.zeros((16, 16, 17, 17), device=cuda))
    before = fc.fused_conv_lk.launches
    got = fc.fused_conv_lk(torch.zeros((0, 8, 8, 16), device=cuda), taps)
    assert got.shape == (0, 8, 8, 16) and fc.fused_conv_lk.launches == before


@pytest.mark.parametrize('variant', ['plksr', 'realplksr', 'realplksr_dys3'])
def test_plksr_on_card_matches_cpu(cuda, variant):
    if variant == 'plksr':
        sd, scale = make_plksr(32, 2, 4, kernel_size=17, seed=1), 4
    else:
        scale = 3 if variant == 'realplksr_dys3' else 2
        sd = make_realplksr(32, 2, scale, kernel_size=13, dysample=variant == 'realplksr_dys3', seed=2)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, 21, 26, 3), dtype=np.float32)
    before = fc.fused_conv_lk.launches
    got = gpu(x)
    torch.cuda.synchronize()
    assert fc.fused_conv_lk.launches - before == 2
    assert got.shape == (2, 21 * scale, 26 * scale, 3)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=5e-4)


def test_plksr_tiled_on_card_matches_cpu(cuda):
    sd = make_plksr(32, 1, 2, kernel_size=17, seed=3)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32).numpy(), rtol=0, atol=5e-4)


# -- window attention (csrc/window_attn.cu) -----------------------------------

WATTN_BF16_TOL = (2e-2, 1e-2)  # rtol, atol: P rounded to bf16 before P V, and the bf16 output


def _wattn_check(cuda, dtype, windows, n, c, heads, nw=None, qkv=True, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if qkv:  # q, k, v as channel slices of one projection, as the model hands them
        t = torch.randn((windows, n, 3 * c), generator=g, device=cuda).to(dtype)
        q, k, v = t[..., :c], t[..., c:2 * c], t[..., 2 * c:]
    else:
        q, k, v = (torch.randn((windows, n, c), generator=g, device=cuda).to(dtype) for _ in range(3))
    bias = torch.randn((heads, n, n), generator=g, device=cuda) * 0.5
    mask = None
    if nw is not None:
        mask = torch.where(torch.rand((nw, n, n), generator=g, device=cuda) < 0.3, -100.0, 0.0)
    scale = (c // heads) ** -0.5
    key = (windows, n, c, heads, mask is not None)
    before, shape_before = wa.window_mha.launches, wa.window_mha.by_shape[key]
    got = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=scale)
    torch.cuda.synchronize()
    assert wa.window_mha.launches == before + 1 and wa.window_mha.by_shape[key] == shape_before + 1
    assert got.dtype == dtype and got.shape == (windows, n, c) and got.is_contiguous()
    want = wa.window_mha_ref(q.float(), k.float(), v.float(), bias, mask, num_heads=heads, scale=scale)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=WATTN_BF16_TOL[0], atol=WATTN_BF16_TOL[1])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('windows,n,c,heads,nw', [
    (64, 64, 180, 6, 16), (64, 64, 180, 6, None),  # SwinIR-M / HAT-L / SwinIR-L
    (32, 64, 60, 6, 8),                             # SwinIR-light
    (24, 128, 180, 6, 4),                           # DAT-S rectangles
    (8, 256, 144, 6, None), (8, 256, 144, 6, 4),    # HAT-S
    (8, 256, 48, 4, 2), (8, 256, 48, 4, None),      # ATD-light
    (18, 49, 180, 6, 9), (6, 49, 60, 6, None),      # window 7
    (5, 1, 8, 1, None), (3, 17, 64 * 3, 3, 3), (4, 250, 21, 3, 2),  # odd n, head_dim 64, odd head_dim
])
def test_window_kernel_matches_plain(cuda, dtype, windows, n, c, heads, nw):
    _wattn_check(cuda, dtype, windows, n, c, heads, nw)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
def test_window_kernel_contiguous_inputs(cuda, dtype):
    _wattn_check(cuda, dtype, 16, 64, 96, 4, 4, qkv=False)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('scale', [-0.25, 0.0])
def test_window_kernel_nonpositive_scale(cuda, dtype, scale):
    """The 16-bit kernel works on scores over scale; the wrapper hands it an
    equivalent problem with a positive scale."""
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn((12, 64, 3 * 96), generator=g, device=cuda).to(dtype)
    q, k, v = qkv[..., :96], qkv[..., 96:192], qkv[..., 192:]
    bias = torch.randn((4, 64, 64), generator=g, device=cuda) * 0.5
    got = wa.window_mha(q, k, v, bias, None, num_heads=4, scale=scale)
    want = wa.window_mha_ref(q.float(), k.float(), v.float(), bias, None, num_heads=4, scale=scale)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else WATTN_BF16_TOL
    torch.testing.assert_close(got.float(), want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('kind', ['shift', 'zero', 'one_window'])
@pytest.mark.parametrize('ws,c,heads', [(8, 180, 6), (16, 144, 6), (16, 48, 4), (7, 60, 6)])
def test_window_kernel_skips_zero_mask_windows(cuda, dtype, kind, ws, c, heads):
    """The model's own shift mask (only the last row and column of windows
    are non-zero), an all-zero mask, and a mask with one non-zero window:
    the 16-bit kernel skips the all-zero tiles and gives what the plain
    version gives with the whole mask."""
    from resselt_tpu_torch.nn.window import swin_attn_mask

    side, n = 4, ws * ws
    mask = torch.from_numpy(swin_attn_mask(side * ws, side * ws, ws, ws // 2)).to(cuda)
    if kind == 'zero':
        mask = torch.zeros_like(mask)
    elif kind == 'one_window':
        mask = torch.zeros_like(mask)
        mask[5] = torch.where(torch.rand((n, n), device=cuda) < 0.5, -100.0, 0.0)
    assert int(wa.mask_window_flags(mask).sum()) == {'shift': 2 * side - 1, 'zero': 0, 'one_window': 1}[kind]
    g = torch.Generator(device=cuda).manual_seed(ws)
    qkv = torch.randn((3 * side * side, n, 3 * c), generator=g, device=cuda).to(dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn((heads, n, n), generator=g, device=cuda) * 0.5
    scale = (c // heads) ** -0.5
    got = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=scale)
    want = wa.window_mha_ref(q.float(), k.float(), v.float(), bias, mask, num_heads=heads, scale=scale)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else WATTN_BF16_TOL
    torch.testing.assert_close(got.float(), want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('split,c,heads,side', [((8, 16), 90, 3, 64), ((16, 8), 90, 3, 64), ((8, 32), 90, 3, 64),
                                                ((32, 8), 90, 3, 96), ((2, 4), 12, 1, 16)])
def test_window_kernel_rectangular_shift_masks(cuda, dtype, split, c, heads, side):
    """DAT's and RGT's rectangular windows with the model's own shift mask
    (``rect_attn_mask``), q, k, v read in place at C = 90: the 16-bit kernel
    skips the windows whose tile is all zero and gives what the plain
    version gives with the whole mask."""
    from resselt_tpu_torch.nn.window import rect_attn_mask

    sh, sw = split
    mask = torch.from_numpy(rect_attn_mask(side, side, sh, sw, sh // 2, sw // 2)).to(cuda)
    flags = wa.mask_window_flags(mask)
    assert torch.equal(flags.bool(), (mask != 0).flatten(1).any(1))
    assert int(flags.sum()) == side // sh + side // sw - 1  # the last row and column of windows
    n, nw = sh * sw, mask.shape[0]
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn((2 * nw, n, 3 * c), generator=g, device=cuda).to(dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn((heads, n, n), generator=g, device=cuda) * 0.5
    scale = (c // heads) ** -0.5
    got = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=scale)
    want = wa.window_mha_ref(q.float(), k.float(), v.float(), bias, mask, num_heads=heads, scale=scale)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else WATTN_BF16_TOL
    torch.testing.assert_close(got.float(), want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('windows,n,c,heads,nw', [
    (32, 256, 212, 4, 16), (16, 256, 212, 4, None),  # DRCT swin2: head_dim 53, heads 2-byte aligned only
    (32, 256, 276, 6, 16), (16, 256, 276, 6, None),  # DRCT swin4: head_dim 46
    (6, 100, 106, 2, 3), (5, 200, 276, 6, None),     # other n
])
def test_window_kernel_head_dim_53_and_46_in_place(cuda, dtype, windows, n, c, heads, nw):
    _wattn_check(cuda, dtype, windows, n, c, heads, nw, seed=c)


def test_window_kernel_refuses_two_byte_rows_the_wrapper_pads(cuda):
    """The 16-bit kernel stages rows with 4-, 8- or 16-byte copies and
    refuses a head whose rows are only 2-byte aligned (head_dim 53); the
    wrapper zero-pads such heads (the head_dim 53 cases above)."""
    q = torch.zeros((2, 16, 106), device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros((2, 16, 16), device=cuda)
    out = torch.empty_like(q)
    for fn in (wa._lib().resselt_window_attn_bf16, wa._lib().resselt_window_attn_f16):
        for hd, refused in ((53, True), (52, False)):  # 52: the same rows read at 4-byte alignment
            rc = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), bias.data_ptr(), None, None, out.data_ptr(), 2, 16, 2,
                    hd, 106, 16 * 106, 1, 1.0, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            assert (rc != 0) == refused, (hd, rc)


def test_window_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((4, 64, 32), device=cuda)
    bias = torch.zeros((4, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        wa.window_mha(q.double(), q.double(), q.double(), bias, num_heads=4, scale=1.0)
    with pytest.raises(ValueError):  # channels not next to each other
        t = torch.zeros((4, 32, 64), device=cuda).transpose(1, 2)
        wa.window_mha(t, t, t, bias, num_heads=4, scale=1.0)
    with pytest.raises(ValueError):  # q, k, v at different strides
        wa.window_mha(q, torch.zeros((4, 64, 64), device=cuda)[..., :32], q, bias, num_heads=4, scale=1.0)
    with pytest.raises(ValueError):  # outside window_mha_supported
        wa.window_mha(q, q, q, bias, num_heads=3, scale=1.0)


def test_window_kernel_empty_input_launches_nothing(cuda):
    q = torch.zeros((0, 64, 32), device=cuda)
    before = wa.window_mha.launches
    got = wa.window_mha(q, q, q, torch.zeros((4, 64, 64), device=cuda), num_heads=4, scale=1.0)
    assert got.shape == (0, 64, 32) and wa.window_mha.launches == before


@pytest.mark.parametrize('upsampler,scale', [('pixelshuffle', 4), ('nearest+conv', 4), ('', 1)])
def test_swinir_on_card_matches_cpu(cuda, upsampler, scale):
    sd = make_swinir(36, (2, 2), (6, 3), 8, upscale=scale, upsampler=upsampler, img_size=32, seed=1)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, 21, 26, 3), dtype=np.float32)
    before = wa.window_mha.launches
    got = gpu(x)
    torch.cuda.synchronize()
    assert wa.window_mha.launches - before == 4
    assert got.shape == (2, 21 * scale, 26 * scale, 3)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=2e-3)


def test_swinir_tiled_on_card_matches_cpu(cuda):
    sd = make_swinir(24, (2,), (3,), 8, upscale=2, img_size=32, seed=3)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32).numpy(), rtol=0, atol=2e-3)


# -- MOLRCM (csrc/molrcm.cu) ----------------------------------------------------


def _molrcm_params(device, seed=0, bias=True, dim=64):
    """A MOLRCM attention's torch-layout params, scaled so that every stage
    stays of order one."""
    g = torch.Generator(device=device).manual_seed(seed)
    c1, c2 = dim * 3 // 8, dim // 8
    shapes = {'proj_value.0': (dim, dim, 1), 'proj_query.0': (dim, dim, 1), 'region': (dim, 1, 5),
              'spatial_1': (c1, 1, 5), 'spatial_2': (dim - c1 - c2, 1, 7), 'fusion': (dim, dim, 1), 'out': (dim, dim, 1)}
    params = {}
    for name, (o, i, k) in shapes.items():
        params[f'{name}.weight'] = torch.randn((o, i, k, k), generator=g, device=device) / (k * i ** 0.5)
        if bias:
            params[f'{name}.bias'] = torch.randn((o,), generator=g, device=device) * 0.1
    return PTree(params)


def _molrcm_check(cuda, dtype, n, h, w, bias=True, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    x = torch.randn((n, h, w, 64), generator=g, device=cuda).to(dtype)
    packed = mo.pack_molrcm_weights(_molrcm_params(cuda, seed, bias), dtype)
    key = (n, h, w, 64, str(dtype).removeprefix('torch.'))
    before, shape_before = mo.fused_molrcm.launches, mo.fused_molrcm.by_shape[key]
    got = mo.fused_molrcm(x, packed)
    torch.cuda.synchronize()
    assert mo.fused_molrcm.launches == before + 1 and mo.fused_molrcm.by_shape[key] == shape_before + 1
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    want = mo.fused_molrcm_ref(x.float(), packed)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1.5e-3 * float(want.abs().max()))
    else:
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('n,h,w', [(2, 37, 45), (1, 16, 128), (1, 1, 1), (3, 7, 2), (2, 33, 17), (1, 64, 64),
                                   (1, 48, 64), (1, 5, 300),
                                   # the edges of the 16-bit kernel's 16-column strips and runs of rows
                                   (3, 15, 17), (1, 16, 16), (3, 17, 15), (1, 300, 16), (3, 16, 300), (1, 17, 1)])
def test_molrcm_kernel_matches_plain(cuda, dtype, n, h, w):
    _molrcm_check(cuda, dtype, n, h, w)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('n,h,w', [(2, 20, 24), (3, 300, 17)])
def test_molrcm_kernel_no_bias(cuda, dtype, n, h, w):
    _molrcm_check(cuda, dtype, n, h, w, bias=False, seed=3)


def test_molrcm_kernel_refuses_what_it_does_not_take(cuda):
    packed = mo.pack_molrcm_weights(_molrcm_params(cuda))
    with pytest.raises(TypeError):
        mo.fused_molrcm(torch.zeros((1, 8, 8, 64), device=cuda, dtype=torch.float64), packed)
    with pytest.raises(ValueError):  # not contiguous
        mo.fused_molrcm(torch.zeros((1, 8, 64, 8), device=cuda).transpose(2, 3), packed)
    with pytest.raises(ValueError):  # packed weights on the CPU
        mo.fused_molrcm(torch.zeros((1, 8, 8, 64), device=cuda), packed.cpu())
    with pytest.raises(ValueError):  # outside molrcm_supported
        mo.fused_molrcm(torch.zeros((1, 8, 8, 48), device=cuda), packed)


def test_molrcm_empty_input_launches_nothing(cuda):
    packed = mo.pack_molrcm_weights(_molrcm_params(cuda))
    before = mo.fused_molrcm.launches
    got = mo.fused_molrcm(torch.zeros((0, 8, 8, 64), device=cuda), packed)
    assert got.shape == (0, 8, 8, 64) and mo.fused_molrcm.launches == before


def test_eimn_on_card_matches_cpu(cuda):
    sd = make_eimn(64, 2, 1, 2.66, 4, seed=1)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, 21, 26, 3), dtype=np.float32)
    before = mo.fused_molrcm.launches
    got = gpu(x)
    torch.cuda.synchronize()
    assert mo.fused_molrcm.launches - before == 2
    assert got.shape == (2, 84, 104, 3)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=5e-4)


def test_eimn_tiled_on_card_matches_cpu(cuda):
    sd = make_eimn(64, 1, 1, 2.66, 2, seed=3)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32).numpy(), rtol=0, atol=5e-4)


# -- row gather (csrc/row_gather.cu) ---------------------------------------------


def _gather_check(cuda, dtype, idx_dtype, rows_src, rows_out, width, pitch=None, offset=0, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    wide = torch.randn((rows_src, pitch or width), generator=g, device=cuda).to(dtype)
    src = wide[:, offset:offset + width]
    idx = torch.randint(0, rows_src, (rows_out,), generator=g, device=cuda).to(idx_dtype)
    idx[-1] = idx[0]
    key = (rows_out, rows_src, width, str(dtype).removeprefix('torch.'))
    before, shape_before = row_gather.launches, row_gather.by_shape[key]
    got = row_gather(src, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1 and row_gather.by_shape[key] == shape_before + 1
    assert got.dtype == dtype and got.shape == (rows_out, width) and got.is_contiguous()
    assert torch.equal(got, row_gather_ref(src, idx))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('idx_dtype', [torch.int64, torch.int32])
@pytest.mark.parametrize('rows_src,rows_out,width', [
    (4096, 4096, 144), (4096, 4096, 48),        # ATD-light: 16-byte vectors
    (1152, 1280, 630), (1280, 1152, 210),       # ATD: 4-byte vectors in bf16; a pad tail added and skipped
    (1, 1, 48), (1, 7, 3), (1000, 1000, 1), (3000, 17, 45), (5, 100000, 8),
])
def test_row_gather_kernel_is_exact(cuda, dtype, idx_dtype, rows_src, rows_out, width):
    _gather_check(cuda, dtype, idx_dtype, rows_src, rows_out, width)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('width,pitch,offset', [(48, 144, 48), (48, 144, 1), (47, 144, 1), (16, 40, 8), (5, 9, 2)])
def test_row_gather_kernel_reads_a_column_slice_in_place(cuda, dtype, width, pitch, offset):
    _gather_check(cuda, dtype, torch.int64, 3000, 2500, width, pitch=pitch, offset=offset)


def test_row_gather_kernel_reads_a_row_slice_and_past_2gb(cuda):
    """Rows whose byte offset passes 2^31 (row 3,728,271 on): 64-bit addresses."""
    src = torch.randn((5_000_000, 144), device=cuda)  # 2.9 GB
    idx = torch.tensor([4_999_999, 0, 3_900_000, 4_999_999, 3_728_271], device=cuda)
    assert torch.equal(row_gather(src, idx), row_gather_ref(src, idx))
    tail, tail_idx = src[4_000_000:], torch.tensor([999_999, 0, 500_000], device=cuda)
    assert torch.equal(row_gather(tail, tail_idx), row_gather_ref(tail, tail_idx))


def test_row_gather_kernel_refuses_what_it_does_not_take(cuda):
    src = torch.zeros((8, 6), device=cuda)
    idx = torch.zeros((3,), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        row_gather(src.double(), idx)
    with pytest.raises(ValueError):  # elements of a row not next to each other
        row_gather(torch.zeros((6, 8), device=cuda).t(), idx)
    with pytest.raises(ValueError):  # indices on another device
        row_gather(src, idx.cpu())
    with pytest.raises(IndexError):
        row_gather(torch.zeros((0, 6), device=cuda), idx)


def test_row_gather_empty_launches_nothing(cuda):
    before = row_gather.launches
    got = row_gather(torch.zeros((8, 6), device=cuda), torch.zeros((0,), dtype=torch.int64, device=cuda))
    assert got.shape == (0, 6) and row_gather.launches == before


# -- ATD and HAT ---------------------------------------------------------------------


@pytest.mark.parametrize('upsampler,scale', [('pixelshuffledirect', 4), ('pixelshuffle', 2), ('nearest+conv', 4)])
def test_atd_on_card_matches_cpu(cuda, upsampler, scale):
    """The zoo's small weights keep the similarity's argmax apart from its
    runner-up by more than f32 rounding, so the card and the CPU sort the
    tokens into the same categories."""
    sd = make_atd(24, (2, 2), (3, 3), 8, reducted_dim=4, upscale=scale, upsampler=upsampler, seed=1)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, 19, 21, 3), dtype=np.float32)  # 576 tokens: AC_MSA's pad tail
    before = wa.window_mha.launches, row_gather.launches
    got = gpu(x)
    torch.cuda.synchronize()
    assert (wa.window_mha.launches - before[0], row_gather.launches - before[1]) == (4, 8)
    assert got.shape == (2, 19 * scale, 21 * scale, 3)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=2e-3)


def test_atd_tiled_on_card_matches_cpu(cuda):
    sd = make_atd(24, (2,), (3,), 8, reducted_dim=4, upscale=2, seed=3)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32).numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize('window,scale', [(8, 4), (16, 2)])
def test_hat_on_card_matches_cpu(cuda, window, scale):
    sd = make_hat(36, (2, 2), (6, 3), window, 0.5, 3, 6, 2.0, scale, seed=1)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, 21, 26, 3), dtype=np.float32)
    before = wa.window_mha.launches
    got = gpu(x)
    torch.cuda.synchronize()
    assert wa.window_mha.launches - before == 4  # the two OCABs take the plain path
    assert got.shape == (2, 21 * scale, 26 * scale, 3)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=2e-3)


def test_hat_tiled_on_card_matches_cpu(cuda):
    sd = make_hat(24, (2,), (3,), 8, upscale=2, seed=3)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32).numpy(), rtol=0, atol=2e-3)



@pytest.mark.parametrize('variant', ['dat', 'dat_direct_3conv', 'rgt', 'drct', 'drct_plain'])
def test_dat_rgt_drct_on_card_match_cpu(cuda, variant):
    """Window launches per forward: DAT and RGT two per spatial block, DRCT
    one per block whose head_dim is at most 64; the others (embed 128, two
    heads: head_dim 72 to 96 from swin2 on) take the plain path, counted in
    ``multi_head_attention.plain_calls``."""
    from resselt_tpu_torch.nn.window import multi_head_attention

    sd, launches, plain, hw = {
        'dat': (make_dat(36, (4,), (6,), (4, 8), 2.0, 2, seed=1), 4, 0, (18, 22)),
        'dat_direct_3conv': (make_dat(36, (2, 2), (6, 6), (8, 16), 2.0, 4, upsampler='pixelshuffledirect',
                                      resi_connection='3conv', seed=2), 4, 0, (21, 26)),
        'rgt': (make_rgt(36, (4,), (6,), (8, 32), 2.0, 0.5, 2, seed=3), 4, 0, (40, 48)),
        'drct': (make_drct(36, 2, 6, 8, 12, 2.0, 2, img_size=32, seed=4), 10, 0, (21, 26)),
        'drct_plain': (make_drct(128, 1, 2, 8, 16, 2.0, 2, img_size=32, seed=5), 1, 4, (21, 26)),
    }[variant]
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, *hw, 3), dtype=np.float32)
    before = wa.window_mha.launches, multi_head_attention.plain_calls
    got = gpu(x)
    torch.cuda.synchronize()
    assert (wa.window_mha.launches - before[0], multi_head_attention.plain_calls - before[1]) == (launches, plain)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize('family', ['dat', 'rgt', 'drct'])
def test_dat_rgt_drct_tiled_on_card_match_cpu(cuda, family):
    sd = {'dat': lambda: make_dat(24, (2,), (2,), (4, 8), 2.0, 2, seed=3),
          'rgt': lambda: make_rgt(24, (2,), (2,), (4, 8), 2.0, 0.5, 2, seed=3),
          'drct': lambda: make_drct(24, 1, 3, 8, 8, 2.0, 2, img_size=32, seed=3)}[family]()
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32).numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('windows,n,c,heads', [
    (64, 64, 120, 4), (1024, 64, 120, 4), (17, 64, 120, 4),  # FDAT-M: head_dim 30
    (64, 64, 64, 4), (1024, 64, 64, 4), (13, 64, 64, 4),     # OmniSR: head_dim 16
])
def test_window_kernel_fdat_and_omni_shapes(cuda, dtype, windows, n, c, heads):
    _wattn_check(cuda, dtype, windows, n, c, heads)


@pytest.mark.parametrize('variant', ['fdat', 'fdat_unshuffle_lda', 'fdat_dysample', 'omni', 'omni_no_pe'])
def test_fdat_omni_on_card_match_cpu(cuda, variant):
    """Window launches per forward: FDAT one per spatial block, OmniSR two
    per OSA block (block and grid attention); none takes the plain path."""
    from resselt_tpu_torch.nn.window import multi_head_attention

    sd, launches, hw = {
        'fdat': (make_fdat(48, 2, 2, 4, 8, 2.0, 8, 32, 'transpose+conv', 4, seed=1), 4, (21, 26)),
        'fdat_unshuffle_lda': (make_fdat(32, 1, 2, 4, 8, 1.5, 8, 24, 'lda', 2, unshuffle=True, seed=2), 2, (21, 26)),
        'fdat_dysample': (make_fdat(32, 1, 1, 4, 8, 1.5, 8, 24, 'dysample', 2, seed=3), 1, (21, 26)),
        'omni': (make_omni(32, 1, True, 8, 2, 4, seed=4), 4, (22, 18)),
        'omni_no_pe': (make_omni(32, 1, False, 8, 1, 2, seed=5), 2, (22, 18)),
    }[variant]
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, *hw, 3), dtype=np.float32)
    before = wa.window_mha.launches, multi_head_attention.plain_calls
    got = gpu(x)
    torch.cuda.synchronize()
    assert (wa.window_mha.launches - before[0], multi_head_attention.plain_calls - before[1]) == (launches, 0)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize('family', ['fdat', 'omni'])
def test_fdat_omni_tiled_on_card_match_cpu(cuda, family):
    sd = {'fdat': lambda: make_fdat(32, 1, 1, 4, 8, 1.5, 8, 32, 'pixelshuffledirect', 2, seed=3),
          'omni': lambda: make_omni(16, 1, True, 8, 1, 2, seed=3)}[family]()
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32).numpy(), rtol=0, atol=1e-3)


# -- the 3x3-conv families (Compact, SPAN, SPANPlus, MoSR, SpanPP, RCAN; GateR, MoSRv2, MoESR, GateRv2, GateRV3) on
# conv3x3.cu, and CUGAN, which launches no kernel ------------------


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('n,h,w,cin,cout,act', [
    (2, 21, 26, 48, 48, 'silu'), (2, 21, 26, 48, 48, 'mish'), (2, 21, 26, 48, 48, 'linear'),  # SPAN / SPANPlus
    (1, 19, 23, 3, 48, 'linear'), (2, 21, 26, 48, 12, 'linear'), (1, 17, 33, 48, 27, 'linear'),  # stems, heads
    (2, 21, 26, 64, 192, 'linear'), (2, 21, 26, 96, 64, 'mish'), (1, 18, 20, 64, 128, 'mish'),  # MoSR
    (1, 18, 20, 128, 64, 'mish'), (1, 19, 23, 3, 64, 'mish'), (1, 17, 19, 64, 384, 'linear'),
    (1, 20, 22, 64, 256, 'linear'), (1, 9, 11, 12, 64, 'linear'), (1, 9, 11, 48, 64, 'linear'),  # RCAN
    (2, 21, 26, 64, 48, 'linear'),  # Compact's 4x head
    # GateR, MoESR, GateRv2 and GateRV3
    (2, 21, 26, 64, 32, 'linear'), (1, 12, 14, 256, 128, 'linear'), (1, 6, 9, 512, 1024, 'linear'),
    (1, 12, 14, 256, 512, 'linear'), (2, 21, 26, 128, 64, 'linear'), (2, 21, 26, 64, 3, 'linear'),
    (2, 21, 26, 64, 320, 'linear'), (2, 21, 26, 160, 64, 'mish'), (2, 21, 26, 64, 16, 'linear'),
    (1, 19, 23, 3, 32, 'linear'), (2, 21, 26, 32, 32, 'silu'), (2, 21, 26, 32, 32, 'linear'),
    (2, 21, 26, 32, 16, 'linear'), (1, 11, 13, 128, 64, 'linear'), (1, 6, 7, 256, 512, 'linear'),
    (1, 11, 13, 128, 256, 'linear'), (2, 21, 26, 32, 3, 'linear'), (2, 21, 26, 4, 18, 'linear'),
])
def test_kernel_matches_plain_at_the_conv_family_shapes(cuda, dtype, n, h, w, cin, cout, act):
    g = torch.Generator(device=cuda).manual_seed(cin * 1000 + cout)
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
    wt = torch.randn((cout, cin, 3, 3), generator=g, device=cuda) / (3 * cin ** 0.5)
    b = torch.randn((cout,), generator=g, device=cuda)
    taps = fc.pack_conv3x3_weight(wt, dtype)
    before = fc.fused_conv3x3_act.by_shape[(n, h, w, cin, cout, act)]
    got = fc.fused_conv3x3_act(x, taps, b, act=act)
    torch.cuda.synchronize()
    assert fc.fused_conv3x3_act.by_shape[(n, h, w, cin, cout, act)] == before + 1 and got.dtype == dtype
    want = fc.fused_conv3x3_act_ref(x.float(), taps.float(), b, act=act)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=1e-3)


_CONV_FAMILIES = {
    # name: (state dict, conv3x3 launches per forward, with_config overrides)
    'compact': (lambda: make_compact(24, 4, 4, seed=1), 6, None),
    'span': (lambda: make_span(48, 4, seed=2), 21, None),
    'span_no_norm': (lambda: make_span(16, 2, seed=3, norm=False), 21, None),
    'spanplus': (lambda: make_spanplus(48, (2,), 2, seed=4), 15, None),
    'spanplus_dys': (lambda: make_spanplus(16, (1,), 2, seed=5, upsampler='dys'), 11, None),
    'spanplus_conv': (lambda: make_spanplus(16, (1,), 1, seed=6, upsampler='conv'), 12, None),
    'mosr': (lambda: make_mosr(64, 2, 4, seed=7), 10, None),
    'mosr_dys': (lambda: make_mosr(16, 2, 2, seed=8, upsampler='dys'), 9, None),
    'mosr_gps': (lambda: make_mosr(16, 2, 4, seed=9, upsampler='gps'), 10, None),
    'spanpp': (lambda: make_spanpp(48, implicit_dim=32, latent_layers=2, seed=10), 21, None),
    'spanpp_3x': (lambda: make_spanpp(16, implicit_dim=32, latent_layers=2, seed=11), 21, {'eval_scale': 3}),
    'rcan': (lambda: make_rcan(64, 2, 2, 16, 4, seed=12), 2 + 2 * 5 + 3, None),
    'rcan_unshuffle_2x': (lambda: make_rcan(16, 2, 2, 4, 2, unshuffle=True, seed=13), 2 + 2 * 5 + 3, None),
    'rcan_k5': (lambda: make_rcan(16, 1, 1, 4, 4, kernel_size=5, seed=14), 2, None),
    'cugan_2x': (lambda: make_cugan('2x', seed=15), 0, None),
    'gater': (lambda: make_gater(16, (1, 1, 1, 2, 1, 1, 1), seed=16, latent_att=True), 9, None),
    'gater_conv': (lambda: make_gater(16, (1, 1, 1, 2, 1, 1, 1), seed=17), 9, None),
    'mosrv2': (lambda: make_mosrv2(64, 2, 4, seed=18), 8, None),
    'mosrv2_dys_ln_unshuffle': (lambda: make_mosrv2(16, 2, 2, upsampler='dysample', unshuffle_mod=True,
                                                    rms_norm=False, seed=19), 8, None),
    'moesr': (lambda: make_moesr(64, 1, 2, 4, seed=20), 14, None),
    'moesr_nearest': (lambda: make_moesr(16, 1, 1, 2, upsampler='nearest+conv', upsample_dim=16, seed=21), 14, None),
    'gaterv2': (lambda: make_gaterv2(32, (1, 1, 1), (1, 1, 1), 1, seed=22), 8, None),
    'gaterv2_sr': (lambda: make_gaterv2(16, (1, 1), (1, 1), 1, 2, upsampler='pixelshuffle', upsample_mid_dim=16,
                                        seed=23), 10, None),
    'gaterv3': (lambda: make_gaterv3(32, (1, 1, 1), (1, 1, 1), 1, span_blocks=1, seed=24), 18, None),
    'gaterv3_dys': (lambda: make_gaterv3(16, (1, 1), (1, 1), 1, 2, upsampler='dysample', upsample_mid_dim=16,
                                         attention=False, span_blocks=1, end_kernel=3, seed=25), 16, None),
    'gaterv3_lda': (lambda: make_gaterv3(16, (1, 1), (1, 1), 1, 2, upsampler='lda', upsample_mid_dim=32,
                                         span_blocks=1, seed=26), 18, None),
    'rtmosr': (lambda: make_rtmosr(16, 2, 2, seed=27), 8, None),
    'rtmosr_plain_4x': (lambda: make_rtmosr(16, 1, 4, unshuffle_mod=False, dccm=False, se=False, seed=28), 4, None),
    'smosr': (lambda: make_smosr(16, 1, 2, seed=29), 10, None),
    'smosr_rep_dysample': (lambda: make_smosr(16, 1, 2, rep=True, upsampler='dysample', seed=30), 11, None),
    'rha': (lambda: make_rha(16, 2, mid_dim=16, down_list=(2, 1), res_blocks=2, window_size=4, head_dim=4,
                             seed=31), 12, None),
    'rha_unshuffle': (lambda: make_rha(16, 2, mid_dim=16, down_list=(1,), res_blocks=2, unshuffle_mod=True,
                                       window_size=4, head_dim=4, seed=32), 9, None),
    'flexnet': (lambda: make_flexnet(16, (3, 2), 2, hidden_rate=2, seed=33), 8, None),
    'flexnet_meta': (lambda: make_flexnet(16, (1, 1, 1, 1), 2, hidden_rate=2, pipeline_type='meta', seed=34), 24,
                     None),
    'gfisr': (lambda: make_gfisr(16, 3, 2, seed=35), 8, None),
    'gfisrv2': (lambda: make_gfisrv2(16, 3, 2, seed=36), 10, None),
    'figsr': (lambda: make_figsr(16, 2, 2, gc=2, seed=37), 9, None),
    'lawfft': (lambda: make_lawfft(16, 1, 2, 2, seed=38), 2, None),
}


@pytest.mark.parametrize('variant', sorted(_CONV_FAMILIES))
def test_conv_families_on_card_match_cpu(cuda, variant):
    """Every same-padded 3x3 conv with groups 1 of the conv families
    launches the kernel: the counts per forward are the ones their code
    implies."""
    make, launches, overrides = _CONV_FAMILIES[variant]
    sd = make()
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    if overrides:
        gpu, cpu = gpu.with_config(**overrides), cpu.with_config(**overrides)
    x = np.random.default_rng(0).random((2, 21, 26, 3), dtype=np.float32)
    before = fc.fused_conv3x3_act.launches
    got = gpu(x)
    torch.cuda.synchronize()
    assert fc.fused_conv3x3_act.launches - before == launches
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=5e-4)


@pytest.mark.parametrize('variant,hw', [('3x', (21, 26)), ('4x', (21, 26)), ('2x_fast', (43, 47)), ('2x', (5, 7))])
@pytest.mark.parametrize('pro', [False, True])
def test_cugan_on_card_matches_cpu(cuda, variant, hw, pro):
    """CUGAN runs plain torch on the card (cuDNN's valid, strided and
    transposed convs) and launches no hand-written kernel."""
    sd = make_cugan(variant, pro, seed=27)
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    x = np.random.default_rng(0).random((2, *hw, 3), dtype=np.float32)
    before = fc.fused_conv3x3_act.launches
    got = gpu(x)
    torch.cuda.synchronize()
    assert fc.fused_conv3x3_act.launches == before
    want = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')(x)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=5e-4)


@pytest.mark.parametrize('family', ['compact', 'span_no_norm', 'spanplus', 'mosr_gps', 'spanpp_3x', 'rcan', 'cugan_2x',
                                    'gater', 'mosrv2', 'moesr', 'gaterv2_sr', 'gaterv3_dys', 'rtmosr', 'smosr', 'rha',
                                    'flexnet', 'gfisr', 'gfisrv2', 'figsr', 'lawfft'])
def test_conv_families_tiled_on_card_match_cpu(cuda, family):
    make, _, overrides = _CONV_FAMILIES[family]
    gpu = resselt_tpu_torch.load_from_state_dict(make(), device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(make(), device='cpu')
    if overrides:
        gpu, cpu = gpu.with_config(**overrides), cpu.with_config(**overrides)
    img = np.random.default_rng(1).random((70, 90, 3), dtype=np.float32)
    got = upscale_tiled(gpu, img, tile=32)
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), upscale_tiled(cpu, img, tile=32).numpy(), rtol=0, atol=5e-4)


# -- float16 and precision through the thirty-one families -----------------------------------


_FAMILIES = {
    'esrgan': lambda: make_esrgan(16, 2, 4, gc=8, seed=3),
    'plksr': lambda: make_plksr(32, 2, 4, kernel_size=17, seed=3),
    'swinir': lambda: make_swinir(36, (2, 2), (6, 3), 8, upscale=2, img_size=32, seed=3),
    'eimn': lambda: make_eimn(64, 2, 1, 2.66, 4, seed=3),
    'atd': lambda: make_atd(24, (2, 2), (3, 3), 8, reducted_dim=4, upscale=2, seed=3),
    'hat': lambda: make_hat(36, (2, 2), (6, 3), 8, 0.5, 3, 6, 2.0, 2, seed=3),
    'dat': lambda: make_dat(36, (2, 2), (6, 6), (4, 8), 2.0, 2, seed=3),
    'rgt': lambda: make_rgt(36, (2, 2), (6, 6), (4, 8), 2.0, 0.5, 2, seed=3),
    'drct': lambda: make_drct(36, 2, 6, 8, 12, 2.0, 2, img_size=32, seed=3),
    'fdat': lambda: make_fdat(48, 2, 1, 4, 8, 2.0, 8, 32, 'transpose+conv', 2, seed=3),
    'omni': lambda: make_omni(32, 1, True, 8, 2, 2, seed=3),
    'compact': lambda: make_compact(24, 4, 2, seed=3),
    'span': lambda: make_span(48, 2, seed=3),
    'spanplus': lambda: make_spanplus(48, (2,), 2, seed=3),
    'mosr': lambda: make_mosr(64, 2, 2, seed=3),
    'spanpp': lambda: make_spanpp(48, implicit_dim=32, latent_layers=2, seed=3),
    'rcan': lambda: make_rcan(64, 2, 3, 16, 2, seed=3),
    'cugan': lambda: make_cugan('2x', seed=3),
    'gater': lambda: make_gater(32, (1, 1, 1, 2, 1, 1, 1), seed=3, latent_att=True),
    'mosrv2': lambda: make_mosrv2(64, 2, 2, seed=3),
    'moesr': lambda: make_moesr(64, 1, 2, 2, seed=3),
    'gaterv2': lambda: make_gaterv2(32, (1, 1, 1), (1, 1, 1), 2, seed=3),
    'gaterv3': lambda: make_gaterv3(32, (1, 1, 1), (1, 1, 1), 2, span_blocks=2, seed=3),
    'rtmosr': lambda: make_rtmosr(32, 2, 2, seed=3),
    'smosr': lambda: make_smosr(32, 1, 2, seed=3),
    'rha': lambda: make_rha(32, 2, down_list=(2, 1), res_blocks=2, seed=3),
    'flexnet': lambda: make_flexnet(32, (3, 2), 2, seed=3),
    'gfisr': lambda: make_gfisr(32, 3, 2, seed=3),
    'gfisrv2': lambda: make_gfisrv2(32, 3, 2, seed=3),
    'figsr': lambda: make_figsr(32, 2, 2, gc=4, seed=3),
    'lawfft': lambda: make_lawfft(32, 1, 2, 2, seed=3),
}


@pytest.mark.parametrize('family', sorted(_FAMILIES))
def test_model_serves_float16_and_every_precision_on_the_card(cuda, family):
    """fp16, bf16 and precision='bfloat16' stay within 35 dB of f32
    (tests/test_parallel.py's floor for a 16-bit run)."""
    gpu = resselt_tpu_torch.load_from_state_dict(_FAMILIES[family](), device='cuda')
    x = np.random.default_rng(0).random((2, 21, 26, 3), dtype=np.float32)
    f32 = gpu(x)
    for kwargs in ({'dtype': torch.float16}, {'dtype': 'bfloat16'}, {'precision': 'bfloat16'},
                   {'precision': 'tensorfloat32'}):
        got = gpu(x, **kwargs)
        assert got.shape == f32.shape and bool(torch.isfinite(got).all())
        psnr = 10 * torch.log10(1.0 / ((got.float() - f32) ** 2).mean().clamp_min(1e-12))
        assert float(psnr) >= 35.0, f'{family} {kwargs}: {float(psnr):.2f} dB'
    with pytest.raises(ValueError):
        gpu(x, precision='fastest')


# -- FlexNet's window attention ------------------------------------------------------------------


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('windows,c', [(1024, 64), (48, 64), (20, 16)])
def test_window_kernel_flexnet_shapes(cuda, dtype, windows, c):
    """FlexNet's LMLTVIT attention: one head over the full width, 64
    tokens, the zero bias, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((windows, 64, 3 * c), generator=g, device=cuda).to(dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.zeros((1, 64, 64), device=cuda)
    got = wa.window_mha(q, k, v, bias, num_heads=1, scale=c ** -0.5)
    want = wa.window_mha_ref(q.float(), k.float(), v.float(), bias, num_heads=1, scale=c ** -0.5)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize('variant,kernel,plain', [('flexnet', 5, 0), ('flexnet_meta', 6, 1)])
def test_flexnet_attention_launches_window_attn(cuda, variant, kernel, plain):
    """FlexNet's attentions launch ``csrc/window_attn.cu`` wherever head_dim
    = C <= 64; the meta U-Net's 128-wide level takes the plain path."""
    from resselt_tpu_torch.nn.window import multi_head_attention

    sd = _CONV_FAMILIES[variant][0]()
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(0).random((2, 21, 26, 3), dtype=np.float32)
    before, plain_before = wa.window_mha.launches, multi_head_attention.plain_calls
    got = gpu(x)
    torch.cuda.synchronize()
    assert (wa.window_mha.launches - before, multi_head_attention.plain_calls - plain_before) == (kernel, plain)
    np.testing.assert_allclose(got.cpu().numpy(), cpu(x).numpy(), rtol=0, atol=1e-3)
