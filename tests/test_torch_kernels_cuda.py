"""The port's CUDA kernels (conv3x3, conv_lk, window_attn, window_cross_attn, molrcm,
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
The gradients of the five kernel Functions are held, in f32, to the same
tolerances x max|plain gradient| against autograd through the plain
version on the card (the 16-bit conv gradient to 3e-2), and a train step
of six small models on the card to the CPU's (loss within 1e-5 relative,
every param within 2 lr after the step).  One bf16 forward of each family
at the widths the kernel table names launches the counts that table gives,
by route.  An int8 model's convs on the card equal the CPU's on the same
codes.  On a one-rank NCCL mesh: ``esrgan.apply_pipelined`` counts its
conv3x3 launches and equals ``model(x)`` and ``SRModel.apply``'s
gradients, ``upscale_tiled(mesh=)`` and ``make_train_step(mesh=)`` equal
their meshless runs bit for bit, and ``moe_apply_ep`` equals
``moe_apply_dense``.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.nn.params import PTree
from resselt_tpu_torch.ops import row_gather, row_gather_ref
from resselt_tpu_torch.ops import fused_conv as fc
from resselt_tpu_torch.ops import molrcm as mo
from resselt_tpu_torch.ops import window_attention as wa
from resselt_tpu_torch.ops import window_cross_attention as wca
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


# ESRGAN's producer steps (fc.fused_conv3x3_step), nf 64 / gc 32: (cin, cout, addend, split, residuals)
STEP_STAGES = {'stage0': (64, 192, False, 32, 0), 'stage1': (32, 160, True, 32, 0), 'stage2': (32, 128, True, 32, 0),
               'stage3': (32, 96, True, 32, 0), 'stage4': (32, 64, True, None, 1), 'stage4_rrdb': (32, 64, True, None, 2)}
# their (schedule, nt) in by_schedule: the wgmma kernel's ping-pong at N tiles 96, 80 and 64
STEP_SCHEDULES = {'stage0': ('pingpong', 96), 'stage1': ('pingpong', 80), 'stage2': ('pingpong', 64),
                  'stage3': ('pingpong', 96), 'stage4': ('pingpong', 64), 'stage4_rrdb': ('pingpong', 64)}


def _step_case(cuda, dtype, n, h, w, cin, cout, has_addend, split, n_res):
    g = torch.Generator(device=cuda).manual_seed(cin * 1000 + cout)
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
    taps = fc.pack_conv3x3_weight(torch.randn((cout, cin, 3, 3), generator=g, device=cuda) / (3 * cin ** 0.5), dtype)
    b = torch.randn((cout,), generator=g, device=cuda) * 0.1
    addend = torch.randn((n, h, w, cout), generator=g, device=cuda).to(dtype) if has_addend else None
    residuals = tuple(torch.randn((n, h, w, cout), generator=g, device=cuda).to(dtype) for _ in range(n_res))
    return x, taps, b, addend, split, residuals


def _step_chain(x, taps, b, addend, split, residuals):
    """The unfused chain of ESRGAN's ``_rdb`` / ``_rrdb`` around a producer."""
    a = fc.fused_conv3x3_act(x, taps, b)
    if addend is not None:
        a = addend + a
    if split is not None:
        return torch.nn.functional.leaky_relu(a[..., :split], 0.2), a[..., split:]
    for r in residuals:
        a = a * 0.2 + r
    return a


# Batches against the ping-pong's tile loop on an H100's 132 SMs: 8 x 264^2 (2,312 tiles of 16^2, 35 or 36 a
# block at two Cout slices of one block an SM), 2 x 140 x 170 (198 tiles: 3 a block there, an odd count, so
# warpgroup 1's last products have no partner), 2 x 37 x 29 (12 tiles, fewer than the SMs), one image of a
# single tile; H and W no multiples of 16 but in the first and last
STEP_BATCHES = [(8, 264, 264), (2, 140, 170), (2, 37, 29), (1, 16, 16)]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('stage', list(STEP_STAGES))
@pytest.mark.parametrize('n,h,w', STEP_BATCHES)
def test_step_kernel_equals_the_chain(cuda, dtype, stage, n, h, w):
    """One launch with the glue in the epilogue, bit for bit the chain of a
    conv launch and PyTorch ops; counted as the conv's launch at its key,
    once by its epilogue kind and once by its schedule."""
    cin, cout, has_addend, split, n_res = STEP_STAGES[stage]
    x, taps, b, addend, split, residuals = _step_case(cuda, dtype, n, h, w, cin, cout, has_addend, split, n_res)
    assert fc.conv3x3_step_takes(cin, cout, split)
    want = _step_chain(x, taps, b, addend, split, residuals)
    e, key = fc.fused_conv3x3_act, (n, h, w, cin, cout, 'linear')
    kind = ('carry_' if has_addend else '') + ('split' if split else f'residual{n_res}')
    before = e.launches, e.by_shape[key], e.by_epilogue[kind], e.by_schedule[STEP_SCHEDULES[stage]]
    schedules = sum(e.by_schedule.values())
    got = fc.fused_conv3x3_step(x, taps, b, addend=addend, split=split, residuals=residuals)
    torch.cuda.synchronize()
    assert (e.launches, e.by_shape[key], e.by_epilogue[kind],
            e.by_schedule[STEP_SCHEDULES[stage]]) == tuple(c + 1 for c in before)
    assert sum(e.by_schedule.values()) == schedules + 1
    got, want = (got, want) if split else ((got,), (want,))
    for g_, w_ in zip(got, want):
        assert g_.is_contiguous() and g_.dtype == dtype and torch.equal(g_, w_.contiguous())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('cin,cout,act,nt', [(64, 96, 'lrelu', 96), (64, 96, 'silu', 96), (64, 96, 'mish', 96),
                                             (64, 192, 'lrelu', 96), (64, 192, 'silu', 96), (64, 192, 'mish', 96),
                                             (64, 64, 'linear', 64)])
@pytest.mark.parametrize('n,h,w', STEP_BATCHES[1:3])
def test_pingpong_conv_matches_plain(cuda, dtype, cin, cout, act, nt, n, h, w):
    """The plain conv (no producer epilogue) on the ping-pong at plans of
    one block an SM against the plain version in f32; counted once under
    ('pingpong', nt)."""
    g = torch.Generator(device=cuda).manual_seed(cout)
    x = torch.randn((n, h, w, cin), generator=g, device=cuda).to(dtype)
    taps = fc.pack_conv3x3_weight(torch.randn((cout, cin, 3, 3), generator=g, device=cuda) / (3 * cin ** 0.5), dtype)
    b = torch.randn((cout,), generator=g, device=cuda)
    e = fc.fused_conv3x3_act
    before, total = e.by_schedule[('pingpong', nt)], sum(e.by_schedule.values())
    got = fc.fused_conv3x3_act(x, taps, b, act=act)
    torch.cuda.synchronize()
    assert e.by_schedule[('pingpong', nt)] == before + 1 and sum(e.by_schedule.values()) == total + 1
    want = fc.fused_conv3x3_act_ref(x.float(), taps.float(), b, act=act)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize('case', ['f32', 'cin8', 'split12', 'cout60', 'misaligned'])
def test_step_outside_the_step_kernel_raises(cuda, case):
    """f32, a Cin the wgmma kernel does not take (mma.sync), a split or a
    Cout that is no multiple of 8, an operand off 16 bytes: the step
    launches nothing and raises (``_fuses`` keeps such RRDBs on the chain)."""
    dtype, cin, cout, split = {'f32': (torch.float32, 64, 192, 32), 'cin8': (torch.bfloat16, 8, 48, 8),
                               'split12': (torch.float16, 32, 160, 12), 'cout60': (torch.bfloat16, 32, 60, None),
                               'misaligned': (torch.bfloat16, 32, 64, None)}[case]
    x, taps, b, addend, split, residuals = _step_case(cuda, dtype, 2, 21, 19, cin, cout, True, split,
                                                      0 if split else 1)
    if case == 'misaligned':  # a residual one element into its storage
        residuals = (torch.empty(residuals[0].numel() + 1, dtype=dtype, device=cuda)[1:].view_as(residuals[0]),)
    e = fc.fused_conv3x3_act
    before = e.launches, sum(e.by_epilogue.values())
    with pytest.raises(ValueError, match='aligned' if case == 'misaligned' else 'no step kernel'):
        fc.fused_conv3x3_step(x, taps, b, addend=addend, split=split, residuals=residuals)
    assert (e.launches, sum(e.by_epilogue.values())) == before


@pytest.mark.parametrize('nf,gc', [(16, 8), (64, 12), (60, 32)])
def test_esrgan_outside_the_step_kernel_runs_the_chain(cuda, monkeypatch, nf, gc):
    """An RRDBNet whose producers the step kernel does not take (Cin 8 on
    the mma.sync kernel, a gc or an nf that is no multiple of 8 or 16): the
    served bf16 forward runs every RRDB on the chain, one conv launch a
    producer and no epilogue, where the CPU runs the (plain) steps."""
    from resselt_tpu_torch.archs import esrgan as E

    model = resselt_tpu_torch.load_from_state_dict(make_esrgan(nf, 2, 4, gc=gc, seed=8), device='cuda')
    fuses, decided = E._fuses, []
    monkeypatch.setattr(E, '_fuses', lambda *a: decided.append(fuses(*a)) or decided[-1])
    x = np.random.default_rng(3).random((2, 24, 20, 3), dtype=np.float32)
    e = fc.fused_conv3x3_act
    before = e.launches, sum(e.by_epilogue.values())
    y = model(x, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert decided == [False, False] and bool(torch.isfinite(y).all())
    assert (e.launches, sum(e.by_epilogue.values())) == (before[0] + 5 * 3 * 2 + 6, before[1])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_esrgan_width_forward_steps_equal_the_chain(cuda, monkeypatch, dtype):
    """An RRDBNet at esrgan_x4's widths (nf 64, gc 32): the served forward's
    producer steps against the chain the parent ran, bit for bit, with the
    same conv3x3 launches at the same keys and 5 x 3 x num_blocks epilogues."""
    from resselt_tpu_torch.archs import esrgan as E

    model = resselt_tpu_torch.load_from_state_dict(make_esrgan(64, 3, 4, gc=32, seed=7), device='cuda')
    x = np.random.default_rng(2).random((2, 40, 52, 3), dtype=np.float32)
    e = fc.fused_conv3x3_act

    def forward():
        shapes, kinds, schedules = Counter(e.by_shape), Counter(e.by_epilogue), Counter(e.by_schedule)
        y = model(x, dtype=dtype)
        torch.cuda.synchronize()
        return y, e.by_shape - shapes, e.by_epilogue - kinds, e.by_schedule - schedules

    got, steps_shapes, kinds, steps_schedules = forward()
    with monkeypatch.context() as m:
        m.setattr(E, '_fuses', lambda *a: False)
        want, chain_shapes, chain_kinds, chain_schedules = forward()
    assert torch.equal(got, want)
    assert steps_shapes == chain_shapes and sum(steps_shapes.values()) == 5 * 3 * 3 + 6 and not chain_kinds
    assert kinds == {'split': 9, 'carry_split': 27, 'carry_residual1': 6, 'carry_residual2': 3}
    # 9 RDBs' producers at N tiles 96 (stages 0, 3), 80 (1) and 64 (2, 4), the four 64 -> 64 convs at 64 and
    # 64 -> 3 at 8 on the ping-pong, 3 -> 64 on mma.sync (a bench forward of 23 blocks: 350 and 1)
    assert steps_schedules == chain_schedules == {('pingpong', 96): 18, ('pingpong', 80): 9, ('pingpong', 64): 22,
                                                  ('pingpong', 8): 1, ('mma', 64): 1}


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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('n,h,w,cin,cout,k,act,pitch,c0,path', [
    (1, 40, 70, 16, 16, 33, 'lrelu', 16, 0, 'tiles'),   # k 33: the tiles path's halos and rows still fit
    (2, 21, 23, 8, 8, 33, 'linear', 8, 0, 'mma'),       # Cin 8: one block of taps
    (1, 30, 40, 16, 8, 51, 'lrelu', 64, 16, 'mma'),     # k 51 at Cin 16, a slice: taps in blocks
    (1, 19, 37, 64, 64, 35, 'linear', 64, 0, 'mma'),    # k 35 at 64 -> 64: taps in blocks (f32 too)
    (2, 17, 33, 32, 24, 51, 'linear', 32, 0, 'mma'),    # k 51 at Cin 32
    (1, 9, 11, 8, 4, 101, 'lrelu', 8, 0, 'mma'),        # a kernel far wider than the image
])
def test_lk_kernel_takes_every_odd_k(cuda, dtype, n, h, w, cin, cout, k, act, pitch, c0, path):
    """k past 31, where the f32 and mma kernels take the taps in square
    blocks that each stage their own halo and weights."""
    _lk_check(cuda, dtype, n, h, w, cin, cout, k, act, pitch=pitch, c0=c0, path=path)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,h,w,launches', [(65537, 2, 3, 2), (1, 1048577, 1, 1)])
def test_lk_kernel_takes_any_batch_and_height(cuda, dtype, n, h, w, launches):
    """More images than the grid's z holds go in two launches; more than
    65535 row tiles of 16 run in one (the tiles of an image are the grid's
    x)."""
    g = torch.Generator(device=cuda).manual_seed(n + h)
    x = torch.randn((n, h, w, 8), generator=g, device=cuda).to(dtype)
    taps = fc.pack_conv_lk_weight(torch.randn((8, 8, 3, 3), generator=g, device=cuda) / 8, dtype)
    b = torch.randn((8,), generator=g, device=cuda)
    before = fc.fused_conv_lk.launches
    got = fc.fused_conv_lk(x, taps, b, k=3, act='lrelu')
    torch.cuda.synchronize()
    assert fc.fused_conv_lk.launches - before == launches
    want = fc.fused_conv_lk_ref(x.float(), taps.float(), b, k=3, act='lrelu')
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=1e-3)


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
    routes_before = Counter(wa.window_mha.by_kernel)
    got = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=scale)
    torch.cuda.synchronize()
    assert wa.window_mha.launches == before + 1 and wa.window_mha.by_shape[key] == shape_before + 1
    routed = wa.window_mha.by_kernel - routes_before  # the launch counted once by route, under its shape
    assert sum(routed.values()) == 1 and next(iter(routed))[1:6] == key
    assert got.dtype == dtype and got.shape == (windows, n, c) and got.is_contiguous()
    want = wa.window_mha_ref(q.float(), k.float(), v.float(), bias, mask, num_heads=heads, scale=scale)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=WATTN_BF16_TOL[0], atol=WATTN_BF16_TOL[1])
    return next(iter(routed))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('windows,n,c,heads,nw', [
    (64, 64, 180, 6, 16), (64, 64, 180, 6, None),  # SwinIR-M / SwinIR-L
    (8, 256, 180, 6, None), (8, 256, 180, 6, 4),    # HAT-L / DRCT-L swin1
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
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('c,heads,head_pad', [(180, 6, 30), (212, 4, 56), (244, 2, 122), (276, 6, 46), (308, 4, 80)])
def test_window_kernel_routes_drct_blocks(cuda, dtype, masked, c, heads, head_pad):
    """DRCT's five blocks at 256-token windows, q, k, v read in place from
    the projection: ``by_kernel`` names the kernel that ran and the head
    width launched.  Heads of 122 and 77 take the "any" kernels; 30, 46 and
    53 the first f32 kernel, and in 16 bits the wgmma kernel (windows of
    more than 64 tokens); in 16 bits the odd heads (53, 77) run zero-padded
    to 56 and 80, in f32 unpadded."""
    route = _wattn_check(cuda, dtype, 8, 256, c, heads, 4 if masked else None)
    hd = c // heads
    if hd > 64:
        kernel = 'wattn_f32_any_kernel' if dtype == torch.float32 else 'wattn_h16_any_kernel'
    else:
        kernel = 'wattn_f32_kernel' if dtype == torch.float32 else 'wattn_wgmma_kernel'
    assert route == (kernel, 8, 256, c, heads, masked, hd if dtype == torch.float32 else head_pad)


def _mixed_mask(g, nw, n, device):
    """A mask of nW windows whose odd windows hold -100 at 30% of their
    entries and whose even ones are all zero: flags mark every other tile."""
    mask = torch.where(torch.rand((nw, n, n), generator=g, device=device) < 0.3, -100.0, 0.0)
    mask[0::2] = 0.0
    return mask


def _wgmma_check(cuda, dtype, windows, n, c, heads, nw=None, seed=0):
    """The 16-bit window attention at 64 < n <= 256 and head_dim <= 64 on q,
    k, v read in place from one projection, with a mask whose flags mark
    every other window (nw) or none: the route counter names the wgmma
    kernel, and the output holds to the plain version.  Returns q, k, v,
    bias, mask and the output."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    t = torch.randn((windows, n, 3 * c), generator=g, device=cuda).to(dtype)
    q, k, v = t[..., :c], t[..., c:2 * c], t[..., 2 * c:]
    bias = torch.randn((heads, n, n), generator=g, device=cuda) * 0.5
    mask = None if nw is None else _mixed_mask(g, nw, n, cuda)
    if mask is not None:
        flags = wa.mask_window_flags(mask)
        assert 0 < int(flags.sum()) < nw or nw == 1
    scale = (c // heads) ** -0.5
    routes_before = Counter(wa.window_mha.by_kernel)
    got = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=scale)
    torch.cuda.synchronize()
    routed = wa.window_mha.by_kernel - routes_before
    assert {key[0] for key in routed} == {'wattn_wgmma_kernel'}
    want = wa.window_mha_ref(q.float(), k.float(), v.float(), bias, mask, num_heads=heads, scale=scale)
    assert got.dtype == dtype and got.shape == (windows, n, c)
    torch.testing.assert_close(got.float(), want, rtol=WATTN_BF16_TOL[0], atol=WATTN_BF16_TOL[1])
    return q, k, v, bias, mask, got


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('hd', [12, 24, 30, 46, 53, 64])
@pytest.mark.parametrize('n', [65, 100, 128, 144, 200, 256])
def test_window_kernel_wgmma_route(cuda, dtype, masked, hd, n):
    """Every n of the wgmma kernel's two key chunkings (up to 128 tokens, and
    up to 256) at every head width it pads (16, 32, 48, 64; 53 zero-padded
    to 56 by the wrapper), two heads, masked with every other window's tile
    all zero, and unmasked."""
    _wgmma_check(cuda, dtype, 6, n, 2 * hd, 2, 3 if masked else None, seed=n * 100 + hd)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('c,heads', [(180, 6), (276, 6)])
@pytest.mark.parametrize('windows,nw', [(1, None), (1, 1), (81, None), (81, 81)])
def test_window_kernel_wgmma_drct_widths(cuda, dtype, c, heads, windows, nw):
    """DRCT's swin1 and swin4 widths, q, k, v read in place from the
    projection (rows 4-byte aligned only: 1,080 and 1,656 bytes apart, heads
    of 60 and 92 bytes), one window and a 144^2 tile's 81."""
    _wgmma_check(cuda, dtype, windows, 256, c, heads, nw, seed=c + windows)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('c,heads,nw', [(180, 6, None), (276, 6, 81), (212, 4, 27)])
def test_window_kernel_wgmma_launches_split_at_the_grid_limit(cuda, monkeypatch, dtype, c, heads, nw):
    """81 windows with the limit on windows a launch cut to 32: the wrapper
    launches the wgmma kernel on runs of windows (inside the mask's period of
    81, or whole periods of 27), and the output is one launch's bit for
    bit."""
    q, k, v, bias, mask, whole = _wgmma_check(cuda, dtype, 81, 256, c, heads, nw, seed=c)
    ranges = wa._launch_ranges
    monkeypatch.setattr(wa, '_launch_ranges', lambda b, m, limit: ranges(b, m, 32))
    before = wa.window_mha.launches
    got = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=(c // heads) ** -0.5)
    torch.cuda.synchronize()
    assert wa.window_mha.launches - before == len(ranges(81, nw or 1, 32)) > 1
    torch.testing.assert_close(got, whole, rtol=0, atol=0)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('masked', [False, True])
def test_window_kernel_wgmma_in_a_cuda_graph(cuda, dtype, masked):
    """The wgmma kernel captured into a CUDA graph: replays on new inputs
    copied into the captured ones give the eager launch's output bit for
    bit, and each replay runs the one captured launch."""
    c, heads, n, windows = 276, 6, 256, 9
    q, k, v, bias, mask, _ = _wgmma_check(cuda, dtype, windows, n, c, heads, 9 if masked else None, seed=3)
    qkv = q.as_strided((windows, n, 3 * c), q.stride())  # the projection the slices view
    scale = (c // heads) ** -0.5
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=scale)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = wa.window_mha.launches
    with torch.cuda.graph(graph):
        out = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=scale)
    assert wa.window_mha.launches - before == 1
    g = torch.Generator(device=cuda).manual_seed(4)
    for _ in range(2):
        qkv.copy_(torch.randn(qkv.shape, generator=g, device=cuda).to(dtype))
        graph.replay()
        torch.cuda.synchronize()
        eager = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=scale)
        torch.testing.assert_close(out, eager, rtol=0, atol=0)


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
@pytest.mark.parametrize('ws,c,heads', [(8, 180, 6), (16, 144, 6), (16, 48, 4), (7, 60, 6), (8, 244, 2), (16, 308, 4)])
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize('windows,n,c,heads,nw', [
    (16, 64, 244, 2, 4), (16, 64, 308, 4, None),      # DRCT's swin3 / swin5 at window 8: head_dim 122 / 77
    (8, 256, 244, 2, 8), (8, 256, 308, 4, None),      # ... at DRCT's window 16
    (32, 64, 96, 1, None), (16, 64, 128, 1, 4),       # FlexNet-style single wide heads
    (8, 64, 160, 1, None), (3, 300, 130, 2, None),    # two output slices; head_dim 65 at n 300
    (6, 257, 32, 2, 3), (4, 320, 64, 2, 2),           # more than 256 tokens a window
    (2, 513, 24, 1, None), (5, 1, 200, 1, None),      # n 513; one token and one wide head
])
def test_window_kernel_any_n_and_head_dim(cuda, dtype, windows, n, c, heads, nw):
    """The shapes past the first pair of kernels (n 256, head_dim 64): the
    "any" kernels, against the plain version."""
    _wattn_check(cuda, dtype, windows, n, c, heads, nw, seed=n + c)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('windows,n,c,heads,nw', [(12, 64, 180, 6, 4), (12, 64, 244, 2, 6), (10, 64, 96, 1, None)])
def test_window_kernel_launches_split_at_the_grid_limit(cuda, monkeypatch, dtype, windows, n, c, heads, nw):
    """With the limit on windows a launch cut to 3, the wrapper launches the
    kernel on runs of windows (whole mask periods of 4, or runs inside a
    period of 6), counts each launch, and gives what one launch gives."""
    g = torch.Generator(device=cuda).manual_seed(c)
    qkv = torch.randn((windows, n, 3 * c), generator=g, device=cuda).to(dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn((heads, n, n), generator=g, device=cuda) * 0.5
    mask = None if nw is None else torch.where(torch.rand((nw, n, n), generator=g, device=cuda) < 0.3, -100.0, 0.0)
    whole = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=0.1)
    ranges = wa._launch_ranges
    monkeypatch.setattr(wa, '_launch_ranges', lambda b, m, limit: ranges(b, m, 3))
    before = wa.window_mha.launches
    got = wa.window_mha(q, k, v, bias, mask, num_heads=heads, scale=0.1)
    torch.cuda.synchronize()
    assert wa.window_mha.launches - before == len(ranges(windows, nw or 1, 3)) > 1
    torch.testing.assert_close(got, whole, rtol=0, atol=0)


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


# -- window_cross_attn.cu: HAT's overlapping cross-attention ---------------------------


def _cross_check(cuda, dtype, windows, n, m, c, heads, seed=0):
    """The cross kernel on q read in place from a (B, N, 3C) projection and
    k, v as the two channel halves of a (B, M, 2C) tensor of overlapping
    windows, as HAT hands them over: one launch counted under its shape, the
    output held to the plain version in f32 from the same 16-bit inputs
    within window_mha's 16-bit tolerances."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((windows, n, 3 * c), generator=g, device=cuda).to(dtype)[..., :c]
    kv = torch.randn((windows, m, 2 * c), generator=g, device=cuda).to(dtype)
    k, v = kv[..., :c], kv[..., c:]
    bias = torch.randn((heads, n, m), generator=g, device=cuda) * 0.5
    scale = (c // heads) ** -0.5
    key = (windows, n, m, c, heads)
    before, shape_before = wca.window_cross_mha.launches, wca.window_cross_mha.by_shape[key]
    got = wca.window_cross_mha(q, k, v, bias, num_heads=heads, scale=scale)
    torch.cuda.synchronize()
    assert wca.window_cross_mha.launches == before + 1 and wca.window_cross_mha.by_shape[key] == shape_before + 1
    assert got.dtype == dtype and got.shape == (windows, n, c) and got.is_contiguous()
    want = wca.window_cross_mha_ref(q.float(), k.float(), v.float(), bias, num_heads=heads, scale=scale)
    torch.testing.assert_close(got.float(), want, rtol=WATTN_BF16_TOL[0], atol=WATTN_BF16_TOL[1])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('windows,n,m,c,heads', [
    (392, 256, 576, 180, 6),  # HAT-L's served OCAB: two 224^2 windows of 14 x 14 windows, heads of 30
    (32, 256, 576, 144, 6),   # HAT-S: heads of 24, 16-byte rows
    (8, 64, 169, 60, 3),      # an odd owin - ws (window 8, overlap 13): odd M, heads of 20
    (5, 100, 150, 32, 2),     # N off the 64-row tile, one chunk and a half, heads of 16
    (3, 16, 1, 12, 2),        # one key
])
def test_cross_kernel_matches_plain(cuda, dtype, windows, n, m, c, heads):
    _cross_check(cuda, dtype, windows, n, m, c, heads, seed=n + m)


def test_cross_kernel_rule_is_the_sources(cuda):
    """``window_cross_mha_supported`` (the route's) is the CUDA source's
    exported rule, over every head width up to 66 and keys up to 600."""
    rule = wca._lib().resselt_window_cross_attn_supported
    for hd in range(1, 67):
        for m in (1, 63, 64, 65, 575, 576, 577, 600):
            for n in (1, 64, 256):
                assert wca.window_cross_mha_supported(n, m, 2 * hd, 2) == bool(rule(n, m, hd, 2)), (n, m, hd)
                assert not rule(n, m, hd, 4)


def test_cross_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((4, 64, 48), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((4, 144, 96), device=cuda, dtype=torch.bfloat16)
    k, v = kv[..., :48], kv[..., 48:]
    bias = torch.zeros((2, 64, 144), device=cuda)
    with pytest.raises(TypeError):  # f32
        wca.window_cross_mha(q.float(), k.float(), v.float(), bias, num_heads=2, scale=0.2)
    with pytest.raises(ValueError):  # heads of 48
        wca.window_cross_mha(q, k, v, bias[:1], num_heads=1, scale=0.2)
    with pytest.raises(ValueError):  # heads of 3: odd
        wca.window_cross_mha(q, k, v, torch.zeros((16, 64, 144), device=cuda), num_heads=16, scale=0.2)
    big = torch.zeros((4, 577, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # more keys than a stage holds
        wca.window_cross_mha(q, big[..., :48], big[..., 48:], torch.zeros((2, 64, 577), device=cuda), num_heads=2,
                             scale=0.2)
    with pytest.raises(ValueError):  # k and v at different strides
        wca.window_cross_mha(q, k, v.contiguous(), bias, num_heads=2, scale=0.2)
    with pytest.raises(ValueError):  # channels not next to each other
        t = torch.zeros((4, 48, 64), device=cuda, dtype=torch.bfloat16).transpose(1, 2)
        wca.window_cross_mha(t, k, v, bias, num_heads=2, scale=0.2)
    with pytest.raises(ValueError):  # a scale that is not positive
        wca.window_cross_mha(q, k, v, bias, num_heads=2, scale=0.0)
    with pytest.raises(ValueError):  # a gradient asked for
        wca.window_cross_mha(q.requires_grad_(), k, v, bias, num_heads=2, scale=0.2)
    with pytest.raises(ValueError):  # a bias of the wrong shape
        wca.window_cross_mha(q, k, v, bias[:, :, :64], num_heads=2, scale=0.2)


def test_cross_kernel_in_a_cuda_graph(cuda):
    """Captured into a CUDA graph at HAT-L's width: a replay on new inputs
    gives the eager launch's output bit for bit."""
    windows, n, m, c, heads = 18, 256, 576, 180, 6
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((windows, n, c), generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn((windows, m, 2 * c), generator=g, device=cuda).to(torch.bfloat16)
    bias = torch.randn((heads, n, m), generator=g, device=cuda)
    args = (q, kv[..., :c], kv[..., c:], bias)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        wca.window_cross_mha(*args, num_heads=heads, scale=0.2)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wca.window_cross_mha(*args, num_heads=heads, scale=0.2)
    q.copy_(torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, wca.window_cross_mha(*args, num_heads=heads, scale=0.2), rtol=0, atol=0)


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



@pytest.mark.parametrize('variant', ['dat', 'dat_direct_3conv', 'rgt', 'drct', 'drct_plain', 'drct_bench_heads'])
def test_dat_rgt_drct_on_card_match_cpu(cuda, variant):
    """Window launches per forward: DAT and RGT two per spatial block, DRCT
    one per block, its wide heads too (drct_plain: embed 128, two heads,
    head_dim 72 to 96 from swin2 on, which took the plain path before;
    drct_bench_heads: DRCT's own width, heads of 30, 53, 122, 46 and 77);
    none takes the plain path, counted in
    ``multi_head_attention.plain_calls``."""
    from resselt_tpu_torch.nn.window import multi_head_attention

    sd, launches, plain, hw = {
        'dat': (make_dat(36, (4,), (6,), (4, 8), 2.0, 2, seed=1), 4, 0, (18, 22)),
        'dat_direct_3conv': (make_dat(36, (2, 2), (6, 6), (8, 16), 2.0, 4, upsampler='pixelshuffledirect',
                                      resi_connection='3conv', seed=2), 4, 0, (21, 26)),
        'rgt': (make_rgt(36, (4,), (6,), (8, 32), 2.0, 0.5, 2, seed=3), 4, 0, (40, 48)),
        'drct': (make_drct(36, 2, 6, 8, 12, 2.0, 2, img_size=32, seed=4), 10, 0, (21, 26)),
        'drct_plain': (make_drct(128, 1, 2, 8, 16, 2.0, 2, img_size=32, seed=5), 5, 0, (21, 26)),
        'drct_bench_heads': (make_drct(180, 1, 6, 8, 32, 2.0, 2, img_size=32, seed=6), 5, 0, (21, 26)),
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
    'mosrv2_pixelshuffle_3x': (lambda: make_mosrv2(32, 2, 3, upsampler='pixelshuffle', seed=39), 1 + 4 + 2 + 3, None),
    'moesr_dysample': (lambda: make_moesr(32, 1, 2, 2, upsampler='dysample', upsample_dim=16, seed=40), 14, None),
    'smosr_pa_up_4x': (lambda: make_smosr(16, 1, 4, upsampler='pa_up', seed=41), 2 * 4 + 1 + 5, None),
    'flexnet_n+c_channel_norm': (lambda: make_flexnet(32, (3, 1), 4, hidden_rate=2, channel_norm=True, upsampler='n+c',
                                                      seed=42), 2 + 1 + 4 + 1 + 4, None),
    'gfisr_unshuffle_pa_up': (lambda: make_gfisr(16, 5, 2, upsampler='pa_up', mid_dim=16, pixel_unshuffle=True,
                                                 seed=43), 1 + 10 + 5, None),
    'gfisr_lda': (lambda: make_gfisr(16, 5, 2, upsampler='lda', mid_dim=16, seed=44), 1 + 10 + 2, None),
    'gfisrv2_transpose_conv_3x': (lambda: make_gfisrv2(16, 4, 3, upsampler='transpose+conv', mid_dim=16, seed=45),
                                  1 + 8 + 2 + 1, None),
    'figsr_square5_dysample': (lambda: make_figsr(16, 2, 2, upsampler='dysample', mid_dim=16, gc=4,
                                                  square_kernel_size=5, seed=46), 1 + 4 + 1 + 1, None),
    'lawfft_unshuffle_pixelshuffle': (lambda: make_lawfft(16, 1, 2, 2, unshuffle_mod=True, upsampler='pixelshuffle',
                                                          mid_dim=16, seed=47), 1 + 4, None),
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


# -- launches of a served forward, by route, at the widths the kernel table names ---------------


_ESRGAN_BLOCKS = 23
# RRDBNet-23's producer steps by epilogue kind: a dense block's first step splits, the next three add the carry and
# split, its last adds the carry and the block's input (the RRDB's last block: the RRDB's input too)
_ESRGAN_EPILOGUES = {'split': 3 * _ESRGAN_BLOCKS, 'carry_split': 9 * _ESRGAN_BLOCKS,
                     'carry_residual1': 2 * _ESRGAN_BLOCKS, 'carry_residual2': _ESRGAN_BLOCKS}
# conv3x3.cu's schedule by (schedule, N tile): the producers at 96 (stages 0 and 3), 80 (stage 1) and 64 (stages 2
# and 4), the four Cin-64 64 -> 64 convs at 64, 64 -> 3 at 8, all on the ping-pong; 3 -> 64 (Cin 3) on mma.sync
_ESRGAN_SCHEDULES = {('pingpong', 96): 6 * _ESRGAN_BLOCKS, ('pingpong', 80): 3 * _ESRGAN_BLOCKS,
                     ('pingpong', 64): 6 * _ESRGAN_BLOCKS + 4, ('pingpong', 8): 1, ('mma', 64): 1}

_SERVED = {
    # family: (state dict, with_config overrides, launches a bf16 forward by counter and route)
    'esrgan': (lambda: make_esrgan(64, _ESRGAN_BLOCKS, 4, seed=0), None,
               {'conv3x3': 6 + 15 * _ESRGAN_BLOCKS, 'epilogue': _ESRGAN_EPILOGUES, 'schedule': _ESRGAN_SCHEDULES}),
    'plksr': (lambda: make_plksr(64, 28, 4, 17, seed=0), None, {'conv_lk': 28, 'lk_path': {'stacked': 28}}),
    'swinir': (lambda: make_swinir(180, (6,) * 6, (6,) * 6, 8, upscale=4, img_size=64, seed=0), None,
               {'window_mha': 36, 'wattn_kernel': {'wattn_h16_kernel': 36}}),
    'eimn': (lambda: make_eimn(64, 16, 1, 2.66, 4, seed=0), None, {'molrcm': 16, 'molrcm_dtype': {'bfloat16': 16}}),
    'atd': (lambda: make_atd(48, (6,) * 5, (4,) * 5, 16, 64, 8, 7, 1.0, 4, seed=0), None,
            {'window_mha': 30, 'row_gather': 60, 'wattn_kernel': {'wattn_wgmma_kernel': 30}}),
    'hat': (lambda: make_hat(144, (6,) * 6, (6,) * 6, 16, 0.5, 24, 24, 2.0, 4, 64, seed=0), None,
            {'window_mha': 36, 'window_cross_mha': 6, 'wattn_kernel': {'wattn_wgmma_kernel': 36}}),
    'dat': (lambda: make_dat(180, (6,) * 6, (6,) * 6, (8, 16), 2.0, 4, seed=0), None,
            {'window_mha': 36, 'wattn_kernel': {'wattn_wgmma_kernel': 36}}),
    'rgt': (lambda: make_rgt(180, (6,) * 6, (6,) * 6, (8, 32), 2.0, 0.5, 4, seed=0), None,
            {'window_mha': 36, 'wattn_kernel': {'wattn_wgmma_kernel': 36}}),
    'drct': (lambda: make_drct(180, 6, 6, 16, 32, 2.0, 4, img_size=64, seed=0), None,
             {'window_mha': 30, 'wattn_kernel': {'wattn_wgmma_kernel': 18, 'wattn_h16_any_kernel': 12}}),
    'fdat': (lambda: make_fdat(120, 4, 3, 4, 8, 2.0, 8, 64, 'transpose+conv', 4, seed=0), None,
             {'window_mha': 12, 'wattn_kernel': {'wattn_h16_kernel': 12}}),
    'omni': (lambda: make_omni(64, 1, True, 8, 5, 4, seed=0), None,
             {'window_mha': 10, 'wattn_kernel': {'wattn_h16_kernel': 10}}),
    'spanpp': (lambda: make_spanpp(48, ig_kernel=3, implicit_dim=256, latent_layers=4, seed=0), {'eval_scale': 2},
               {'conv3x3': 21}),
    'span': (lambda: make_span(48, 4, seed=0), None, {'conv3x3': 21}),
    'rcan': (lambda: make_rcan(64, 10, 20, 16, 4, seed=0), None, {'conv3x3': 1 + 10 * (2 * 20 + 1) + 1 + 2 + 1}),
    'mosr': (lambda: make_mosr(64, 24, 4, seed=0), None, {'conv3x3': 1 + 2 * 24 + 2 + 2 + 1}),
    'compact': (lambda: make_compact(64, 16, 4, seed=0), None, {'conv3x3': 18}),
    'spanplus': (lambda: make_spanplus(48, (4,), 2, seed=0), None, {'conv3x3': 1 + 3 * (4 + 2) + 1 + 1}),
    'cugan': (lambda: make_cugan('2x', seed=0), None, {}),
    'gater': (lambda: make_gater(64, (2, 2, 2, 4, 2, 2, 2), seed=0, latent_att=True), None, {'conv3x3': 9}),
    'mosrv2': (lambda: make_mosrv2(64, 24, 4, upsampler='pixelshuffledirect', seed=0), None,
               {'conv3x3': 1 + 2 * 24 + 2 + 1}),
    'moesr': (lambda: make_moesr(64, 6, 6, 4, expansion_factor=2.5, expansion_msg=2.5, seed=0), None,
              {'conv3x3': 1 + 6 * (2 * 6 + 1 + 6 + 1) + 1}),
    'gaterv2': (lambda: make_gaterv2(32, (2, 2, 4), (4, 2, 2), 6, seed=0), None, {'conv3x3': 1 + 3 + 3 + 1}),
    'gaterv3': (lambda: make_gaterv3(32, (2, 2, 4), (4, 2, 2), 4, attention=True, span_blocks=4, seed=0), None,
                {'conv3x3': 1 + 3 * (4 + 2) + 1 + 3 + 3 + 1}),
    'rtmosr': (lambda: make_rtmosr(64, 2, 2, seed=0), None, {'conv3x3': 1 + 3 * 2 + 1}),
    'smosr': (lambda: make_smosr(64, 2, 4, seed=0), None, {'conv3x3': 2 * (2 + 2 + 1) + 1 + 1}),
    'rha': (lambda: make_rha(64, 4, down_list=(8, 4, 2, 1), res_blocks=6, seed=0), None,
            {'conv3x3': 1 + 2 * 4 * 6 + 4}),
    'flexnet': (lambda: make_flexnet(64, (6,) * 6, 4, window_size=8, hidden_rate=4, seed=0), None,
                {'conv3x3': 2 + 1 + 2 * 6 + 1, 'window_mha': 36, 'wattn_kernel': {'wattn_h16_kernel': 36}}),
    'gfisr': (lambda: make_gfisr(64, 24, 4, seed=0), None, {'conv3x3': 1 + 2 * 24 + 1}),
    'gfisrv2': (lambda: make_gfisrv2(64, 22, 4, seed=0), None, {'conv3x3': 1 + 2 * 22 + 2 + 1}),
    'figsr': (lambda: make_figsr(64, 18, 4, seed=0), None, {'conv3x3': 1 + 3 * 18 + 1 + 1}),
    'lawfft': (lambda: make_lawfft(64, 4, 6, 4, seed=0), None, {'conv3x3': 2}),
}


def _launch_counts() -> dict:
    """Every kernel wrapper's launches, the plain path's window attentions,
    and the launches by route: conv3x3's by epilogue and by schedule,
    conv_lk's by path, window_mha's by kernel, fused_molrcm's by dtype."""
    from resselt_tpu_torch.nn.window import multi_head_attention

    def by(counter, part):
        out = Counter()
        for key, n in counter.items():
            out[part(key)] += n
        return out

    act, lk = fc.fused_conv3x3_act, fc.fused_conv_lk
    return {'conv3x3': act.launches + fc.fused_conv3x3_pack2.launches, 'conv_lk': lk.launches,
            'window_mha': wa.window_mha.launches, 'window_cross_mha': wca.window_cross_mha.launches,
            'molrcm': mo.fused_molrcm.launches,
            'row_gather': row_gather.launches, 'plain_attention': multi_head_attention.plain_calls,
            'epilogue': Counter(act.by_epilogue), 'schedule': Counter(act.by_schedule),
            'lk_path': by(lk.by_path, lambda key: key[1]), 'wattn_kernel': by(wa.window_mha.by_kernel, lambda key: key[0]),
            'wattn_masked': by(wa.window_mha.by_shape, lambda key: key[4]),
            'molrcm_dtype': by(mo.fused_molrcm.by_shape, lambda key: key[-1])}


@pytest.mark.parametrize('family', sorted(_SERVED))
def test_served_forward_launches(cuda, monkeypatch, family):
    """One bf16 forward of a 64 x 64 image through each family at the widths
    the kernel table's launch counts are given for: the launches of every
    hand-written kernel, the window attentions left to the plain path, and
    the routes (ESRGAN's producer steps by epilogue kind and its convs by
    conv3x3.cu's schedule, PLKSR's large-kernel convs by conv_lk.cu's path,
    the window attentions by window_attn.cu's kernel, EIMN's MOLRCMs by
    dtype: the 16-bit strip kernel).  No other kernel launches.  The f32
    forward on the CPU routes as many convs to the conv wrappers' plain
    versions as the card launches."""
    make, overrides, want = _SERVED[family]
    sd = make()
    gpu = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    if overrides:
        gpu, cpu = gpu.with_config(**overrides), cpu.with_config(**overrides)
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    before = _launch_counts()
    with torch.no_grad():
        y = gpu(x, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _launch_counts().items()}
    assert bool(torch.isfinite(y).all())
    # every launch count; the routes where the table gives them (conv3x3's schedule: ESRGAN's)
    assert {k: dict(v) if isinstance(v, Counter) else v for k, v in got.items()
            if v and (isinstance(v, int) or k in want)} == want

    routed, run = Counter(), fc._run

    def counting(entry, *args, **kwargs):
        routed['conv_lk' if entry is fc.fused_conv_lk else 'conv3x3'] += 1
        return run(entry, *args, **kwargs)

    monkeypatch.setattr(fc, '_run', counting)
    with torch.no_grad():
        cpu(x)
    assert dict(routed) == {k: want[k] for k in ('conv3x3', 'conv_lk') if k in want}


# BENCHMARK.json's configurations at their published widths, with their launches a forward by counter and route:
# DRCT-L's twelve groups each take three window attentions to the wgmma kernel (heads of 30, 53 and 46 channels)
# and two to the "any" kernels (heads of 122 and 77); HAT-L's twelve groups six block attentions each to the wgmma
# kernel (every other one masked) and their OCAB to the cross kernel, none to the plain path
_CELLS = {
    'esrgan_x4': _SERVED['esrgan'][::2],
    'swinir_m_x4': _SERVED['swinir'][::2],
    'drct_l_x4': (lambda: make_drct(180, 12, 6, 16, 32, 2.0, 4, img_size=64, seed=0),
                  {'window_mha': 60, 'wattn_kernel': {'wattn_wgmma_kernel': 36, 'wattn_h16_any_kernel': 24}}),
    'hat_l_x4': (lambda: make_hat(180, (6,) * 12, (6,) * 12, 16, 0.5, 3, 30, 2.0, 4, 64, seed=0),
                 {'window_mha': 72, 'window_cross_mha': 12, 'wattn_kernel': {'wattn_wgmma_kernel': 72},
                  'wattn_masked': {True: 36, False: 36}}),
}


@pytest.mark.parametrize('config', sorted(_CELLS))
def test_cell_forward_launches(cuda, config):
    """A 1280 x 720 frame through ``upscale_tiled`` in bf16 at the loader's
    tile, halo and batch, as the frames720 cells serve it: every tile-batch
    forward of the host loop launches what one forward of
    test_served_forward_launches does, by counter and route, so no route
    changes with the cells' shapes; the graph path's first call (warm-up
    and capture) counts the host loop's launches twice."""
    from resselt_tpu_torch.parallel import tiling as tt

    make, want = _CELLS[config]
    model = resselt_tpu_torch.load_from_state_dict(make(), device='cuda')
    frame = torch.randint(0, 256, (720, 1280, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    tile, halo, _ = tt._resolve_window(model, None, None, torch.bfloat16, None, 1)
    grid, batch = tt._plan_tiled(model, 720, 1280, tile, halo, None, torch.bfloat16)
    forwards = -(-len(grid.ys) * len(grid.xs) // batch)

    def counted(on_device):
        before = _launch_counts()
        with torch.no_grad():
            y = upscale_tiled(model, frame.cuda(), dtype=torch.bfloat16, on_device=on_device)
        torch.cuda.synchronize()
        assert y.shape == (2880, 5120, 3) and bool(torch.isfinite(y).all())
        return {k: dict(v - before[k]) if isinstance(v, Counter) else v - before[k]
                for k, v in _launch_counts().items() if v != before[k] and (isinstance(v, int) or k in want)}

    def times(counts, n):
        return {k: {r: n * c for r, c in v.items()} if isinstance(v, dict) else n * v for k, v in counts.items()}

    assert counted(False) == times(want, forwards), (tile, halo, batch, forwards)
    assert counted(None) == times(want, 2 * forwards)


_INT8 = {
    'esrgan': lambda: make_esrgan(64, _ESRGAN_BLOCKS, 4, seed=0),
    'compact': lambda: make_compact(seed=0),
    'span': lambda: make_span(seed=0),
    'cugan': lambda: make_cugan('2x', seed=0),  # its transposed convs stay float
}


@pytest.mark.parametrize('family', sorted(_INT8))
def test_int8_convs_on_card_match_cpu(cuda, monkeypatch, family):
    """An int8 model (``quantize_int8``) on a 64 x 64 image: every int8 conv
    of the card's forward, run again on the CPU on the same input, weights
    and scales, within 1e-4 x max|y| (the same codes, an exact int32 sum).
    The whole forwards agree only to the int8 model's own sensitivity (the
    dynamic activation quant turns a last-bit difference upstream of an
    int8 conv into a flipped code): card against CPU, and int8 against
    float on each device, above 35 dB."""
    from resselt_tpu_torch import metrics
    from resselt_tpu_torch.nn import functional as F

    sd = _INT8[family]()
    model = resselt_tpu_torch.load_from_state_dict(sd, device='cuda')
    cpu = resselt_tpu_torch.load_from_state_dict(sd, device='cpu')
    x = np.random.default_rng(5).random((1, 64, 64, 3), dtype=np.float32)
    calls, real = [], F.conv2d_int8

    def recording(x_, w8, scale, b=None, **kw):
        y = real(x_, w8, scale, b, **kw)
        calls.append((x_.cpu(), w8.cpu(), scale.cpu(), None if b is None else b.cpu(), kw, y.cpu()))
        return y

    monkeypatch.setattr(F, 'conv2d_int8', recording)
    y_card = model.quantize_int8()(x).cpu()
    monkeypatch.setattr(F, 'conv2d_int8', real)
    assert calls
    for x_, w8, scale, b, kw, y in calls:
        want = real(x_, w8, scale, b, **kw)
        assert float((y - want).abs().max()) <= 1e-4 * float(want.abs().max())
    y_cpu = cpu.quantize_int8()(x)
    assert metrics.psnr(y_card, y_cpu) > 35.0
    assert metrics.psnr(y_card, model(x).cpu()) > 35.0
    assert metrics.psnr(y_cpu, cpu(x)) > 35.0


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


@pytest.mark.parametrize('variant,kernel,plain', [('flexnet', 5, 0), ('flexnet_meta', 7, 0)])
def test_flexnet_attention_launches_window_attn(cuda, variant, kernel, plain):
    """FlexNet's attentions launch ``csrc/window_attn.cu`` at every width,
    the meta U-Net's 128-wide level too (head_dim = C = 128, which took the
    plain path before): none takes the plain path."""
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


# -- gradients through the kernels -----------------------------------------------------------


def _card_grads(fn, inputs, seed=0):
    with torch.enable_grad():
        out = fn(*inputs)
        g = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(seed), device=out.device)
        need = [t for t in inputs if isinstance(t, torch.Tensor) and t.requires_grad]
        return torch.autograd.grad((out.float() * g).sum(), need)


def _grads_close(got, want, tol):
    """Each gradient within ``tol`` x max|plain gradient|."""
    for a, b in zip(got, want):
        assert a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.abs().max()) + 1e-6, err


def _leaf_on(device, *shape, seed=0, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device=device)).requires_grad_(True)


@pytest.mark.parametrize('act', ['linear', 'lrelu', 'silu', 'mish'])
@pytest.mark.parametrize('n,h,w,cin,cout', [(2, 24, 20, 64, 192), (2, 24, 20, 32, 160), (1, 17, 23, 3, 64),
                                            (2, 16, 16, 64, 3), (1, 9, 31, 48, 48)])
def test_conv3x3_gradients_on_card(cuda, act, n, h, w, cin, cout):
    """dx on the kernel (taps turned and transposed), dW by conv2d_weight,
    db: against autograd through the plain version on the card, f32."""
    x = _leaf_on(cuda, n, h, w, cin, seed=1)
    wt = _leaf_on(cuda, cout, cin, 3, 3, seed=2, scale=1 / (3 * cin ** 0.5))
    b = _leaf_on(cuda, cout, seed=3, scale=0.1)
    e = fc.fused_conv3x3_act
    before, dx_before = e.backward_launches, e.backward_by_shape[(n, h, w, cout, cin, 'linear')]
    got = _card_grads(lambda x, wt, b: e(x, wt, b, act), (x, wt, b))
    want = _card_grads(lambda x, wt, b: fc.fused_conv3x3_act_ref(x, wt, b, act), (x, wt, b))
    _grads_close(got, want, 1e-4)
    recompute = act in ('silu', 'mish')  # one linear launch at the forward's shape
    assert e.backward_launches == before + 1 + recompute
    assert e.backward_by_shape[(n, h, w, cout, cin, 'linear')] == dx_before + 1 + (recompute and cin == cout)


def test_conv3x3_backward_counts_apart_and_falls_back_by_shape(cuda, monkeypatch):
    """A backward counts its launches apart from the forward's (silu: the
    recompute and dx); a shape outside the gate goes to conv2d_input,
    counted per shape."""
    x = _leaf_on(cuda, 2, 16, 16, 32, seed=4)
    wt = _leaf_on(cuda, 64, 32, 3, 3, seed=5, scale=0.05)
    e = fc.fused_conv3x3_act
    fwd, bwd = e.launches, e.backward_launches
    _card_grads(lambda x, wt: e(x, wt, None, 'silu'), (x, wt))
    assert (e.launches - fwd, e.backward_launches - bwd) == (1, 2)
    monkeypatch.setattr(fc, 'conv3x3_kernel_takes', lambda *shape: False)
    fwd, bwd = e.launches, e.backward_launches
    got = _card_grads(lambda x, wt: e(x, wt, None, 'silu'), (x, wt))
    assert (e.launches - fwd, e.backward_launches - bwd) == (1, 1)
    assert e.backward_conv2d_input[(2, 16, 16, 64, 32, 'linear')] >= 1
    _grads_close(got, _card_grads(lambda x, wt: fc.fused_conv3x3_act_ref(x, wt, None, 'silu'), (x, wt)), 1e-4)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_conv3x3_gradients_16_bit(cuda, dtype):
    x = _leaf_on(cuda, 2, 20, 24, 64, seed=6)
    wt = _leaf_on(cuda, 96, 64, 3, 3, seed=7, scale=0.04)

    def run(fn):
        return lambda x, wt: fn(x.to(dtype), fc.pack_conv3x3_weight(wt, dtype), None, 'lrelu')

    _grads_close(_card_grads(run(fc.fused_conv3x3_act), (x, wt)),
                 _card_grads(run(fc.fused_conv3x3_act_ref), (x, wt)), 3e-2)


def test_conv_lk_gradients_on_card(cuda):
    """PLKSR's 16-of-64 slice through a pixel pitch, k 17: dx on the lk
    kernel (16 -> 16 transposed), only into the slice."""
    feat = _leaf_on(cuda, 2, 40, 36, 64, seed=8)
    wt = _leaf_on(cuda, 16, 16, 17, 17, seed=9, scale=0.01)
    b = _leaf_on(cuda, 16, seed=10, scale=0.1)
    before = fc.fused_conv_lk.backward_launches
    got = _card_grads(lambda f, wt, b: fc.fused_conv_lk(f[..., :16], wt, b, k=17), (feat, wt, b))
    want = _card_grads(lambda f, wt, b: fc.fused_conv_lk_ref(f[..., :16], wt, b, k=17), (feat, wt, b))
    _grads_close(got, want, 1e-4)
    assert fc.fused_conv_lk.backward_launches == before + 1 and float(got[0][..., 16:].abs().max()) == 0.0


@pytest.mark.parametrize('windows,n,c,heads,nw', [(128, 64, 180, 6, 64), (32, 256, 48, 4, 16), (16, 64, 64, 1, 0),
                                                   (32, 256, 244, 2, 16), (8, 320, 96, 1, 0)])
def test_window_mha_gradients_on_card(cuda, windows, n, c, heads, nw):
    qkv = _leaf_on(cuda, windows, n, 3 * c, seed=11)
    bias = _leaf_on(cuda, heads, n, n, seed=12)
    mask = None
    if nw:
        mask = torch.where(torch.rand((nw, n, n), generator=torch.Generator(device=cuda).manual_seed(13),
                                      device=cuda) > 0.7, -100.0, 0.0)

    def run(fn):
        return lambda qkv, bias: fn(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias, mask,
                                    num_heads=heads, scale=(c // heads) ** -0.5)

    _grads_close(_card_grads(run(wa.window_mha), (qkv, bias)), _card_grads(run(wa.window_mha_ref), (qkv, bias)),
                 1e-4)


def test_row_gather_gradients_on_card(cuda):
    src = _leaf_on(cuda, 4096, 72, seed=14)
    idx = torch.cat([torch.randperm(4096, generator=torch.Generator().manual_seed(0)), torch.tensor([5, 5, 4095])])
    idx = idx.to(cuda)
    got = _card_grads(row_gather, (src, idx))
    _grads_close(got, _card_grads(row_gather_ref, (src, idx)), 1e-6)


def test_molrcm_gradients_on_card(cuda):
    x = _leaf_on(cuda, 2, 33, 40, 64, seed=15)
    packed = _leaf_on(cuda, mo.packed_size(64), seed=16, scale=0.1)
    _grads_close(_card_grads(mo.fused_molrcm, (x, packed)), _card_grads(mo.fused_molrcm_ref, (x, packed)), 1.5e-3)


@pytest.mark.parametrize('variant', ['compact', 'esrgan', 'plksr', 'swinir', 'eimn', 'atd'])
def test_train_step_on_card_matches_cpu(cuda, variant):
    """One train step of a small model on the card against the CPU: the
    loss, and every param after the step within 2 lr."""
    from resselt_tpu_torch import train as tt

    sd, hw = {
        'compact': (lambda: make_compact(16, 2, 2), (16, 20)),
        'esrgan': (lambda: make_esrgan(16, 1, 2, gc=8), (16, 20)),
        'plksr': (lambda: make_plksr(32, 2, 2, kernel_size=9), (16, 20)),
        'swinir': (lambda: make_swinir(24, (2,), (3,), 8, upscale=2, img_size=32), (24, 24)),
        'eimn': (lambda: make_eimn(64, 1, 1, 2.66, 2), (16, 20)),
        'atd': (lambda: make_atd(24, (2,), (3,), 8, upscale=2), (24, 24)),
    }[variant]
    sd = sd()
    x = np.random.default_rng(0).random((2, *hw, 3), dtype=np.float32)
    outs = []
    for device in ('cpu', 'cuda'):
        m = resselt_tpu_torch.load_from_state_dict(sd, device=device)
        y = m(x)
        hr = torch.from_numpy(np.random.default_rng(1).random(tuple(y.shape), dtype=np.float32)).to(device)
        opt = tt.make_optimizer(lr=1e-3)
        state = tt.init_train_state(m.params, opt)
        step = tt.make_train_step(m.raw_apply_fn, m.config, opt)
        state, metrics = step(state, torch.from_numpy(x).to(device), hr)
        outs.append((float(metrics['loss']), {k: v.cpu() for k, v in state.params.items()}))
    assert outs[1][0] == pytest.approx(outs[0][0], rel=1e-5)
    for k, v in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], v, rtol=0, atol=2e-3)


@pytest.fixture
def nccl_rank(cuda, tmp_path):
    """A one-rank NCCL process group (a file:// store in ``tmp_path``),
    destroyed after the test."""
    import torch.distributed as dist

    from resselt_tpu_torch.parallel import init_distributed

    init_distributed('cuda', init_method=f'file://{tmp_path / "rendezvous"}', rank=0, world_size=1)
    assert dist.get_backend() == 'nccl'
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize('m', [1, 2])
def test_pipelined_esrgan_on_a_one_rank_nccl_mesh(cuda, nccl_rank, m):
    """``esrgan.apply_pipelined`` over a one-rank NCCL 'pp' mesh: the head
    and tail convs launch conv3x3.cu once a forward (5 at 2x: the first conv,
    the trunk conv, one upconv, HRconv, the last conv), the trunk's producer
    convs (15 an RRDB) once a microbatch; the output is ``model(x)``'s,
    exactly for one microbatch, within the f32 tolerance for two."""
    from torch.distributed.device_mesh import init_device_mesh

    from resselt_tpu_torch.archs.esrgan import apply_pipelined

    model = resselt_tpu_torch.load_from_state_dict(make_esrgan(16, 3, 2, gc=8, seed=3), device='cuda')
    x = torch.rand((4, 24, 20, 3), generator=torch.Generator().manual_seed(0)).to(cuda)
    want = model(x)
    mesh = init_device_mesh('cuda', (1,), mesh_dim_names=('pp',))
    before = fc.fused_conv3x3_act.launches
    with torch.no_grad():
        got = apply_pipelined(model.config, model.params, x, mesh, axis='pp', num_microbatches=m)
    torch.cuda.synchronize()
    launches = fc.fused_conv3x3_act.launches - before
    assert launches == 5 + 15 * 3 * m
    if m == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('m', [1, 2])
def test_pipelined_esrgan_gradients_on_a_one_rank_nccl_mesh(cuda, nccl_rank, monkeypatch, m):
    """The charbonnier loss's gradient in every raw param and in ``x``
    through ``esrgan.apply_pipelined`` on a one-rank 'pp' mesh against
    ``SRModel.apply``'s, f32, cuDNN deterministic: within 1e-4 x
    max|gradient|.  conv3x3.cu launches 5 + 15 x 3 m convs each way (``x``
    requires a gradient, so the head conv's ``dx`` runs too)."""
    from torch.distributed.device_mesh import init_device_mesh

    from resselt_tpu_torch.archs.esrgan import apply_pipelined
    from resselt_tpu_torch.train import charbonnier_loss, split_trainable

    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    model = resselt_tpu_torch.load_from_state_dict(make_esrgan(16, 3, 2, gc=8, seed=3), device='cuda')
    mesh = init_device_mesh('cuda', (1,), mesh_dim_names=('pp',))
    gen = torch.Generator().manual_seed(4)
    lr, hr = torch.rand((4, 24, 20, 3), generator=gen).to(cuda), torch.rand((4, 48, 40, 3), generator=gen).to(cuda)
    trainable, static = split_trainable(model.params)
    act = fc.fused_conv3x3_act

    def launches():
        torch.cuda.synchronize()
        return act.launches, act.backward_launches + sum(act.backward_conv2d_input.values())

    def grads(forward):
        leaves = {k: v.detach().requires_grad_() for k, v in trainable.items()}
        x = lr.clone().requires_grad_()
        before = launches()
        loss = charbonnier_loss(forward({**leaves, **static}, x), hr)
        out = dict(zip(['x', *leaves], torch.autograd.grad(loss, [x, *leaves.values()])))
        return out, tuple(n - b for n, b in zip(launches(), before))

    want, counts = grads(model.apply)
    assert counts == (5 + 15 * 3, 5 + 15 * 3)
    got, counts = grads(lambda p, x: apply_pipelined(model.config, p, x, mesh, axis='pp', num_microbatches=m))
    assert counts == (5 + 15 * 3 * m, 5 + 15 * 3 * m)
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-4 * scale)


def test_upscale_tiled_on_a_one_rank_nccl_mesh(cuda, nccl_rank):
    """``upscale_tiled(mesh=)`` on a one-rank (dp, tp) NCCL mesh, bf16: the
    host loop and the graph path (the rank's forward captured, the
    all_gather and the stitch after the replay) each give the meshless
    run's output bit for bit, and the mesh graph's kernel nodes are the mesh
    host loop's launches."""
    from test_torch_tiling_graph import graph_kernel_counts

    from resselt_tpu_torch.parallel import make_mesh

    model = resselt_tpu_torch.load_from_state_dict(make_esrgan(16, 3, 2, gc=8, seed=21), device='cuda')
    img = np.random.default_rng(2).random((72, 90, 3), dtype=np.float32)
    mesh = make_mesh(device='cuda')

    def run(on_device, with_mesh):
        return upscale_tiled(model, img, tile=16, dtype=torch.bfloat16, on_device=on_device,
                             mesh=mesh if with_mesh else None)

    before = fc.fused_conv3x3_act.launches
    host = run(False, True)
    torch.cuda.synchronize()
    per_image = fc.fused_conv3x3_act.launches - before
    assert per_image > 0 and torch.equal(host, run(False, False))
    solo = run(None, False)
    for _ in range(2):
        assert torch.equal(run(None, True), solo)
    program = next(p for p in model.__dict__['_tiled_fn_cache'].values() if p.mesh is mesh)
    assert program.graph is not None and program.replays == 2
    assert graph_kernel_counts(program.graph) == {'conv3x3': per_image}


def test_train_step_on_a_one_rank_nccl_mesh(cuda, nccl_rank, monkeypatch):
    """``make_train_step(mesh=)`` with a one-rank 'dp' mesh (the batch
    slice, the gradients' all_reduce): three steps of ESRGAN with remat and
    an EMA give the meshless steps' params bit for bit.  cuDNN runs its
    deterministic algorithms: its default weight-gradient ones may add in
    another order from run to run."""
    from resselt_tpu_torch import train as tt
    from resselt_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    model = resselt_tpu_torch.load_from_state_dict(make_esrgan(16, 2, 2, gc=8, seed=3), device='cuda')
    gen = torch.Generator().manual_seed(0)
    batches = [(torch.rand((4, 24, 24, 3), generator=gen).to(cuda), torch.rand((4, 48, 48, 3), generator=gen).to(cuda))
               for _ in range(3)]
    params = []
    for mesh in (None, make_mesh(device='cuda')):
        opt = tt.make_optimizer(1e-4)
        state = tt.init_train_state(model.params, opt, ema=True)
        step = tt.make_train_step(model.raw_apply_fn, model.config, opt, 'charbonnier', 0.999, True, mesh=mesh)
        for lr, hr in batches:
            state, _ = step(state, lr, hr)
        params.append(state.params)
    assert all(torch.equal(params[1][k], v) for k, v in params[0].items())


@pytest.mark.parametrize('placement', ['whole', 'sharded'])
def test_moe_apply_ep_on_a_one_rank_nccl_mesh(cuda, nccl_rank, placement):
    """``moe_apply_ep`` on a one-rank 'ep' mesh against ``moe_apply_dense``,
    f32, the params from ``init_moe_params`` on its default device, whole or
    placed by ``shard_moe_params``: the output and the gradients of
    ``sum(y ** 2)`` in ``x`` and every param within 1e-4 x their max."""
    from torch.distributed.device_mesh import init_device_mesh

    from resselt_tpu_torch.parallel import init_moe_params, moe_apply_dense, moe_apply_ep, shard_moe_params
    from resselt_tpu_torch.parallel.mesh import local_tensor

    mesh = init_device_mesh('cuda', (1,), mesh_dim_names=('ep',))
    params = init_moe_params(torch.Generator().manual_seed(0), 64, 256, 8)
    assert params['w1'].device.type == 'cuda'
    x = torch.randn((4096, 64), generator=torch.Generator().manual_seed(1)).to(cuda)

    def run(fn, p):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        y = fn(leaves, xx)
        grads = torch.autograd.grad((y ** 2).sum(), [xx, *leaves.values()])
        return y.detach(), [grads[0], *(local_tensor(g) for g in grads[1:])]

    y_ref, g_ref = run(moe_apply_dense, params)
    placed = params if placement == 'whole' else shard_moe_params(params, mesh, 'ep')
    y, g = run(lambda p, xx: moe_apply_ep(p, xx, mesh, 'ep'), placed)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-4 * float(y_ref.abs().max()))
    scale = max(float(t.abs().max()) for t in g_ref)
    for got, want in zip(g, g_ref):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
