"""The port's CUDA kernels and main path on the card.  Needs an NVIDIA GPU
and nvcc; every test here is marked ``cuda`` and skips without a card.

This file imports torch and resselt_tpu_torch only, so that it runs where
JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

f32 is held to 1e-4 against the plain version with TF32 off (exact f32
FMA); bf16 to 2e-2 relative against the plain version in f32 from the same
bf16 inputs (the output's bf16 rounding).
"""

import numpy as np
import pytest
import torch

import resselt_tpu_torch
from resselt_tpu_torch.ops import fused_conv as fc
from resselt_tpu_torch.parallel import upscale_tiled
from resselt_tpu_torch.zoo import make_esrgan


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    return torch.device('cuda')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', ['linear', 'lrelu', 'silu', 'mish'])
@pytest.mark.parametrize('n,h,w,cin,cout', [(2, 37, 29, 64, 192), (1, 16, 16, 3, 64), (3, 20, 70, 32, 160),
                                            (1, 33, 17, 64, 3), (2, 9, 40, 12, 64), (1, 5, 5, 48, 96),
                                            (1, 1, 1, 64, 64), (1, 7, 3, 256, 320)])
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
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
        fc.fused_conv3x3_act(torch.zeros((1, 4, 4, 8), device=cuda, dtype=torch.float16), taps.half())
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
