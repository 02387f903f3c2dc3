"""The references against the program's CPU path at small widths, and the
configurations' stored FLOPs per pixel against flop_counter over them."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import resselt_tpu_torch as rt
from conftest import ROOT
from h100_bench.reference import esrgan_x4, swinir_m_x4, tiling
from h100_bench.weights import make_state_dict

SMALL = {
    'esrgan_x4': (esrgan_x4, dict(num_in_ch=3, num_out_ch=3, num_feat=16, num_block=2, num_grow_ch=8, scale=4)),
    'swinir_m_x4': (swinir_m_x4, dict(upscale=4, in_chans=3, img_size=64, window_size=8, img_range=1.0, depths=[2, 2],
                                      embed_dim=24, num_heads=[2, 3], mlp_ratio=2, upsampler='pixelshuffle',
                                      resi_connection='1conv')),
}


def _params(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize('name', sorted(SMALL))
@pytest.mark.parametrize('hw', [(20, 28), (16, 16)])
def test_reference_matches_program_cpu(name, hw):
    ref, cfg = SMALL[name]
    sd = make_state_dict(ref, cfg, 2**33 + 1, 'cpu')
    model = rt.load_from_state_dict(sd, device='cpu')  # detection and config inference on the published keys
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = model(img).numpy()
    with torch.no_grad():
        want = ref.forward(cfg, _params(sd), torch.from_numpy(img).permute(2, 0, 1).float()[None] / 255)
    np.testing.assert_allclose(got, want[0].permute(1, 2, 0).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize('name', sorted(SMALL))
def test_reference_tiling_matches_program_tiling(name):
    from resselt_tpu_torch import upscale_tiled

    ref, cfg = SMALL[name]
    sd = make_state_dict(ref, cfg, 9, 'cpu')
    model = rt.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).integers(0, 256, (40, 75, 3), dtype=np.uint8)
    tile, halo = 16, 8  # windows of 32: a 2 x 4 grid whose last row and column are flush with the borders
    got = upscale_tiled(model, img, tile=tile, halo=halo).numpy()
    p = _params(sd)
    with torch.no_grad():
        want = tiling.upscale(lambda t: ref.forward(cfg, p, t), torch.from_numpy(img).permute(2, 0, 1).float() / 255,
                              4, tile, halo, batch=3)
    np.testing.assert_allclose(got, want.permute(1, 2, 0).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize('hw, tile, halo, want', [
    ((720, 1280), 256, 4, ([0, 256, 456], [0, 256, 512, 768, 1016], (264, 264), (4, 4))),
    ((720, 1280), 160, 8, ([0, 160, 320, 480, 544], [0, 160, 320, 480, 640, 800, 960, 1104], (176, 176), (8, 8))),
    ((264, 264), 256, 4, None),
    ((100, 400), 256, 4, ([0], [0, 136], (100, 264), (4, 4))),
])
def test_grid(hw, tile, halo, want):
    assert tiling.plan(*hw, tile, halo) == want


@pytest.mark.parametrize('name', ['esrgan_x4', 'swinir_m_x4'])
def test_stored_flops_per_pixel(name):
    cfg = json.load(open(os.path.join(ROOT, 'h100_bench', 'configs', f'{name}.json')))
    ref = {'esrgan_x4': esrgan_x4, 'swinir_m_x4': swinir_m_x4}[name]
    sd = make_state_dict(ref, cfg, 0, 'cpu')
    x = torch.zeros(1, 3, 16, 16)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.forward(cfg, _params(sd), x)
    assert counter.get_total_flops() / (16 * 16) == cfg['flops_per_lr_px']
