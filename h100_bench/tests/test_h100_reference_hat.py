"""HAT's reference against the program's CPU path at small widths (embed
60, three heads of 20, window 8, overlap 12, two groups of two blocks,
compress 3, squeeze 30), whole and tiled; its configuration's stored FLOPs
per pixel against flop_counter at the published widths; the control
failing the cell's limit at the published widths; and one traced run of
the cell on a card."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import resselt_tpu_torch as rt
from conftest import ROOT
from h100_bench import harness
from h100_bench.reference import hat_l_x4, tiling
from h100_bench.weights import make_state_dict
from resselt_tpu_torch.zoo import _rpi_oca

SMALL = dict(upscale=4, in_chans=3, img_size=64, window_size=8, compress_ratio=3, squeeze_factor=30, conv_scale=0.01,
             overlap_ratio=0.5, img_range=1.0, depths=[2, 2], embed_dim=60, num_heads=[3, 3], mlp_ratio=2,
             upsampler='pixelshuffle', resi_connection='1conv')
TOL = 1e-5  # test_h100_reference.py's: f32 on both sides, only the order of the sums differs


def _params(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def test_small_layout_loads_as_hat():
    model = rt.load_from_state_dict(make_state_dict(hat_l_x4, SMALL, 5, 'cpu'), device='cpu')
    cfg = model.config
    assert model.arch_id == 'HAT'
    assert (cfg.embed_dim, cfg.depths, cfg.num_heads, cfg.window_size, cfg.overlap_win_size) == (
        60, (2, 2), (3, 3), 8, 12)
    assert (cfg.compress_ratio, cfg.squeeze_factor, cfg.resi_connection, cfg.num_feat) == (3, 30, '1conv', 64)


def test_published_layout_has_the_published_size():
    cfg = json.load(open(os.path.join(ROOT, 'h100_bench', 'configs', 'hat_l_x4.json')))
    spec = hat_l_x4.state_dict_spec(cfg)
    assert sum(int(np.prod(shape)) for _, shape, _, _ in spec) == 40_846_575
    buffers = hat_l_x4.fixed_buffers(cfg)
    oca = buffers['relative_position_index_OCA']
    assert oca.shape == (256, 576)
    # the published shift leaves negative entries, which indexing wraps into the (39 * 39)-row table: the port's
    # zoo builds the same buffer
    assert np.array_equal(oca, _rpi_oca(16, 24)) and -39 * 39 <= int(oca.min()) < 0 < int(oca.max()) < 39 * 39


@pytest.mark.parametrize('hw', [(20, 28), (16, 16)])
def test_reference_matches_program_cpu(hw):
    sd = make_state_dict(hat_l_x4, SMALL, 2**33 + 3, 'cpu')
    model = rt.load_from_state_dict(sd, device='cpu')  # detection and config inference on the published keys
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = model(img).numpy()
    with torch.no_grad():
        want = hat_l_x4.forward(SMALL, _params(sd), torch.from_numpy(img).permute(2, 0, 1).float()[None] / 255)
    np.testing.assert_allclose(got, want[0].permute(1, 2, 0).numpy(), rtol=0, atol=TOL)


def test_reference_tiling_matches_program_tiling():
    from resselt_tpu_torch import upscale_tiled

    sd = make_state_dict(hat_l_x4, SMALL, 11, 'cpu')
    model = rt.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).integers(0, 256, (40, 75, 3), dtype=np.uint8)
    tile, halo = 16, 8  # windows of 32: a 2 x 4 grid whose last row and column are flush with the borders
    got = upscale_tiled(model, img, tile=tile, halo=halo).numpy()
    p = _params(sd)
    with torch.no_grad():
        want = tiling.upscale(lambda t: hat_l_x4.forward(SMALL, p, t),
                              torch.from_numpy(img).permute(2, 0, 1).float() / 255, 4, tile, halo, batch=2)
    np.testing.assert_allclose(got, want.permute(1, 2, 0).numpy(), rtol=0, atol=TOL)


def test_stored_flops_per_pixel():
    cfg = json.load(open(os.path.join(ROOT, 'h100_bench', 'configs', 'hat_l_x4.json')))
    sd = make_state_dict(hat_l_x4, cfg, 0, 'cpu')
    x = torch.zeros(1, 3, 16, 16)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        hat_l_x4.forward(cfg, _params(sd), x)
    assert counter.get_total_flops() / (16 * 16) == cfg['flops_per_lr_px']


def test_control_is_not_correct():
    """The control at the published widths on a small frame (one window):
    the program's int8 path fails the cell's limit, which its bf16 path
    keeps."""
    mix = {'sizes': {'kind': 'fixed', 'height': 40, 'width': 48}, 'distinct': 1, 'path': 'tiled', 'check_share': 1.0}
    results = []
    for control in (None, 'program_int8'):
        cell = harness.load_cell('hat_l_x4.frames720')
        cell.mix = mix
        result, _ = harness.run(cell.name, 2**32 + 19, 0.1, False, time.perf_counter(), device='cpu', cell=cell,
                                control=control)
        results.append(result)
    assert results[0]['correct'] and not results[1]['correct']


@pytest.mark.cuda
def test_cell_on_card_reads_the_cross_kernel():
    """One traced run of the cell on a card: correct, the launch counts agree
    with the trace, both attention rooflines read within 100%, and the tiler
    delivers 65.60% of the pixels it computes (28 windows of 224^2)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run([sys.executable, 'h100_bench/run.py', '--workload', 'hat_l_x4.frames720', '--seed', '4246',
                           '--seconds', '6', '--trace', '1'], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'DISAGREE' not in proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    metrics = {name: m['value'] for name, m in result['metrics'].items()}
    assert result['correct'] and 0 < metrics['window_cross_attn_roofline'] <= 100
    assert 0 < metrics['window_attn_roofline.hat_frames'] <= 100
    assert round(metrics['tile_useful_pct.hat_frames'], 2) == 65.60
