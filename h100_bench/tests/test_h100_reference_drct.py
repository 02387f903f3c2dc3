"""DRCT's reference against the program's CPU path at small widths (embed
24, gc 8, three heads: the blocks' widths 24, 32, 40, 48 and 56 take 3, 1,
2, 3 and 1 heads, head_dims 8, 32, 20, 16 and 56), its configuration's
stored FLOPs per pixel against flop_counter at the published widths, the
control failing the cell's limit at the published widths, and one traced
run of the cell on a card."""

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
from h100_bench.reference import drct_l_x4, tiling
from h100_bench.weights import make_state_dict

SMALL = dict(upscale=4, in_chans=3, img_size=64, window_size=8, img_range=1.0, depths=[6, 6], embed_dim=24,
             num_heads=[3, 3], gc=8, mlp_ratio=2, upsampler='pixelshuffle', resi_connection='1conv')
TOL = 1e-5  # test_h100_reference.py's: f32 on both sides, only the order of the sums differs


def _params(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def test_small_layout_loads_as_drct():
    model = rt.load_from_state_dict(make_state_dict(drct_l_x4, SMALL, 5, 'cpu'), device='cpu')
    cfg = model.config
    assert (cfg.embed_dim, cfg.num_layers, cfg.num_heads, cfg.window_size, cfg.gc, cfg.img_size) == (
        24, 2, (3, 3), 8, 8, 64)
    w = model.weights(torch.float32)
    assert [w[f'layers.1.swin{k}.attn.relative_position_bias'].shape[0] for k in range(1, 6)] == [3, 1, 2, 3, 1]


@pytest.mark.parametrize('hw', [(20, 28), (16, 16)])
def test_reference_matches_program_cpu(hw):
    sd = make_state_dict(drct_l_x4, SMALL, 2**33 + 1, 'cpu')
    model = rt.load_from_state_dict(sd, device='cpu')  # detection and config inference on the published keys
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = model(img).numpy()
    with torch.no_grad():
        want = drct_l_x4.forward(SMALL, _params(sd), torch.from_numpy(img).permute(2, 0, 1).float()[None] / 255)
    np.testing.assert_allclose(got, want[0].permute(1, 2, 0).numpy(), rtol=0, atol=TOL)


def test_reference_tiling_matches_program_tiling():
    from resselt_tpu_torch import upscale_tiled

    sd = make_state_dict(drct_l_x4, SMALL, 9, 'cpu')
    model = rt.load_from_state_dict(sd, device='cpu')
    img = np.random.default_rng(1).integers(0, 256, (40, 75, 3), dtype=np.uint8)
    tile, halo = 16, 8  # windows of 32: a 2 x 4 grid whose last row and column are flush with the borders
    got = upscale_tiled(model, img, tile=tile, halo=halo).numpy()
    p = _params(sd)
    with torch.no_grad():
        want = tiling.upscale(lambda t: drct_l_x4.forward(SMALL, p, t),
                              torch.from_numpy(img).permute(2, 0, 1).float() / 255, 4, tile, halo, batch=3)
    np.testing.assert_allclose(got, want.permute(1, 2, 0).numpy(), rtol=0, atol=TOL)


def test_stored_flops_per_pixel():
    cfg = json.load(open(os.path.join(ROOT, 'h100_bench', 'configs', 'drct_l_x4.json')))
    sd = make_state_dict(drct_l_x4, cfg, 0, 'cpu')
    x = torch.zeros(1, 3, 16, 16)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        drct_l_x4.forward(cfg, _params(sd), x)
    assert counter.get_total_flops() / (16 * 16) == cfg['flops_per_lr_px']


def test_control_is_not_correct():
    """The control at the published widths on a small frame (one window):
    the program's int8 path fails the cell's limit, which its bf16 path
    keeps."""
    mix = {'sizes': {'kind': 'fixed', 'height': 40, 'width': 48}, 'distinct': 1, 'path': 'tiled', 'check_share': 1.0}
    results = []
    for control in (None, 'program_int8'):
        cell = harness.load_cell('drct_l_x4.frames720')
        cell.mix = mix
        result, _ = harness.run(cell.name, 2**32 + 17, 0.1, False, time.perf_counter(), device='cpu', cell=cell,
                                control=control)
        results.append(result)
    assert results[0]['correct'] and not results[1]['correct']


@pytest.mark.cuda
def test_cell_on_card_reads_the_any_kernels():
    """One traced run of the cell on a card: correct, the launch counts agree
    with the trace, both window-attention rooflines read within 100%, and the
    tiler delivers 74.07% of the pixels it computes (60 windows of 144²)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run([sys.executable, 'h100_bench/run.py', '--workload', 'drct_l_x4.frames720', '--seed', '4244',
                           '--seconds', '4', '--trace', '1'], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'DISAGREE' not in proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    metrics = {name: m['value'] for name, m in result['metrics'].items()}
    assert result['correct'] and 0 < metrics['window_attn_any_roofline'] <= 100
    assert 0 < metrics['window_attn_roofline.drct_frames'] <= 100
    assert round(metrics['tile_useful_pct.drct_frames'], 2) == 74.07
